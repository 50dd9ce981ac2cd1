"""Serving telemetry: latency percentiles, QPS, per-bucket compile counts.

A copy of ``repro.serve.telemetry`` over the port's ``SearchStats``.  The
"compiles" it counts are the sessions' first-use events (``SearchEngine``
in ``repro_torch.core.search``), the port's counterpart of XLA compiles.

One ``ServeTelemetry`` instance rides a frontend for its lifetime.  Engine
counters are folded through ``SearchStats.merge`` so a single
``SearchStats.summary()`` covers the whole request trace (per-query means on
the single-index path, shard-reduced totals on the sharded path), and the
serving-level numbers — p50/p95/p99 request latency, QPS, per-bucket
dispatch latency and compile counts — wrap around it in ``summary()``.

The compile counters are the serving frontend's key invariant: after
``mark_warm()`` (the explicit bucket warmup) ``recompiles_after_warmup``
must stay 0 across any ragged request trace — a nonzero value means a batch
shape escaped the bucket ladder and paid one-time work on the request path
(asserted in tests/test_torch_serve.py and chip_smoke.py).

Windowed snapshots (the autotune feed, DESIGN.md §12): the controller
does not read the lifetime digest — it diffs *epochs*.
``window_snapshot()`` captures the cumulative counters plus a copy of the
bounded sample window at one instant; ``window_delta(prev, cur)`` turns
two snapshots into the epoch between them (requests served, epoch QPS,
and p50/p95/p99 over exactly the epoch's own latency samples — valid
while an epoch serves fewer than ``WINDOW`` requests, asserted there).
The observation hooks and snapshots share one lock, so a controller
thread can snapshot mid-trace without tearing a deque.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from repro_torch.core.spec import SearchStats

# Sliding-window length for the percentile/QPS/engine-stats digests.  The
# cumulative counters (submitted/served/rows/compiles/...) are lifetime
# totals, but the sample lists must stay bounded — a "serve forever" worker
# would otherwise grow one latency float per request and one SearchStats per
# dispatch without limit.
WINDOW = 4096


def _pcts(lat_s) -> Dict[str, Optional[float]]:
    """p50/p95/p99 in milliseconds from an iterable of seconds."""
    lat_s = list(lat_s)
    if not lat_s:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": round(float(np.percentile(ms, 50)), 3),
            "p95_ms": round(float(np.percentile(ms, 95)), 3),
            "p99_ms": round(float(np.percentile(ms, 99)), 3)}


def _window() -> Deque:
    return deque(maxlen=WINDOW)


@dataclasses.dataclass
class BucketStats:
    """Per-rung accounting (bucket size = the padded batch shape)."""

    dispatches: int = 0
    compiles: int = 0            # first-use events on this rung (warmup)
    rows_valid: int = 0          # real query rows served through this rung
    rows_padded: int = 0         # wasted lanes (bucket - valid, summed)
    lat_s: Deque[float] = dataclasses.field(default_factory=_window)

    def summary(self) -> Dict[str, object]:
        pad_total = self.rows_valid + self.rows_padded
        out = {"dispatches": self.dispatches, "compiles": self.compiles,
               "rows": self.rows_valid,
               "pad_overhead": round(self.rows_padded / pad_total, 3)
               if pad_total else 0.0}
        out.update(_pcts(self.lat_s))
        return out


class ServeTelemetry:
    """Latency + throughput + compile accounting for one frontend."""

    def __init__(self):
        self.buckets: Dict[int, BucketStats] = {}
        self.request_lat_s: Deque[float] = _window()  # guarded by: self._obs_lock
        self.queue_wait_s: Deque[float] = _window()   # guarded by: self._obs_lock
        self.submitted = 0
        self.served = 0
        self.rejected = 0           # oversized / backpressure, at submit
        self.expired = 0            # deadline passed before dispatch
        self.failed = 0             # requests resolved with an exception
        self.dispatch_failures = 0  # engine-call failures (whole batches)
        self.worker_errors = 0      # background flush-loop failures
        self.recompiles_after_warmup = 0
        self._warm = False
        self._stats: Deque[SearchStats] = _window()   # guarded by: self._obs_lock
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # completion timestamps (same window as request_lat_s): windowed
        # QPS -- guarded by: self._obs_lock
        self._done_t: Deque[float] = _window()
        # guards the sample deques: the dispatch thread appends while a
        # controller thread snapshots (list(deque) during a concurrent
        # append can raise); counters alone would be fine under the GIL
        self._obs_lock = threading.Lock()

    # --- recording hooks (called by the frontend) -------------------------
    def mark_warm(self):
        """All buckets warmed: any later first use is a ladder escape."""
        self._warm = True

    def observe_dispatch(self, bucket: int, n_valid: int, secs: float,
                         compiled: int, stats: Optional[SearchStats]):
        """``stats=None`` marks a warmup probe: it contributes to the
        compile accounting only, never to latency/throughput/pad numbers
        (a probe's latency IS the first use — folding it into the bucket
        percentiles would misreport the served trace)."""
        bs = self.buckets.setdefault(bucket, BucketStats())
        with self._obs_lock:
            bs.compiles += compiled
            if stats is None:
                return
            # a first use during a REAL dispatch after warmup = a batch
            # shape that escaped the ladder (or an engine set up again) and
            # paid one-time work on the request path
            # (warmup probes — including a late-created session's — never
            # count)
            if compiled and self._warm:
                self.recompiles_after_warmup += compiled
            bs.dispatches += 1
            bs.rows_valid += n_valid
            bs.rows_padded += bucket - n_valid
            bs.lat_s.append(secs)
            self._stats.append(stats)
            now = time.perf_counter()
            if self._t_first is None:
                self._t_first = now - secs
            self._t_last = now

    def observe_request_done(self, total_s: float, wait_s: float,
                             now: Optional[float] = None):
        """``now`` overrides the completion timestamp (``perf_counter``
        seconds) — the windowed-QPS regression tests inject exact times."""
        with self._obs_lock:
            self.served += 1
            self.request_lat_s.append(total_s)
            self.queue_wait_s.append(wait_s)
            self._done_t.append(time.perf_counter() if now is None else now)

    def observe_dispatch_failure(self, n_requests: int):
        """A whole engine call failed: its requests RESOLVED with the
        error on their futures (admission contract), not results."""
        self.dispatch_failures += 1
        self.failed += n_requests

    # --- windowed snapshots (the autotune epoch feed) ---------------------
    def window_snapshot(self) -> Dict[str, object]:
        """One instant's view: cumulative counters + a copy of the bounded
        sample window.  Two snapshots diff into an epoch via
        ``window_delta``; the latency/QPS entries here are *window*-scoped
        (last ``WINDOW`` requests), the counters lifetime-scoped.
        """
        with self._obs_lock:
            lat = tuple(self.request_lat_s)
            wait = tuple(self.queue_wait_s)
            done_t = tuple(self._done_t)
            snap: Dict[str, object] = {
                "t": time.perf_counter(),
                "served": self.served, "submitted": self.submitted,
                "failed": self.failed, "expired": self.expired,
                "rejected": self.rejected,
                "recompiles_after_warmup": self.recompiles_after_warmup,
            }
        snap["latency"] = _pcts(lat)
        snap["queue_wait"] = _pcts(wait)
        snap["window_qps"] = (
            round(len(done_t) / (done_t[-1] - done_t[0]), 1)
            if len(done_t) >= 2 and done_t[-1] > done_t[0] else None)
        snap["_lat_s"] = lat          # raw samples: window_delta's input
        snap["_done_t"] = done_t
        return snap

    @staticmethod
    def window_delta(prev: Dict[str, object],
                     cur: Dict[str, object]) -> Dict[str, object]:
        """The epoch between two snapshots, JSON-ready.

        Percentiles cover exactly the requests served in the epoch (the
        trailing ``served_delta`` window samples) — correct as long as the
        epoch served fewer than ``WINDOW`` requests; past that the oldest
        epoch samples have rolled off and the digest degrades to the
        window, flagged via ``clipped``.
        """
        served = int(cur["served"]) - int(prev["served"])
        dt = float(cur["t"]) - float(prev["t"])
        lat = cur["_lat_s"]
        n = min(served, len(lat))
        out: Dict[str, object] = {
            "dt_s": round(dt, 4), "served": served,
            "failed": int(cur["failed"]) - int(prev["failed"]),
            "expired": int(cur["expired"]) - int(prev["expired"]),
            "rejected": int(cur["rejected"]) - int(prev["rejected"]),
            "recompiles": (int(cur["recompiles_after_warmup"])
                           - int(prev["recompiles_after_warmup"])),
            "qps": round(served / dt, 1) if dt > 0 and served else None,
            "clipped": served > len(lat),
        }
        out.update(_pcts(lat[len(lat) - n:] if n else ()))
        return out

    # --- reporting --------------------------------------------------------
    def merged_stats(self) -> Optional[SearchStats]:
        """Engine stats folded over the sample window (last WINDOW
        dispatches)."""
        with self._obs_lock:
            stats = list(self._stats)
        return SearchStats.merge(stats) if stats else None

    def qps(self) -> Optional[float]:
        """Real rows served per second of serving wall-clock."""
        if self._t_first is None or self._t_last <= self._t_first:
            return None
        rows = sum(b.rows_valid for b in self.buckets.values())
        return rows / (self._t_last - self._t_first)

    def summary(self) -> Dict[str, object]:
        """JSON-ready digest; ``search`` is ``SearchStats.summary()`` over
        the merged trace — the engine counters fold into the same record the
        benchmarks persist."""
        merged = self.merged_stats()
        qps = self.qps()
        with self._obs_lock:
            lat = tuple(self.request_lat_s)
            wait = tuple(self.queue_wait_s)
        out: Dict[str, object] = {
            "requests": {"submitted": self.submitted, "served": self.served,
                         "rejected": self.rejected, "expired": self.expired,
                         "failed": self.failed},
            "dispatch_failures": self.dispatch_failures,
            "worker_errors": self.worker_errors,
            "latency": _pcts(lat),
            "queue_wait": _pcts(wait),
            "qps": round(qps, 1) if qps else None,
            "compiles_total": sum(b.compiles for b in self.buckets.values()),
            "recompiles_after_warmup": self.recompiles_after_warmup,
            "buckets": {str(b): self.buckets[b].summary()
                        for b in sorted(self.buckets)},
        }
        if merged is not None:
            out["search"] = merged.summary()
        return out
