"""Recall proxy: a small held-out probe set with exact ground truth.

The counterpart of ``repro.autotune.proxy``, replaying probes through the
port's sessions.

Serving telemetry measures latency but says nothing about result quality,
and true recall needs ground truth no live system has.  The proxy closes
that gap cheaply: at attach time it draws a small probe query set (user
supplied, or synthesized by perturbing sampled base vectors), computes
exact brute-force ground truth against the corpus ONCE, and thereafter
replays the probes through any candidate ``SearchSpec`` on the
controller's background thread — returning a recall@k *proxy* (exact on
the probes, an estimate of serving recall) plus the probe dispatch
latency that feeds the controller's latency model.

Probe batches are padded to a bucket rung of the serving ladder, so a
probe replay pays (at most) one engine setup and one new batch shape per
candidate — the SAME first uses the frontend's warmup would pay for that
rung, shared through the engine cache.  Promotion to active then warms
only the remaining rungs.  Probe replays never touch frontend telemetry: they
are measurement, not traffic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import distances as D
from repro_torch.core.spec import SearchSpec
from repro_torch.data.vectors import recall_at_k
from repro_torch.fault import failpoints as fault
from repro_torch.serve.backends import make_session
from repro_torch.serve.bucketing import bucket_for, pad_to_bucket


@dataclasses.dataclass
class ProbeMeasurement:
    """One probe replay through one candidate spec."""

    key: str
    recall: float                # exact recall@k on the probe set
    lat_s: float                 # median timed probe-dispatch latency
    dist_calls: float            # mean exact fp32 calls per probe query
    replays: int                 # timed replays folded into lat_s

    def to_dict(self) -> Dict[str, object]:
        return {"key": self.key, "recall": round(self.recall, 4),
                "lat_ms": round(self.lat_s * 1e3, 3),
                "dist_calls": round(self.dist_calls, 1),
                "replays": self.replays}


def _brute_force_topk(queries: np.ndarray, base: np.ndarray, k: int,
                      metric: str, block: int = 64) -> np.ndarray:
    """Exact top-k ids by the engine's own ranking distance (query-blocked
    — same recipe as ``data.vectors.exact_ground_truth``, over an
    arbitrary corpus matrix)."""
    out = np.empty((queries.shape[0], k), np.int64)
    for s in range(0, queries.shape[0], block):
        dist = D.pairwise_np(queries[s:s + block], base, metric)
        idx = np.argpartition(dist, kth=k - 1, axis=1)[:, :k]
        row = np.take_along_axis(dist, idx, axis=1)
        order = np.argsort(row, axis=1, kind="stable")
        out[s:s + block] = np.take_along_axis(idx, order, axis=1)
    return out


class RecallProxy:
    """Held-out probe set + exact ground truth, reusable across specs."""

    def __init__(self, index, queries: np.ndarray, gt: np.ndarray, *,
                 k: int = 10, buckets: Tuple[int, ...] = (32,)):
        self.index = index
        self.queries = np.ascontiguousarray(queries, np.float32)
        self.gt = np.asarray(gt)
        self.k = int(k)
        assert self.gt.shape[0] == self.queries.shape[0] >= 1
        assert self.gt.shape[1] >= self.k, "ground truth narrower than k"
        # pad probes onto a serving-ladder rung so probe first uses are the
        # warmup's first uses (ladder too short for the probe set: top rung
        # replays it in slices)
        self.bucket = (buckets[-1] if self.queries.shape[0] > buckets[-1]
                       else bucket_for(self.queries.shape[0], buckets))
        self._sessions: Dict[SearchSpec, object] = {}
        self.gt_secs = 0.0        # stamped by for_index / attach paths

    # --- construction -----------------------------------------------------
    @classmethod
    def for_index(cls, index, *, n_probe: int = 32, k: int = 10,
                  seed: int = 0, noise: float = 0.05,
                  buckets: Tuple[int, ...] = (32,),
                  queries: Optional[np.ndarray] = None,
                  gt: Optional[np.ndarray] = None) -> "RecallProxy":
        """Build the probe set + exact ground truth once, at attach time.

        With explicit ``queries`` (a held-out slice the operator trusts),
        ground truth is brute-forced against the index's corpus unless
        also supplied.  Without, probes are synthesized: sample base rows,
        add relative Gaussian noise — near-duplicates whose true neighbors
        are nontrivial but cheap to verify.  Requires an index that
        exposes its corpus (``graph.vectors``); pass explicit
        ``queries``+``gt`` for sharded/composed indexes.
        """
        t0 = time.perf_counter()
        base = cls._corpus(index) if gt is None else None
        if queries is None:
            if base is None:
                raise TypeError(
                    f"cannot synthesize probes for {type(index).__name__}; "
                    "pass explicit queries (and gt for corpus-less indexes)")
            rng = np.random.default_rng(seed)
            rows = rng.choice(base.shape[0], size=min(n_probe, base.shape[0]),
                              replace=False)
            q = base[rows]
            scale = noise * float(np.std(q)) if np.std(q) > 0 else noise
            queries = q + rng.normal(0.0, scale, q.shape)
        queries = np.ascontiguousarray(queries, np.float32)
        if gt is None:
            metric = cls._metric(index)
            qp = D.preprocess_vectors(queries, metric)
            gt = _brute_force_topk(qp, base, k, metric)
        proxy = cls(index, queries, gt, k=k, buckets=buckets)
        proxy.gt_secs = time.perf_counter() - t0
        return proxy

    @staticmethod
    def _corpus(index) -> Optional[np.ndarray]:
        g = getattr(index, "graph", None)
        if g is not None:
            return np.asarray(g.vectors, np.float32)
        state = getattr(index, "_state", None)          # MutableAnnIndex
        if state is not None and hasattr(state, "snapshot"):
            return np.asarray(state.snapshot.index.graph.vectors, np.float32)
        return None

    @staticmethod
    def _metric(index) -> str:
        g = getattr(index, "graph", None)
        if g is not None:
            return g.metric
        state = getattr(index, "_state", None)
        if state is not None and hasattr(state, "snapshot"):
            return state.snapshot.index.graph.metric
        raise TypeError(f"cannot resolve metric for {type(index).__name__}")

    # --- evaluation -------------------------------------------------------
    def _session(self, spec: SearchSpec):
        key = spec.canonical()
        sess = self._sessions.get(key)
        if sess is None:
            sess = self._sessions[key] = make_session(self.index, spec)
        return sess

    def evaluate(self, spec: SearchSpec, replays: int = 1
                 ) -> ProbeMeasurement:
        """Replay the probe set through ``spec``; exact recall + latency.

        The first (untimed) replay absorbs the probe bucket shape's first
        uses (engine setup, a new batch shape, kernel library loads); ``replays`` timed replays follow and the
        median is reported.  Failpoint site ``autotune.probe``.
        """
        from repro_torch.autotune.space import spec_key

        fault.hit("autotune.probe")
        sess = self._session(spec)
        k = min(self.k, sess.spec.efs)
        all_ids, lats, calls = None, [], []
        for r in range(max(1, int(replays)) + 1):
            ids_parts = []
            t0 = time.perf_counter()
            for lo in range(0, self.queries.shape[0], self.bucket):
                q = self.queries[lo:lo + self.bucket]
                qp, _ = pad_to_bucket(q, self.bucket)
                ids, _, stats = sess.search_padded(
                    qp, q.shape[0], k, sess.spec.cos_theta)
                ids_parts.append(ids)
                if r == 0:
                    calls.append(float(np.mean(stats.dist_calls)))
            if r == 0:            # untimed: eats the first uses
                all_ids = np.concatenate(ids_parts, axis=0)
                continue
            lats.append(time.perf_counter() - t0)
        rec = recall_at_k(all_ids, self.gt[:, :k], k)
        return ProbeMeasurement(
            key=spec_key(spec), recall=float(rec),
            lat_s=float(np.median(lats)),
            dist_calls=float(np.mean(calls)), replays=len(lats))
