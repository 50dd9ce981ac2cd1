"""Live index mutation: delta segment + tombstones + background merge.

The counterpart of ``repro.mutate.index``, on the index's device (the GPU
unless the caller asks for the CPU).  ``MutableAnnIndex`` wraps
``AnnIndex`` with ``insert``/``delete``/``search`` that work while
``ServeFrontend`` keeps answering queries (DESIGN.md §9):

* inserts land in a ``DeltaSegment`` (fixed-shape side table scanned on
  the device); its top-k merges with the main-graph pool host-side;
* deletes become a per-node tombstone mask threaded into the engine
  (``build_search_fn(..., tombstones=True)``): dead nodes still ROUTE —
  their edges stay traversable so recall through a tombstoned region holds
  — but they are masked out of the result pool, so a deleted id is never
  returned;
* when the delta fills past ``MutateConfig.merge_threshold`` (or the dead
  fraction passes ``tombstone_threshold``), a merge re-links survivors +
  delta into a fresh graph and atomically swaps the snapshot under an
  epoch guard.  In-flight searches finish on the old snapshot (they hold a
  reference; the state swap is one pointer write), the engine cache drops
  the dead graph via ``_purge_dead_cache_entries``, and the
  angle profile refreshes once the corpus drifts past
  ``profile_refresh_fraction`` of its size at sampling time.

External ids: ``insert`` assigns monotonically increasing int64 ids
(the initial wrap takes ids ``[0, n)`` for the base rows), and every search
returns EXTERNAL ids — merges renumber graph rows freely underneath.

Zero request-path first uses across a swap: eager PyTorch compiles
nothing, so the count here is of *first-use events* (``SearchEngine``: an
engine's setup, each batch shape it first runs, each kernel library it
first loads; ``delta_scan_compile_count``: each first scan shape), the
one-time work a request would otherwise pay.  The merge thread pre-warms
the fresh snapshot's engines at every (spec, batch shape) the serving
layer has noted (``note_shape``), and ``compile_count`` folds retired
engines + pre-warm discounts so serving telemetry sees a flat count
through the swap (the invariant ``recompiles_after_warmup == 0`` is
tested across a merge).  Each snapshot holds the engines its searches
used (``_Snapshot.engines``), so the engine cache's eviction cannot make
a request set one up again behind the count's back.

Thread model: ``search`` is lock-free (one volatile read of ``_state``);
``insert``/``delete`` serialize on a mutation lock; merges serialize on a
merge lock and only take the mutation lock for the final
residual-reconcile + swap.

Failure domains (DESIGN.md §10): a failed merge is retried under a capped
exponential backoff (``MutateConfig.merge_retries`` / ``merge_backoff_s``);
when the budget is exhausted the index enters *quarantine* for
``quarantine_cooldown_s`` — the pre-merge snapshot keeps serving, mutations
stay accepted while the delta has room, and ``maybe_merge`` stops
re-attempting until the cooldown lapses (or ``clear_quarantine()``).  The
exhausting error is kept in ``merge_error`` and re-raised by
``wait_for_merge``; a full delta during quarantine surfaces as typed
backpressure (``MergeQuarantinedError``), never a hang.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.angles import sample_angle_profile
from repro_torch.core.index import DEFAULT_SEARCH, GRAPH_BUILDERS, AnnIndex
from repro_torch.core.routers import get_router
from repro_torch.core.search import (_purge_dead_cache_entries,
                                     build_search_fn)
from repro_torch.core.spec import (SearchSpec, SearchStats,
                                   resolve_search_spec)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.durable.store import DurableStore
from repro_torch.durable.wal import FSYNC_POLICIES, InsertRecord
from repro_torch.fault import MergeQuarantinedError, RetryPolicy
from repro_torch.fault import failpoints as fault
from repro_torch.kernels import ops
from repro_torch.mutate.delta import DeltaSegment, delta_scan_compile_count

# Merge-rebuild graph parameters: modest by default (the merge runs while
# serving; construction quality is recovered by the next merge anyway).
# MutateConfig.graph_kw overrides.
GRAPH_DEFAULTS = {
    "nsg": dict(r=24, c=120, l=32, knn_k=24),
    "hnsw": dict(m=12, efc=80),
}


@dataclasses.dataclass(frozen=True)
class MutateConfig:
    """Policy knobs for the mutation machinery."""

    delta_capacity: int = 1024
    # merge when delta high-water mark passes this fraction of capacity
    merge_threshold: float = 0.75
    # ... or when this fraction of snapshot rows is tombstoned
    tombstone_threshold: float = 0.25
    # resample the angle profile when |corpus_now - corpus_at_sample| /
    # corpus_at_sample exceeds this (profile-staleness policy, DESIGN.md §9)
    profile_refresh_fraction: float = 0.2
    profile_percentile: float = 90.0
    graph: str = "nsg"            # what merges re-link into
    graph_kw: dict = dataclasses.field(default_factory=dict)
    auto_merge: str = "background"   # background | sync | off
    # merge-failure policy (DESIGN.md §10): retries after a failed attempt,
    # backoff between them, and how long the index sits quarantined (no
    # further merge attempts) once the whole budget is exhausted
    merge_retries: int = 3
    merge_backoff_s: float = 0.05
    merge_backoff_cap_s: float = 1.0
    quarantine_cooldown_s: float = 5.0
    seed: int = 0
    # durability (DESIGN.md §11): WAL fsync policy ("every" fsyncs before
    # each ack, "interval" group-commits on a wal_fsync_interval_s window,
    # "off" acks immediately — best-effort), and whether a successful merge
    # also rotates the log and publishes a checkpoint
    wal_fsync: str = "every"
    wal_fsync_interval_s: float = 0.002
    checkpoint_on_merge: bool = True

    def __post_init__(self):
        assert self.graph in GRAPH_BUILDERS, f"unknown graph {self.graph!r}"
        assert self.auto_merge in ("background", "sync", "off")
        assert self.delta_capacity >= 1
        assert self.merge_retries >= 0
        assert self.wal_fsync in FSYNC_POLICIES, \
            f"unknown wal_fsync {self.wal_fsync!r}"


class _Snapshot:
    """One immutable generation of the main graph (+ its engine ledger)."""

    def __init__(self, index: AnnIndex, ext_ids: np.ndarray):
        self.index = index
        self.ext_ids = np.asarray(ext_ids, np.int64)     # row -> external id
        self.ext_to_row: Dict[int, int] = {
            int(e): r for r, e in enumerate(self.ext_ids)}
        # canonical cfg -> engine used on this snapshot (held here, so the
        # engine cache's eviction cannot drop it), and how many of that
        # engine's first uses happened OFF the request path in the merge
        # pre-warm (compile_count subtracts them)
        self.engines: Dict[SearchSpec, object] = {}
        self.warm_discount: Dict[SearchSpec, int] = {}


@dataclasses.dataclass(frozen=True)
class _State:
    """What one search sees: grabbed with a single reference read."""

    snapshot: _Snapshot
    tombstone: np.ndarray        # [n] bool, host copy (mutation-side truth)
    tombstone_dev: torch.Tensor  # [n+1] bool on the device; pad row False
    n_dead: int
    delta: DeltaSegment
    epoch: int


def _tombstone_dev(tomb: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The engine's tombstone mask, built once for each state."""
    return torch.as_tensor(np.concatenate([tomb, np.zeros(1, bool)]),
                           device=dev)


class MutableAnnIndex:
    """``AnnIndex`` + insert/delete/background-merge, served without downtime."""

    def __init__(self, index: AnnIndex, config: MutateConfig = MutateConfig(),
                 spec: Optional[SearchSpec] = None, *,
                 durable_dir: Optional[str] = None):
        g = index.graph
        self.config = config
        self.device = index.device
        self.default_spec = spec if spec is not None else DEFAULT_SEARCH
        snap = _Snapshot(index, np.arange(g.n, dtype=np.int64))
        tomb = np.zeros((g.n,), bool)
        self._state = _State(
            snapshot=snap, tombstone=tomb,
            tombstone_dev=_tombstone_dev(tomb, self.device),
            n_dead=0, epoch=0,
            delta=DeltaSegment.empty(config.delta_capacity, g.dim, g.metric))
        self._next_ext = g.n                  # guarded by: self._lock
        self._lock = threading.RLock()        # state swaps + mutation ops
        self._merge_lock = threading.Lock()   # one merge at a time
        self._engine_lock = threading.Lock()  # engine ledger + retired count
        # compiles owned by dead snapshots -- guarded by: self._engine_lock
        self._retired = 0
        # cfg -> batch sizes -- guarded by: self._engine_lock
        self._noted: Dict[SearchSpec, Set[int]] = {}
        self._merge_thread: Optional[threading.Thread] = None  # guarded by: self._lock
        self.merge_error: Optional[BaseException] = None  # guarded by: self._lock
        self.merges_completed = 0
        self.merge_retries_used = 0          # backoff retries ever taken
        # seconds of each step of the last completed merge, and the kernel
        # launches of its graph build (the merging thread's own)
        self.last_merge: Optional[Dict[str, object]] = None
        # time.monotonic() deadline -- guarded by: self._lock
        self._quarantined_until = 0.0
        self._durable: Optional[DurableStore] = None
        self._replaying = False              # recover() applies, no re-log
        if durable_dir is not None:
            self._init_durable(durable_dir)

    # --- convenience ------------------------------------------------------
    @classmethod
    def build(cls, base: np.ndarray, config: MutateConfig = MutateConfig(),
              spec: Optional[SearchSpec] = None, graph: str = "hnsw",
              device: DeviceLike = None, **build_kw) -> "MutableAnnIndex":
        """``AnnIndex.build`` on ``device`` (``None``: the GPU), wrapped."""
        return cls(AnnIndex.build(base, graph=graph, device=device,
                                  **build_kw),
                   config=config, spec=spec)

    @property
    def metric(self) -> str:
        return self._state.snapshot.index.graph.metric

    @property
    def dim(self) -> int:
        return self._state.snapshot.index.graph.dim

    @property
    def epoch(self) -> int:
        return self._state.epoch

    @property
    def n_live(self) -> int:
        s = self._state
        return s.snapshot.index.graph.n - s.n_dead + s.delta.n_live

    def live_ids(self) -> np.ndarray:
        """Sorted external ids currently searchable (test/debug aid)."""
        s = self._state
        main = s.snapshot.ext_ids[~s.tombstone]
        _, d_ids = s.delta.live_rows()
        return np.sort(np.concatenate([main, d_ids]))

    # --- mutation ---------------------------------------------------------
    def _check_merge_error(self):
        # read-and-clear must be atomic against a concurrent merge failure
        # storing a new error between our read and our reset
        with self._lock:
            if self.merge_error is None:
                return
            err, self.merge_error = self.merge_error, None
        raise RuntimeError("background merge failed") from err

    def insert(self, vectors: np.ndarray) -> np.ndarray:
        """Add rows; returns their assigned external ids (int64 [n]).

        Accepted even while merges are failing (quarantine) — the delta
        absorbs writes until it is genuinely full, at which point a
        quarantined index raises ``MergeQuarantinedError`` (typed
        backpressure) rather than attempting a merge it knows is sick.
        """
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        vectors = D.preprocess_vectors(np.ascontiguousarray(vectors),
                                       self.metric)
        n = vectors.shape[0]
        if n > self.config.delta_capacity:
            raise ValueError(
                f"insert of {n} rows exceeds delta_capacity="
                f"{self.config.delta_capacity}; insert in smaller chunks")
        lsn = None
        while True:
            with self._lock:
                state = self._state
                if n <= state.delta.room:
                    ids = np.arange(self._next_ext, self._next_ext + n,
                                    dtype=np.int64)
                    if self._durable is not None and not self._replaying:
                        # write-ahead, inside the mutation lock: LSN order
                        # is mutation order.  A failed append leaves the
                        # in-memory state UNtouched — the caller's error is
                        # the non-acknowledgment.
                        lsn = self._durable.append_insert(ids, vectors)
                    self._next_ext += n
                    self._state = dataclasses.replace(
                        state, delta=state.delta.insert(vectors, ids))
                    break
            # no room: a merge must drain the delta first.  Outside the
            # mutation lock — the merge takes it for the final swap.
            if self.config.auto_merge == "off":
                raise ValueError(
                    "delta segment full and auto_merge='off'; call merge()")
            if self.quarantined:
                with self._lock:
                    left = self._quarantined_until - time.monotonic()
                raise MergeQuarantinedError(
                    "delta segment full while merges are quarantined "
                    f"({left:.1f}s of cooldown left); retry later or "
                    "clear_quarantine()")
            try:
                self._merge_with_retry()
            except Exception as e:   # noqa: BLE001 — typed backpressure
                # the drain itself exhausted its budget (we are quarantined
                # now): callers get one typed error, whatever the cause
                raise MergeQuarantinedError(
                    "delta segment full and the drain merge failed "
                    "(index now quarantined)") from e
        if lsn is not None:
            # acknowledgment point: outside the mutation lock (group commit
            # batches concurrent acks under one fsync), before returning ids
            self._durable.ack(lsn)
        self.maybe_merge()
        return ids

    def delete(self, ext_ids) -> int:
        """Remove external ids from search results; returns count removed.

        Unknown or already-deleted ids raise ``KeyError`` (and the whole
        call applies atomically: either every id dies or none do).
        Accepted during merge quarantine — tombstones are cheap.
        """
        if np.ndim(ext_ids) == 0:
            ext_ids = [ext_ids]
        ext_ids = [int(e) for e in ext_ids]
        lsn = None
        with self._lock:
            state = self._state
            delta = state.delta
            tomb = None
            n_dead = state.n_dead
            for e in ext_ids:
                delta2, found = delta.delete(e)
                if found:
                    delta = delta2
                    continue
                row = state.snapshot.ext_to_row.get(e)
                dead = (tomb if tomb is not None else state.tombstone)
                if row is None or dead[row]:
                    raise KeyError(f"external id {e} is not live")
                if tomb is None:
                    tomb = state.tombstone.copy()
                tomb[row] = True
                n_dead += 1
            if self._durable is not None and not self._replaying:
                # write-ahead AFTER validation (a rejected delete must not
                # log) and BEFORE publishing the new state (log-before-apply)
                lsn = self._durable.append_delete(
                    np.asarray(ext_ids, np.int64))
            if tomb is not None:
                state = dataclasses.replace(
                    state, tombstone=tomb,
                    tombstone_dev=_tombstone_dev(tomb, self.device),
                    n_dead=n_dead)
            self._state = dataclasses.replace(state, delta=delta)
            removed = len(ext_ids)
        if lsn is not None:
            self._durable.ack(lsn)
        self.maybe_merge()
        return removed

    # --- search -----------------------------------------------------------
    def _resolve_cos_theta(self, spec: SearchSpec, snap: _Snapshot) -> float:
        if spec.cos_theta is not None:
            return spec.cos_theta
        profile = snap.index.profile
        if profile is not None:
            return profile.cos_theta_star
        if get_router(spec.router).prunes:
            raise ValueError(
                f"router {spec.router!r} prunes on the angle threshold, but "
                "this index has no angle profile and the spec carries no "
                "explicit cos_theta (see AnnIndex.search)")
        return 0.0

    def note_shape(self, cfg: SearchSpec, batch: int):
        """Record a serving (spec, batch shape): merges pre-warm these on
        the fresh snapshot so the swap costs zero request-path compiles."""
        with self._engine_lock:
            self._noted.setdefault(cfg.canonical(), set()).add(int(batch))

    def _engine(self, snap: _Snapshot, cfg: SearchSpec):
        key = cfg.canonical()
        with self._engine_lock:
            fn = snap.engines.get(key)
        if fn is not None:
            return fn
        _, fn = build_search_fn(snap.index.graph, cfg, tombstones=True,
                                device=self.device)
        with self._engine_lock:
            return snap.engines.setdefault(key, fn)

    def search(self, queries: np.ndarray, spec: Optional[SearchSpec] = None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Search main graph + delta.  Returns (ext_ids [B,k] int64 with -1
        pads, ranking dists [B,k], SearchStats with a ``delta_scanned``
        extra counter).  Lock-free: the (snapshot, tombstone, delta) triple
        is one immutable state grabbed up front, so a concurrent merge swap
        never tears a search."""
        state = self._state            # epoch guard: one consistent state
        snap = state.snapshot
        g = snap.index.graph
        spec = resolve_search_spec(spec, self.default_spec,
                                   "MutableAnnIndex.search")
        q = D.prepare_queries(queries, g.metric)
        cos_theta = self._resolve_cos_theta(spec, snap)
        k = spec.k
        cfg = dataclasses.replace(
            spec, efs=max(spec.efs, k), metric=g.metric,
            use_hierarchy=g.upper_neighbors is not None)
        self.note_shape(cfg, q.shape[0])
        fn = self._engine(snap, cfg)
        res = fn(q, cos_theta, state.tombstone_dev)
        rows = res.ids[:, :k].cpu().numpy().astype(np.int64)
        g_dists = res.dists[:, :k].cpu().numpy().copy()
        pad = rows >= g.n
        g_ids = np.where(pad, -1, snap.ext_ids[np.where(pad, 0, rows)])
        g_dists[pad] = np.inf

        d_ids, d_dists, scanned = state.delta.topk(
            q, k, use_sq8=cfg.estimate in ("sq8", "both"),
            device=self.device)

        # host-side merge: 2k candidates -> k (ids are disjoint across the
        # graph snapshot and the delta, so no dedup pass is needed)
        all_ids = np.concatenate([g_ids, d_ids], axis=1)
        all_d = np.concatenate([g_dists, d_dists], axis=1)
        order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
        out_ids = np.take_along_axis(all_ids, order, axis=1)
        out_d = np.take_along_axis(all_d, order, axis=1)
        out_ids = np.where(np.isfinite(out_d), out_ids, -1)

        stats = SearchStats.from_result(res, router=spec.router)
        stats.extra["delta_scanned"] = scanned
        return out_ids, out_d, stats

    # --- compile accounting ----------------------------------------------
    def engine_compile_count(self) -> int:
        """Graph-engine first uses on behalf of THIS index (see
        ``SearchEngine.first_uses``): retired snapshots at their swap-time
        counts, plus the live snapshot's engines minus the merge pre-warm
        discount.  Excludes the delta scans, which are process-wide."""
        with self._engine_lock:
            snap = self._state.snapshot
            live = sum(fn.first_uses() - snap.warm_discount.get(key, 0)
                       for key, fn in snap.engines.items())
            return self._retired + live

    def compile_count(self) -> int:
        """``engine_compile_count`` + the (process-wide) delta-scan first
        uses — continuous across snapshot swaps."""
        return self.engine_compile_count() + delta_scan_compile_count()

    # --- merge ------------------------------------------------------------
    def needs_merge(self) -> bool:
        s = self._state
        cap = self.config.delta_capacity
        if s.delta.count >= self.config.merge_threshold * cap:
            return True
        n = s.snapshot.index.graph.n
        return n > 0 and s.n_dead >= self.config.tombstone_threshold * n

    # --- merge-failure policy (DESIGN.md §10) ----------------------------
    @property
    def quarantined(self) -> bool:
        """True while the quarantine cooldown from an exhausted merge-retry
        budget is running: no merge attempts, pre-merge snapshot serves."""
        with self._lock:
            return time.monotonic() < self._quarantined_until

    def clear_quarantine(self):
        """Operator override: forget the quarantine and its stored error."""
        with self._lock:
            self._quarantined_until = 0.0
            self.merge_error = None

    def _merge_with_retry(self) -> bool:
        """``merge()`` under the configured backoff; exhaustion quarantines.

        Each failed attempt backs off (capped exponential, seeded jitter)
        and retries; when ``merge_retries`` are all spent the index enters
        quarantine, the exhausting error is stored in ``merge_error``, and
        the error re-raises (background callers swallow it — the state IS
        the record).  Data loss: none — a failed merge never swapped, so
        the pre-merge snapshot + delta keep serving and mutating.
        """
        policy = RetryPolicy(
            max_attempts=self.config.merge_retries + 1,
            base_s=self.config.merge_backoff_s,
            cap_s=self.config.merge_backoff_cap_s,
            # total-budget cap: the whole retry schedule fits inside one
            # quarantine cooldown, so backoff can never outlast the state
            # it would transition into
            max_elapsed_s=self.config.quarantine_cooldown_s,
            seed=self.config.seed)

        def count_retry(_attempt, _exc):
            self.merge_retries_used += 1

        try:
            return policy.call(self.merge, on_retry=count_retry)
        except Exception as e:   # noqa: BLE001 — converted to quarantine state
            with self._lock:
                self.merge_error = e
                self._quarantined_until = (
                    time.monotonic() + self.config.quarantine_cooldown_s)
            raise

    def maybe_merge(self):
        """Apply the configured merge policy (called after every mutation).
        Quarantined: no-op — mutations keep landing in the delta/tombstones
        and the next call after the cooldown retries the merge."""
        if self.config.auto_merge == "off" or not self.needs_merge():
            return
        if self.quarantined:
            return
        if self.config.auto_merge == "sync":
            self._merge_with_retry()
            return
        with self._lock:
            if self._merge_thread is not None and self._merge_thread.is_alive():
                return

            def run():
                try:
                    self._merge_with_retry()
                # repolint: ignore[fail-open] _merge_with_retry stored the
                # failure (merge_error + quarantine cooldown) before raising;
                # this wrapper only keeps the daemon thread quiet
                except Exception:   # noqa: BLE001 — recorded as quarantine
                    pass            # merge_error + cooldown already set

            self._merge_thread = threading.Thread(
                target=run, name="mutate-merge", daemon=True)
            self._merge_thread.start()

    def wait_for_merge(self):
        """Block until a background merge (if any) finishes, then re-raise
        any failure it left behind."""
        # repolint: ignore[guarded-by] volatile read: join() on a stale
        # thread ref is benign (it already finished), and holding the
        # mutation lock across a join would deadlock against the merge swap
        t = self._merge_thread
        if t is not None:
            t.join()
        self._check_merge_error()

    def merge(self) -> bool:
        """Re-link survivors + delta into a fresh graph and swap it in.

        Returns False when there was nothing to merge.  Safe to call
        concurrently (merges serialize); searches continue on the old
        snapshot until the single-reference swap at the end.
        """
        with self._merge_lock:
            base = self._state
            if base.n_dead == 0 and base.delta.count == 0:
                return False
            snap = base.snapshot
            g = snap.index.graph
            steps: Dict[str, object] = {}
            t0 = time.perf_counter()

            # 1) gather survivors + live delta rows (the merge feed)
            keep = ~base.tombstone
            d_vecs, d_ids = base.delta.live_rows()
            new_base = np.concatenate([g.vectors[keep], d_vecs], axis=0)
            new_ext = np.concatenate([snap.ext_ids[keep], d_ids])
            if new_base.shape[0] == 0:
                raise ValueError("merge would leave an empty index")

            # 2) re-link into a fresh graph (the expensive, lock-free part;
            # an NSG builds on the device, its acquisition through the
            # kernels)
            t1 = time.perf_counter()
            fault.hit("mutate.merge.build")
            kw = dict(GRAPH_DEFAULTS.get(self.config.graph, {}))
            kw.update(self.config.graph_kw)
            launches0 = ops.thread_launch_counts()
            new_g = GRAPH_BUILDERS[self.config.graph](
                new_base, metric=g.metric,
                seed=self.config.seed + base.epoch + 1, device=self.device,
                **kw)
            launches = ops.thread_launch_counts()
            steps["build_launches"] = {
                k: v - launches0[k] for k, v in launches.items()
                if v - launches0[k]}
            steps["build_steps_secs"] = {
                k: v for k, v in (new_g.build_stats or {}).items()
                if k.endswith("_secs")}
            t2 = time.perf_counter()

            # 3) profile-refresh policy: resample when the corpus drifted
            # past the configured fraction of its size at sampling time
            profile = snap.index.profile
            if profile is not None:
                ref = profile.corpus_n
                drift = abs(new_g.n - ref) / ref if ref > 0 else np.inf
                if drift > self.config.profile_refresh_fraction:
                    profile = sample_angle_profile(
                        new_g, percentile=self.config.profile_percentile,
                        seed=self.config.seed + base.epoch + 1)
            new_snap = _Snapshot(AnnIndex(graph=new_g, profile=profile,
                                          device=self.device), new_ext)
            t3 = time.perf_counter()

            # 4) pre-warm every noted (spec, batch shape) on the fresh graph
            # BEFORE the swap: post-swap dispatches find every engine set up
            # and every batch shape run
            self._prewarm(new_snap)
            t4 = time.perf_counter()

            # 5) reconcile mutations that raced the build, then swap
            fault.hit("mutate.merge.swap")
            with self._lock:
                cur = self._state
                tomb = np.zeros((new_g.n,), bool)
                n_dead = 0
                # snapshot rows deleted since the merge started
                resid = np.flatnonzero(cur.tombstone & ~base.tombstone)
                dead_ext = [int(snap.ext_ids[r]) for r in resid]
                # delta rows that were merged in but died since
                bc = base.delta.count
                died = base.delta.live[:bc] & ~cur.delta.live[:bc]
                dead_ext += [int(e) for e in base.delta.ext_ids[:bc][died]]
                for e in dead_ext:
                    row = new_snap.ext_to_row.get(e)
                    if row is not None and not tomb[row]:
                        tomb[row] = True
                        n_dead += 1
                # delta rows inserted since the merge started carry over
                # (with their live flags — a delete may have raced in too)
                fresh = DeltaSegment.empty(self.config.delta_capacity,
                                           new_g.dim, new_g.metric)
                nres = cur.delta.count - bc
                if nres > 0:
                    fresh = fresh.insert(cur.delta.vectors[bc:bc + nres],
                                         cur.delta.ext_ids[bc:bc + nres])
                    live = fresh.live.copy()
                    live[:nres] = cur.delta.live[bc:bc + nres]
                    fresh = dataclasses.replace(fresh, live=live)
                tomb_dev = _tombstone_dev(tomb, self.device)
                with self._engine_lock:
                    # retire the old snapshot's first-use ledger so the
                    # count stays continuous across the swap
                    for key, fn in snap.engines.items():
                        self._retired += (fn.first_uses()
                                          - snap.warm_discount.get(key, 0))
                    self._state = _State(
                        snapshot=new_snap, tombstone=tomb,
                        tombstone_dev=tomb_dev, n_dead=n_dead,
                        delta=fresh, epoch=base.epoch + 1)
            t5 = time.perf_counter()
            if (self._durable is not None and not self._replaying
                    and self.config.checkpoint_on_merge):
                # a merged graph makes the log prefix redundant: rotate +
                # publish so recovery replays only post-merge mutations.
                # Failure here propagates (the merge retry/quarantine
                # machinery owns it) — the swap above already happened and
                # durability is unaffected: the old binding still replays
                # the full acked history.
                self._checkpoint_locked()
            t6 = time.perf_counter()
            steps.update(gather_secs=t1 - t0, build_secs=t2 - t1,
                         profile_secs=t3 - t2, prewarm_secs=t4 - t3,
                         swap_secs=t5 - t4, checkpoint_secs=t6 - t5,
                         total_secs=t6 - t0, n=int(new_g.n))
            self.last_merge = steps
            self.merges_completed += 1
        # old snapshot is unreferenced once in-flight searches drain; drop
        # its compiled engines + device arrays (THE _purge_dead_cache_entries
        # scenario: a dead graph id must not pin device buffers)
        _purge_dead_cache_entries()
        return True

    def _prewarm(self, new_snap: _Snapshot):
        g = new_snap.index.graph
        tomb_dev = _tombstone_dev(np.zeros((g.n,), bool), self.device)
        with self._engine_lock:
            noted = {key: sorted(bs) for key, bs in self._noted.items()}
        # the cos(theta*) a request without its own searches with: the hop
        # graphs on the card are captured for it
        profile = new_snap.index.profile
        cos_theta = profile.cos_theta_star if profile is not None else 0.0
        for key, batches in noted.items():
            cfg = dataclasses.replace(
                key, metric=g.metric,
                use_hierarchy=g.upper_neighbors is not None).canonical()
            _, fn = build_search_fn(g, cfg, tombstones=True,
                                    device=self.device)
            for b in batches:
                dummy = torch.zeros((b, g.dim), dtype=torch.float32,
                                    device=self.device)
                fn(dummy, cos_theta, tomb_dev).ids.cpu()
            with self._engine_lock:
                new_snap.engines[cfg] = fn
                new_snap.warm_discount[cfg] = fn.first_uses()

    # --- persistence ------------------------------------------------------
    def save(self, path: str, *, strict: bool = False):
        """Persist the current MERGED SNAPSHOT only — a plain ``AnnIndex``
        payload, NOT the live mutation state.

        The trap: unmerged delta rows and tombstones are *not* in
        the snapshot, so saving while they exist writes a file that silently
        forgets acknowledged mutations.  When that would happen this method
        warns (or raises ``ValueError`` under ``strict=True``) and still
        writes the snapshot.  For a file that reflects everything, call
        ``merge()`` first; for crash durability of every acknowledged
        mutation, use ``durable_dir=`` / ``checkpoint()`` / ``recover()``
        (DESIGN.md §11) instead of point-in-time saves.
        """
        self.wait_for_merge()
        s = self._state
        if s.delta.count > 0 or s.n_dead > 0:
            msg = (f"MutableAnnIndex.save: snapshot-only save is dropping "
                   f"{s.delta.n_live} unmerged delta row(s) and "
                   f"{s.n_dead} tombstone(s); call merge() first for a "
                   "point-in-time file, or use checkpoint()/durable_dir= "
                   "for crash durability")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
        s.snapshot.index.save(path)

    # --- durability (DESIGN.md §11) ---------------------------------------
    def _init_durable(self, dirname: str):
        """Create a fresh durable directory: initial checkpoint of the
        current state, then an empty active WAL segment to append into."""
        store = DurableStore.create(
            dirname, fsync=self.config.wal_fsync,
            fsync_interval_s=self.config.wal_fsync_interval_s,
            meta={"kind": "mutable-index"})
        store.publish_checkpoint(self._checkpoint_payload())
        store.attach()
        self._durable = store

    def _checkpoint_payload(self) -> Dict[str, np.ndarray]:
        """Full recoverable state: the snapshot's ``AnnIndex`` payload plus
        the mutation extras (``ckpt_*``).  Dead delta rows are dropped —
        external ids are never reused, so nothing can reference them again.
        """
        with self._lock:
            state = self._state
            next_ext = self._next_ext
        snap = state.snapshot
        d_vecs, d_ids = state.delta.live_rows()
        payload = snap.index._payload()
        payload.update(
            ckpt_ext_ids=snap.ext_ids,
            ckpt_tombstone=state.tombstone,
            ckpt_delta_vectors=d_vecs,
            ckpt_delta_ids=d_ids,
            ckpt_next_ext=np.asarray(next_ext, np.int64),
            ckpt_epoch=np.asarray(state.epoch, np.int64))
        return payload

    def checkpoint(self) -> str:
        """Rotate the WAL and publish a checkpoint of the current state;
        returns the checkpoint file name.  After it lands, recovery loads
        the checkpoint and replays only mutations acked since this call.
        A crash at ANY point leaves a manifest binding that still replays
        the complete acked history (the rotation/publication state machine,
        DESIGN.md §11)."""
        if self._durable is None:
            raise ValueError(
                "index has no durable store; construct with durable_dir= "
                "or via recover()")
        with self._merge_lock:     # serialize with merges (and their ckpts)
            return self._checkpoint_locked()

    def _checkpoint_locked(self) -> str:
        """Checkpoint with the merge lock already held (merge() tail)."""
        with self._lock:
            # the rotate boundary is a mutation-order boundary: capture the
            # state under the SAME lock hold so the checkpoint is exactly
            # "everything before the new segment"
            self._durable.rotate()
            payload = self._checkpoint_payload()
        # the expensive write happens off the mutation lock
        return self._durable.publish_checkpoint(payload)

    @classmethod
    def recover(cls, dirname: str, config: MutateConfig = MutateConfig(),
                spec: Optional[SearchSpec] = None, *,
                attach: bool = True,
                device: DeviceLike = None) -> "MutableAnnIndex":
        """Rebuild a ``MutableAnnIndex`` from a durable directory: load the
        manifest's checkpoint, replay the bound WAL segments into delta +
        tombstones, and (with ``attach=True``) keep appending to the log.

        Replay is idempotent — an insert of an already-live id and a delete
        of an already-dead id are skipped — and tolerant of a torn tail on
        the final segment (those records were never acknowledged; they are
        truncated away).  Mid-log corruption raises ``CorruptIndexError``.
        ``attach=False`` opens the state read-write in memory but leaves
        the log alone (export/load semantics).  The recovered index
        searches on ``device`` (``None``: the GPU).  A directory written by
        the JAX package's ``MutableAnnIndex`` recovers here, and the other
        way round: the formats are the same.
        """
        dev = resolve_device(device)
        store = DurableStore.open(
            dirname, fsync=config.wal_fsync,
            fsync_interval_s=config.wal_fsync_interval_s)
        z = store.load_checkpoint()
        index = AnnIndex._from_payload(z, dev)
        obj = cls(index, config=config, spec=spec)
        snap = _Snapshot(index, np.asarray(z["ckpt_ext_ids"], np.int64))
        tomb = np.ascontiguousarray(z["ckpt_tombstone"], bool)
        obj._state = _State(
            snapshot=snap, tombstone=tomb,
            tombstone_dev=_tombstone_dev(tomb, dev), n_dead=int(tomb.sum()),
            delta=DeltaSegment.empty(config.delta_capacity,
                                     index.graph.dim, index.graph.metric),
            epoch=int(z["ckpt_epoch"]))
        obj._next_ext = int(z["ckpt_next_ext"])
        obj._replaying = True
        try:
            d_vecs = np.ascontiguousarray(z["ckpt_delta_vectors"], np.float32)
            if d_vecs.shape[0]:
                obj._apply_insert(
                    np.asarray(z["ckpt_delta_ids"], np.int64), d_vecs)
            for rec in store.replay():
                if isinstance(rec, InsertRecord):
                    obj._apply_insert(rec.ext_ids, rec.vectors)
                else:
                    obj._apply_delete(rec.ext_ids)
        finally:
            obj._replaying = False
        if attach:
            store.attach()
            obj._durable = store
        else:
            store.close()
        return obj

    def _is_live(self, e: int) -> bool:
        s = self._state
        if s.delta.contains(e):
            return True
        row = s.snapshot.ext_to_row.get(e)
        return row is not None and not s.tombstone[row]

    def _apply_insert(self, ext_ids: np.ndarray, vectors: np.ndarray):
        """Replay-side insert: ids are pre-assigned, vectors already
        preprocessed (they were logged post-preprocessing).  Already-live
        ids are skipped (idempotence); a full delta merges mid-replay."""
        ext_ids = np.asarray(ext_ids, np.int64)
        vectors = np.ascontiguousarray(vectors, np.float32)
        keep = [i for i, e in enumerate(ext_ids) if not self._is_live(int(e))]
        if len(keep) != len(ext_ids):
            ext_ids, vectors = ext_ids[keep], vectors[keep]
        if ext_ids.size == 0:
            return
        i = 0
        while i < ext_ids.size:
            with self._lock:
                room = self._state.delta.room
                if room > 0:
                    j = min(i + room, ext_ids.size)
                    self._state = dataclasses.replace(
                        self._state, delta=self._state.delta.insert(
                            vectors[i:j], ext_ids[i:j]))
                    i = j
                    continue
            self.merge()   # replay-time drain: no checkpoint, no retries
        with self._lock:
            self._next_ext = max(self._next_ext, int(ext_ids.max()) + 1)

    def _apply_delete(self, ext_ids: np.ndarray):
        """Replay-side delete: already-dead / unknown ids are skipped."""
        with self._lock:
            state = self._state
            delta = state.delta
            tomb = None
            n_dead = state.n_dead
            for e in map(int, np.asarray(ext_ids).ravel()):
                delta2, found = delta.delete(e)
                if found:
                    delta = delta2
                    continue
                row = state.snapshot.ext_to_row.get(e)
                dead = (tomb if tomb is not None else state.tombstone)
                if row is None or dead[row]:
                    continue
                if tomb is None:
                    tomb = state.tombstone.copy()
                tomb[row] = True
                n_dead += 1
            if tomb is not None:
                state = dataclasses.replace(
                    state, tombstone=tomb,
                    tombstone_dev=_tombstone_dev(tomb, self.device),
                    n_dead=n_dead)
            self._state = dataclasses.replace(state, delta=delta)

    def close(self):
        """Release the WAL writer (final fsync included).  The in-memory
        index stays usable, but further durable mutations raise."""
        if self._durable is not None:
            self._durable.close()
