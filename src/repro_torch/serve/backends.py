"""Engine-session adapters: one serving interface over the port's indexes.

The counterpart of ``repro.serve.backends``.  The frontend speaks one
protocol — ``search_padded(q, n_valid, k, cos_theta)`` plus a first-use
counter (``compile_count``) — and these adapters bind it to the engines:

* ``SingleIndexSession`` — ``AnnIndex`` over the engine cache of
  ``repro_torch.core.search`` (one ``SearchEngine`` per canonical spec).
  The session holds its engine and searches through it
  (``AnnIndex.search_on``), so the cache's eviction cannot set it up again
  behind the count.  Stats are per-query arrays, so a dispatch's stats
  slice exactly per request.
* ``ShardedIndexSession`` — ``ShardedAnnIndex`` over its per-canonical-spec
  serve-step cache.  The bucket ``valid`` mask rides to the engine so the
  shard-reduced counter totals exclude padded lanes; stats are batch totals
  behind one merge and cannot be split per request (each request of a
  dispatch sees the dispatch's totals).
* ``MutableIndexSession`` — ``MutableAnnIndex`` (delta + tombstones +
  background merge, DESIGN.md §9).  The session does NOT pin a graph or an
  engine: every dispatch resolves the index's current snapshot, so a
  concurrent merge swap is invisible to the request path.  Warmup notes
  each bucket shape with the index (``note_shape``), merges pre-warm those
  shapes on the fresh graph before swapping, and ``compile_count`` folds
  retired + pre-warmed engines — so ``recompiles_after_warmup`` stays 0
  across snapshot swaps.
* ``MutableShardedIndexSession`` — ``MutableShardedAnnIndex`` (host-side
  per-shard composition, DESIGN.md §9/§10).  Stats are the dispatch's
  shard-merged record (no per-request split), which is what carries the
  graceful-degradation fields: a dispatch that lost shards resolves its
  futures with ``stats.degraded``/``shards_failed`` set rather than an
  exception.

``compile_count`` counts *first-use events* (``SearchEngine.first_uses``:
an engine's setup, each batch shape it first runs, each kernel library
its calls first load, each hop graph captured on a batch shape it had
run; plus, for a mutable index, each first delta-scan shape), the
one-time work the JAX package's count of XLA executables stands for.
``k`` never adds one; on a CUDA device a ``cos_theta`` a bucket has not
yet run with adds one, the capture of that bucket's hop graph for it
(warmup runs the session's own).  After warmup a session's count moves
only if a request paid such work.
``k`` is capped at the session's ``efs``: a larger ``k`` would widen the
result pool, a new engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.index import DEFAULT_SEARCH, AnnIndex
from repro_torch.core.search import build_search_fn
from repro_torch.core.sharded_index import ShardedAnnIndex
from repro_torch.core.spec import SearchSpec, SearchStats


class SingleIndexSession:
    """``AnnIndex`` behind the serving protocol (per-query stats)."""

    splits_stats = True   # per-request stats slices are exact

    def __init__(self, index: AnnIndex, spec: SearchSpec):
        self.index = index
        self.spec = index.engine_spec(spec)
        self.dim = index.graph.dim
        # held for the session's life and searched through: its ledger
        # counts every first use this session's searches pay
        _, self._fn = build_search_fn(index.graph, self.spec,
                                      device=index.device)

    def compile_count(self) -> int:
        return self._fn.first_uses()

    def health(self) -> dict:
        return {"kind": "single", "n": int(self.index.graph.n),
                "degraded": False}

    def sample_query(self) -> np.ndarray:
        return np.asarray(self.index.graph.vectors[0], np.float32)

    def search_padded(self, queries: np.ndarray, n_valid: int, k: int,
                      cos_theta: Optional[float]
                      ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        ids, dists, stats = self.index.search_on(
            self._fn, queries, self.spec.replace(k=k, cos_theta=cos_theta))
        return (ids[:n_valid], dists[:n_valid],
                self.stats_for_rows(stats, 0, n_valid))

    def stats_for_rows(self, stats: SearchStats, lo: int, hi: int
                       ) -> SearchStats:
        return stats.rows(lo, hi)


class ShardedIndexSession:
    """``ShardedAnnIndex`` behind the serving protocol (batch-total stats)."""

    splits_stats = False  # shard-reduced totals: per-request stats = dispatch

    def __init__(self, index: ShardedAnnIndex, spec: SearchSpec):
        self.index = index
        self.spec = dataclasses.replace(
            spec, efs=max(spec.efs, spec.k), metric=index.arrays.metric,
            use_hierarchy=False)
        self.dim = index.arrays.vectors.shape[-1]
        # the step every search of this canonical spec runs: its ledger
        # counts one setup and one first use per batch shape, whatever the
        # shard count (router validation happens here)
        self._fn = index._step(self.spec)

    def compile_count(self) -> int:
        return self._fn.first_uses()

    def health(self) -> dict:
        return {"kind": "sharded",
                "n_shards": int(self.index.arrays.vectors.shape[0]),
                "degraded": False}

    def sample_query(self) -> np.ndarray:
        return np.asarray(self.index.arrays.vectors[0, 0], np.float32)

    def search_padded(self, queries: np.ndarray, n_valid: int, k: int,
                      cos_theta: Optional[float]
                      ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        valid = np.zeros((queries.shape[0],), bool)
        valid[:n_valid] = True
        ids, dists, stats = self.index.search(
            queries, spec=self.spec.replace(k=k, cos_theta=cos_theta),
            valid=valid)
        return ids[:n_valid], dists[:n_valid], stats

    def stats_for_rows(self, stats: SearchStats, lo: int, hi: int
                       ) -> SearchStats:
        return stats


class MutableIndexSession:
    """``MutableAnnIndex`` behind the serving protocol (per-query stats).

    Snapshot-agnostic: holds only the user spec.  Graph-dependent spec
    fields (``metric``/``use_hierarchy``) are resolved inside
    ``MutableAnnIndex.search`` against whatever snapshot is live at
    dispatch time, so bucket sessions survive a merge swap with zero
    request-path first uses (the merge pre-warms every shape this session
    warmed, via ``note_shape``).
    """

    splits_stats = True   # per-request stats slices are exact

    def __init__(self, index, spec: SearchSpec):
        self.index = index
        self.spec = dataclasses.replace(spec, efs=max(spec.efs, spec.k))

    @property
    def dim(self) -> int:
        return self.index.dim

    def compile_count(self) -> int:
        # engines across every snapshot generation + the delta scans
        return self.index.compile_count()

    def health(self) -> dict:
        idx = self.index
        return {"kind": "mutable", "n_live": int(idx.n_live),
                "epoch": int(idx.epoch),
                "quarantined": bool(idx.quarantined),
                "degraded": bool(idx.quarantined),
                "merge_error": (repr(idx.merge_error)
                                if idx.merge_error is not None else None),
                "durable": idx._durable is not None}

    def sample_query(self) -> np.ndarray:
        g = self.index._state.snapshot.index.graph
        return np.asarray(g.vectors[0], np.float32)

    def search_padded(self, queries: np.ndarray, n_valid: int, k: int,
                      cos_theta: Optional[float]
                      ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        ids, dists, stats = self.index.search(
            queries, spec=self.spec.replace(k=k, cos_theta=cos_theta))
        return (ids[:n_valid], dists[:n_valid],
                self.stats_for_rows(stats, 0, n_valid))

    stats_for_rows = SingleIndexSession.stats_for_rows


class MutableShardedIndexSession:
    """``MutableShardedAnnIndex`` behind the serving protocol.

    The host-side top-k composition means per-shard failures degrade the
    dispatch instead of failing it (``MutableShardedAnnIndex.search``);
    the shard-merged stats carry ``shards_failed``/``degraded`` to every
    request of the dispatch.  Stats are batch-level (per-query arrays from
    S shards concatenate under ``SearchStats.merge``, so a per-request row
    slice would be meaningless): each request sees the dispatch's record,
    as with ``ShardedIndexSession``.
    """

    splits_stats = False

    def __init__(self, index, spec: SearchSpec):
        self.index = index
        self.spec = dataclasses.replace(spec, efs=max(spec.efs, spec.k))

    @property
    def dim(self) -> int:
        return self.index.dim

    def compile_count(self) -> int:
        # per-shard engines across snapshot generations + the (shared)
        # delta scans counted once
        return self.index.compile_count()

    def health(self) -> dict:
        idx = self.index
        quarantined = list(idx.quarantined_shards)
        return {"kind": "mutable-sharded", "n_live": int(idx.n_live),
                "n_shards": len(idx.shards),
                "epochs": [int(e) for e in idx.epochs],
                "quarantined_shards": quarantined,
                "degraded": bool(quarantined),
                "durable": any(sh._durable is not None for sh in idx.shards)}

    def sample_query(self) -> np.ndarray:
        g = self.index.shards[0]._state.snapshot.index.graph
        return np.asarray(g.vectors[0], np.float32)

    def search_padded(self, queries: np.ndarray, n_valid: int, k: int,
                      cos_theta: Optional[float]
                      ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        ids, dists, stats = self.index.search(
            queries, spec=self.spec.replace(k=k, cos_theta=cos_theta))
        return ids[:n_valid], dists[:n_valid], stats

    def stats_for_rows(self, stats: SearchStats, lo: int, hi: int
                       ) -> SearchStats:
        return stats


def make_session(index, spec: Optional[SearchSpec] = None):
    """Bind a port index to the serving protocol (dispatch on index type).

    Any other type raises ``TypeError``, a JAX package index among them
    (its engines are jitted JAX functions; serve it with ``repro.serve``).
    """
    from repro_torch.mutate.index import MutableAnnIndex
    from repro_torch.mutate.sharded import MutableShardedAnnIndex

    if isinstance(index, AnnIndex):
        return SingleIndexSession(index, spec or DEFAULT_SEARCH)
    if isinstance(index, ShardedAnnIndex):
        return ShardedIndexSession(index, spec or index.spec)
    if isinstance(index, MutableAnnIndex):
        return MutableIndexSession(index, spec or index.default_spec)
    if isinstance(index, MutableShardedAnnIndex):
        return MutableShardedIndexSession(index, spec or index.default_spec)
    raise TypeError(
        f"cannot serve {type(index).__module__}.{type(index).__name__}; "
        "expected repro_torch's AnnIndex, ShardedAnnIndex, MutableAnnIndex "
        "or MutableShardedAnnIndex")
