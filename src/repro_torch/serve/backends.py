"""Engine-session adapters: one serving interface over the port's indexes.

The counterpart of ``repro.serve.backends``.  The frontend speaks one
protocol — ``search_padded(q, n_valid, k, cos_theta)`` plus a first-use
counter (``compile_count``) — and these adapters bind it to the engines:

* ``SingleIndexSession`` — ``AnnIndex`` over the engine cache of
  ``repro_torch.core.search`` (one ``SearchEngine`` per canonical spec).
  The session holds its engine and searches through it
  (``AnnIndex.search_on``), so the cache's eviction cannot set it up again
  behind the count.  Stats are per-query arrays, so a dispatch's stats slice exactly per
  request.
* ``MutableIndexSession`` — ``MutableAnnIndex`` (delta + tombstones +
  background merge, DESIGN.md §9).  The session does NOT pin a graph or an
  engine: every dispatch resolves the index's current snapshot, so a
  concurrent merge swap is invisible to the request path.  Warmup notes
  each bucket shape with the index (``note_shape``), merges pre-warm those
  shapes on the fresh graph before swapping, and ``compile_count`` folds
  retired + pre-warmed engines — so ``recompiles_after_warmup`` stays 0
  across snapshot swaps.

The JAX package's two sharded sessions are not ported yet (the port has
no sharded index); ``make_session`` names them in its ``TypeError``.

``compile_count`` counts *first-use events* (``SearchEngine.first_uses``:
an engine's setup, each batch shape it first runs, each kernel library
its calls first load; plus, for a mutable index, each first delta-scan
shape), the one-time work the JAX package's count of XLA executables
stands for.  Request-only fields (``k``/``cos_theta``) never add one, so
after warmup a session's count moves only if a request paid such work.
``k`` is capped at the session's ``efs``: a larger ``k`` would widen the
result pool, a new engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.index import DEFAULT_SEARCH, AnnIndex
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec, SearchStats

# the JAX package's index types this port has no session for yet
_NOT_YET_PORTED = ("ShardedAnnIndex", "MutableShardedAnnIndex")


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
        s = slice(lo, hi)
        return dataclasses.replace(
            stats, dist_calls=stats.dist_calls[s], est_calls=stats.est_calls[s],
            rerank_calls=stats.rerank_calls[s], sq8_calls=stats.sq8_calls[s],
            hops=stats.hops[s],
            extra={kk: v[s] for kk, v in stats.extra.items()})


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


def make_session(index, spec: Optional[SearchSpec] = None):
    """Bind a port index to the serving protocol (dispatch on index type).

    Any other type raises ``TypeError``: a JAX package index among them
    (its engines are jitted JAX functions; serve it with ``repro.serve``),
    and the sharded indexes, which the port does not have yet.
    """
    from repro_torch.mutate.index import MutableAnnIndex

    if isinstance(index, AnnIndex):
        return SingleIndexSession(index, spec or DEFAULT_SEARCH)
    if isinstance(index, MutableAnnIndex):
        return MutableIndexSession(index, spec or index.default_spec)
    name = type(index).__name__
    if name in _NOT_YET_PORTED:
        raise TypeError(
            f"cannot serve {name}: sharded indexes are not yet ported to "
            "repro_torch (ShardedIndexSession and MutableShardedIndexSession "
            "come with the sharded index)")
    raise TypeError(
        f"cannot serve {type(index).__module__}.{name}; expected "
        "repro_torch's AnnIndex or MutableAnnIndex")
