"""Faithful scalar reference of the paper's Algorithm 1 / Algorithm 2 (NumPy).

A NumPy copy of ``repro.core.ref_search``; the port needs it for the angle
profile (core/angles.py).  One difference: under ``ip`` and ``cosine`` the
recorded angles take |c - q| and |n - q| from the rows, where the JAX copy
converts the float32 ranks back (``_rank_to_eu``), which leaves ~1e-4 for
the 0 of a profile query's own row and so samples that row's expansion.
Under ``l2`` the samples are the JAX copy's, byte for byte.

This is the oracle the batched engine (core/search.py) is tested against:
two priority queues (candidate queue C, top-results queue T), per-node
visited/pruned status, exact distance-call counting, and optional angle
instrumentation (paper §3.3 / Fig. 7-8).

It is also the construction-time searcher for sequential HNSW insertion.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import GraphIndex

STATUS_UNVISITED = 0
STATUS_VISITED = 1
STATUS_PRUNED = 2


class SearchStats:
    __slots__ = ("dist_calls", "est_calls", "hops", "angles", "est_pairs",
                 "pruned_ids", "visited_ids")

    def __init__(self):
        self.dist_calls = 0     # exact distance evaluations (paper's "hops")
        self.est_calls = 0      # cosine-theorem estimates evaluated
        self.hops = 0           # node expansions
        self.angles: List[float] = []         # instrumented theta values
        self.est_pairs: List[Tuple[float, float]] = []  # (est_eu, true_eu)
        self.pruned_ids: set = set()
        self.visited_ids: set = set()


def _rank_dist(q, x, metric):
    if metric == "l2":
        d = q - x
        return float(np.dot(d, d))
    return float(1.0 - np.dot(q, x))


def _rank_to_eu(rank, nq, nx, metric):
    if metric == "l2":
        return float(np.sqrt(max(rank, 0.0)))
    return float(np.sqrt(max(nx * nx + nq * nq + 2.0 * rank - 2.0, 0.0)))


def _eu_to_rank(eu, nq, nx, metric):
    if metric == "l2":
        return eu * eu
    return (eu * eu - nx * nx - nq * nq + 2.0) / 2.0


def _eu_rows(q, x):
    """|q - x| from the rows, in float64."""
    diff = x.astype(np.float64) - q
    return float(np.sqrt(np.dot(diff, diff)))


def greedy_search_ref(
    g: GraphIndex,
    q: np.ndarray,
    entry: int,
    efs: int,
    router: Optional[str] = None,          # None | "triangle" | "crouting" | "crouting_o"
    cos_theta: float = 0.0,                # cos(theta*) for crouting
    record_angles: bool = False,
    record_est_error: bool = False,
    max_hops: int = 10**9,
    stale_bound: bool = False,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Algorithm 1 (router=None) / Algorithm 2 (router='crouting').

    Returns (ids[efs], rank_dists[efs]) sorted ascending, plus stats.
    ``crouting_o`` disables error correction: a pruned node is treated like a
    visited node on revisit (skipped), reproducing the paper's CRouting_O.
    ``stale_bound=True`` freezes the upper bound at expansion start (the
    batched engine's SPMD semantics) for exact-equivalence testing.
    """
    n = g.n
    metric = g.metric
    vecs = g.vectors
    norms = g.norms if g.norms is not None else None
    nq = float(np.linalg.norm(q)) if metric != "l2" else 1.0
    status = np.zeros(n, dtype=np.uint8)
    stats = SearchStats()

    def exact(i):
        stats.dist_calls += 1
        return _rank_dist(q, vecs[i], metric)

    d0 = exact(entry)
    status[entry] = STATUS_VISITED
    stats.visited_ids.add(entry)
    # C: min-heap of (dist, id); T: max-heap of (-dist, id)
    C = [(d0, entry)]
    T = [(-d0, entry)]

    while C and stats.hops < max_hops:
        dc, c = heapq.heappop(C)
        upper = -T[0][0]
        if dc > upper and len(T) >= efs:
            break
        stats.hops += 1
        nx_c = float(norms[c]) if norms is not None else 1.0
        d_cq_eu = _rank_to_eu(dc, nq, nx_c, metric)
        # the angles' lengths: under ip/cosine from the rows, since a float32
        # rank converted back leaves ~1e-4 where c is the query's own row
        d_cq_ang = (_eu_rows(q, vecs[c]) if record_angles and metric != "l2"
                    else d_cq_eu)
        frozen_upper = upper
        frozen_full = len(T) >= efs

        nbrs = g.neighbors[c]
        edists = g.edge_eu_dist[c]
        for slot in range(len(nbrs)):
            nid = int(nbrs[slot])
            if nid >= n:
                break
            st = status[nid]
            if st == STATUS_VISITED:
                continue
            d_cn_eu = float(edists[slot])
            pool_full = frozen_full if stale_bound else len(T) >= efs
            prune_bound = frozen_upper if stale_bound else upper

            if st == STATUS_PRUNED and router == "crouting_o":
                continue  # no error correction: pruned is final

            if (st == STATUS_UNVISITED and router is not None and pool_full):
                # --- pruning strategies -------------------------------------
                if router in ("crouting", "crouting_o"):
                    stats.est_calls += 1
                    est2 = (d_cn_eu * d_cn_eu + d_cq_eu * d_cq_eu
                            - 2.0 * d_cn_eu * d_cq_eu * cos_theta)
                    est_eu = np.sqrt(max(est2, 0.0))
                    nx_n = float(norms[nid]) if norms is not None else 1.0
                    est_rank = _eu_to_rank(est_eu, nq, nx_n, metric)
                    if record_est_error:
                        true_rank = _rank_dist(q, vecs[nid], metric)
                        true_eu = _rank_to_eu(true_rank, nq, nx_n, metric)
                        stats.est_pairs.append((est_eu, true_eu))
                    if est_rank >= prune_bound:
                        status[nid] = STATUS_PRUNED
                        stats.pruned_ids.add(nid)
                        continue
                elif router == "triangle":
                    # lower bound from the triangle inequality (paper §3.2);
                    # exact bound => safe to discard permanently.
                    lb_eu = abs(d_cn_eu - d_cq_eu)
                    nx_n = float(norms[nid]) if norms is not None else 1.0
                    lb_rank = _eu_to_rank(lb_eu, nq, nx_n, metric)
                    if lb_rank >= prune_bound:
                        status[nid] = STATUS_VISITED
                        stats.visited_ids.add(nid)
                        continue

            # --- exact-distance path (incl. error-corrected revisits) -------
            status[nid] = STATUS_VISITED
            stats.visited_ids.add(nid)
            dn = exact(nid)
            if (record_angles and np.isfinite(d_cn_eu) and d_cn_eu > 1e-9
                    and d_cq_ang > 1e-9):
                d_nq_eu = (_rank_to_eu(dn, nq, 1.0, metric) if metric == "l2"
                           else _eu_rows(q, vecs[nid]))
                cosv = (d_cq_ang**2 + d_cn_eu**2 - d_nq_eu**2) / (2.0 * d_cq_ang * d_cn_eu)
                stats.angles.append(float(np.arccos(np.clip(cosv, -1.0, 1.0))))
            if dn < upper or len(T) < efs:
                heapq.heappush(C, (dn, nid))
                heapq.heappush(T, (-dn, nid))
                if len(T) > efs:
                    heapq.heappop(T)
                upper = -T[0][0]

    out = sorted(((-d, i) for d, i in T))
    ids = np.full(efs, -1, dtype=np.int64)
    ds = np.full(efs, np.inf, dtype=np.float32)
    for j, (d, i) in enumerate(out[:efs]):
        ids[j] = i
        ds[j] = d
    return ids, ds, stats


def descend_hierarchy_ref(g: GraphIndex, q: np.ndarray) -> Tuple[int, int]:
    """HNSW upper-layer greedy 1-NN descent. Returns (entry_for_layer0, dist_calls)."""
    if not g.upper_neighbors:
        return g.entry_point, 0
    cur = g.entry_point
    calls = 1
    d_cur = _rank_dist(q, g.vectors[cur], g.metric)
    for lvl in range(len(g.upper_neighbors)):  # top..1
        ids = g.upper_ids[lvl]
        pos = {int(v): j for j, v in enumerate(ids)}
        improved = True
        while improved:
            improved = False
            j = pos.get(cur)
            if j is None:
                break
            for nid in g.upper_neighbors[lvl][j]:
                nid = int(nid)
                if nid >= g.n:
                    break
                d = _rank_dist(q, g.vectors[nid], g.metric)
                calls += 1
                if d < d_cur:
                    d_cur = d
                    cur = nid
                    improved = True
    return cur, calls


def search_ref(g: GraphIndex, q: np.ndarray, efs: int, k: int = 10, **kw):
    """Full query = hierarchy descent + layer-0 Algorithm 1/2 search."""
    entry, upper_calls = descend_hierarchy_ref(g, q)
    ids, ds, stats = greedy_search_ref(g, q, entry, efs, **kw)
    # greedy re-evaluates the entry distance the descent already computed;
    # count it once (hnswlib reuses the descent's value).
    stats.dist_calls += max(0, upper_calls - 1)
    return ids[:k], ds[:k], stats
