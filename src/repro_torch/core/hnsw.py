"""HNSW graph construction (Malkov & Yashunin) with CRouting bookkeeping.

A NumPy copy of ``repro.core.hnsw``: on the same input and seed it builds a
byte-identical graph (tests/test_torch_build.py holds it to that).

Construction is the offline path (DESIGN.md §3): sequential inserts with
BLAS-vectorized distance blocks.  Unlike stock hnswlib, the edge distances
computed during construction are *kept* — that is CRouting's only extra index
state (paper §4.1, "Acquisition of additional information").

Parameters follow the paper §5.1 defaults: M (neighbor limit, default 32),
efc (insertion candidate limit, default 256), maxM0 = 2·M at layer 0.
"""
from __future__ import annotations

import heapq
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import distances as D
from repro_torch.core.graph import GraphIndex, pad_adjacency


def _rank_block(q: np.ndarray, X: np.ndarray, metric: str) -> np.ndarray:
    if metric == "l2":
        d = X - q[None, :]
        return np.einsum("nd,nd->n", d, d)
    return 1.0 - X @ q


class _HnswBuilder:
    def __init__(self, dim: int, metric: str, m: int, efc: int, seed: int):
        self.dim = dim
        self.metric = metric
        self.m = m
        self.max_m = m
        self.max_m0 = 2 * m
        self.efc = efc
        self.ml = 1.0 / np.log(m)
        self.rng = np.random.default_rng(seed)
        self.vectors: Optional[np.ndarray] = None
        self.n = 0
        # adjacency per level: level -> list over nodes of (ids list, dists list)
        self.adj: List[dict] = []
        self.levels: List[int] = []
        self.entry = -1
        self.top = -1
        self.dist_calls = 0

    # -- distance helpers ----------------------------------------------------
    def _d1(self, q: np.ndarray, i: int) -> float:
        self.dist_calls += 1
        return float(_rank_block(q, self.vectors[i : i + 1], self.metric)[0])

    def _dblock(self, q: np.ndarray, ids: List[int]) -> np.ndarray:
        self.dist_calls += len(ids)
        return _rank_block(q, self.vectors[np.asarray(ids)], self.metric)

    # -- core search over the partial graph ----------------------------------
    def _greedy_level(self, q: np.ndarray, cur: int, d_cur: float, lvl: int):
        improved = True
        while improved:
            improved = False
            ids = self.adj[lvl].get(cur, ([], []))[0]
            if not ids:
                break
            ds = self._dblock(q, ids)
            j = int(np.argmin(ds))
            if ds[j] < d_cur:
                d_cur = float(ds[j])
                cur = ids[j]
                improved = True
        return cur, d_cur

    def _search_layer(self, q: np.ndarray, entry: int, d_entry: float,
                      ef: int, lvl: int) -> List[Tuple[float, int]]:
        visited = {entry}
        C = [(d_entry, entry)]
        T = [(-d_entry, entry)]
        while C:
            dc, c = heapq.heappop(C)
            if dc > -T[0][0] and len(T) >= ef:
                break
            ids = [i for i in self.adj[lvl].get(c, ([], []))[0] if i not in visited]
            if not ids:
                continue
            visited.update(ids)
            ds = self._dblock(q, ids)
            upper = -T[0][0]
            for d, i in zip(ds, ids):
                if d < upper or len(T) < ef:
                    heapq.heappush(C, (float(d), i))
                    heapq.heappush(T, (-float(d), i))
                    if len(T) > ef:
                        heapq.heappop(T)
                    upper = -T[0][0]
        return sorted((-d, i) for d, i in T)

    # -- hnswlib heuristic neighbor selection --------------------------------
    def _select_heuristic(self, cands: List[Tuple[float, int]], m: int):
        """Keep c iff dist(c, q) < dist(c, any already-selected)."""
        selected: List[Tuple[float, int]] = []
        if len(cands) <= m:
            return list(cands)
        cand_ids = np.asarray([i for _, i in cands])
        cvecs = self.vectors[cand_ids]
        # pairwise among candidates, one shot
        pw = D.pairwise_np(cvecs, cvecs, self.metric)
        self.dist_calls += len(cands) * (len(cands) - 1) // 2
        sel_pos: List[int] = []
        for pos, (dq, i) in enumerate(cands):
            if len(sel_pos) >= m:
                break
            if all(pw[pos, sp] > dq for sp in sel_pos):
                selected.append((dq, i))
                sel_pos.append(pos)
        return selected

    def _connect(self, a: int, b: int, dist: float, lvl: int):
        ids, ds = self.adj[lvl].setdefault(a, ([], []))
        ids.append(b)
        ds.append(dist)
        cap = self.max_m0 if lvl == 0 else self.max_m
        if len(ids) > cap:
            cands = sorted(zip(ds, ids))
            kept = self._select_heuristic(cands, cap)
            ids[:], ds[:] = [i for _, i in kept], [d for d, _ in kept]

    # -- insertion ------------------------------------------------------------
    def insert(self, idx: int):
        q = self.vectors[idx]
        l = int(-np.log(max(self.rng.random(), 1e-12)) * self.ml)
        self.levels.append(l)
        while len(self.adj) <= l:
            self.adj.append({})
        if self.entry < 0:
            self.entry, self.top = idx, l
            for lc in range(l + 1):
                self.adj[lc][idx] = ([], [])
            return
        cur = self.entry
        d_cur = self._d1(q, cur)
        for lc in range(self.top, l, -1):
            cur, d_cur = self._greedy_level(q, cur, d_cur, lc)
        for lc in range(min(l, self.top), -1, -1):
            cands = self._search_layer(q, cur, d_cur, self.efc, lc)
            selected = self._select_heuristic(cands, self.m)
            self.adj[lc].setdefault(idx, ([], []))
            for dq, s in selected:
                self._connect(idx, s, dq, lc)
                self._connect(s, idx, dq, lc)
            cur, d_cur = selected[0][1], selected[0][0]
        if l > self.top:
            self.top, self.entry = l, idx


def build_hnsw(
    base: np.ndarray,
    metric: str = "l2",
    m: int = 32,
    efc: int = 256,
    seed: int = 0,
    progress_every: int = 0,
) -> GraphIndex:
    """Build an HNSW index; returns the padded GraphIndex with stored edge dists."""
    base = D.preprocess_vectors(np.ascontiguousarray(base, dtype=np.float32), metric)
    n, dim = base.shape
    b = _HnswBuilder(dim, metric, m, efc, seed)
    b.vectors = base
    b.n = n
    t0 = time.time()
    for i in range(n):
        b.insert(i)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"hnsw insert {i+1}/{n} ({time.time()-t0:.1f}s)")
    build_secs = time.time() - t0

    norms = np.linalg.norm(base, axis=1).astype(np.float32)
    # layer-0 padded adjacency with *Euclidean* stored distances
    adj0 = b.adj[0]
    lists, dlists = [], []
    for i in range(n):
        ids, ds = adj0.get(i, ([], []))
        rank = np.asarray(ds, dtype=np.float32)
        if metric == "l2":
            eu = np.sqrt(np.maximum(rank, 0.0))
        else:
            eu = np.sqrt(np.maximum(norms[i] ** 2 + norms[np.asarray(ids, int)] ** 2
                                    + 2.0 * rank - 2.0, 0.0)) if len(ids) else rank
        lists.append(np.asarray(ids, dtype=np.int64))
        dlists.append(eu)
    nb, ed = pad_adjacency(lists, dlists, n, b.max_m0)

    upper_ids, upper_nbrs = [], []
    for lvl in range(len(b.adj) - 1, 0, -1):
        ids = np.asarray(sorted(b.adj[lvl].keys()), dtype=np.int64)
        mat = np.full((len(ids), b.max_m), n, dtype=np.int32)
        for j, node in enumerate(ids):
            a = b.adj[lvl][node][0][: b.max_m]
            mat[j, : len(a)] = a
        upper_ids.append(ids)
        upper_nbrs.append(mat)

    return GraphIndex(
        vectors=base, neighbors=nb, edge_eu_dist=ed, entry_point=b.entry,
        metric=metric, norms=norms, upper_ids=upper_ids or None,
        upper_neighbors=upper_nbrs or None, kind="hnsw",
        build_stats={"build_secs": build_secs, "dist_calls": b.dist_calls,
                     "m": m, "efc": efc, "levels": len(b.adj)},
    )
