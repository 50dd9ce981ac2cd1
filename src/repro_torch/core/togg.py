"""TOGG-KDT baseline (Xu et al., KBS'21) — two-stage routing with per-node
KD-trees for directional neighbor filtering.  A NumPy copy of
``repro.core.togg``, a host baseline as in the JAX package.

Stage S1 (far from query): at each expansion, descend the node's KD-tree
(built over its neighbors' vectors at construction) to the leaf containing the
query — only those direction-aligned neighbors are evaluated.  Stage S2 (near
the query, triggered when S1 stops improving): full greedy expansion with the
constraint relaxed to two-hop neighborhoods.

The accuracy loss from S1's hard filtering (paper Fig. 3: nodes like n3 are
unrecoverable) is the phenomenon the comparison reproduces.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import GraphIndex
from repro_torch.core.kdtree import KDTree, build_kdtree, descend
from repro_torch.core.ref_search import SearchStats, STATUS_VISITED


@dataclasses.dataclass
class ToggIndex:
    graph: GraphIndex
    trees: List[KDTree]
    build_secs: float = 0.0

    def extra_bytes(self) -> int:
        tot = 0
        for t in self.trees:
            tot += (t.axis.nbytes + t.thresh.nbytes + t.left.nbytes
                    + t.right.nbytes + t.leaf_start.nbytes + t.leaf_end.nbytes
                    + t.items.nbytes)
        return int(tot)


def build_togg(g: GraphIndex, leaf_size: int = 8) -> ToggIndex:
    t0 = time.time()
    n = g.n
    trees: List[KDTree] = []
    for i in range(n):
        nbrs = g.neighbors[i]
        ids = nbrs[nbrs < n].astype(np.int64)
        if len(ids) == 0:
            trees.append(build_kdtree(np.zeros((1, g.dim), np.float32),
                                      np.asarray([i]), leaf_size))
            continue
        trees.append(build_kdtree(g.vectors[ids], ids, leaf_size))
    return ToggIndex(graph=g, trees=trees, build_secs=time.time() - t0)


def togg_search(ti: ToggIndex, q: np.ndarray, entry: int, efs: int,
                max_hops: int = 10**9, s1_patience: int = 3,
                ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    g = ti.graph
    n = g.n
    vecs = g.vectors
    status = np.zeros(n, np.uint8)
    stats = SearchStats()

    def exact(i):
        stats.dist_calls += 1
        d = q - vecs[i]
        return float(np.dot(d, d))

    d0 = exact(entry)
    status[entry] = STATUS_VISITED
    C = [(d0, entry)]
    T = [(-d0, entry)]
    stage2 = False
    best_seen = d0
    stalls = 0

    while C and stats.hops < max_hops:
        dc, c = heapq.heappop(C)
        upper = -T[0][0]
        if dc > upper and len(T) >= efs:
            break
        stats.hops += 1

        if not stage2:
            cand_ids = [int(x) for x in descend(ti.trees[c], q)]  # S1: leaf only
        else:
            # S2: thorough near-query expansion. Full one-hop, plus two-hop
            # through the closest unvisited neighbor only (the unrestricted
            # two-hop of the original bloats distance calls at our scales).
            one_hop = [int(x) for x in g.neighbors[c] if x < n]
            cand_ids = list(one_hop)
            fresh = [h for h in one_hop if status[h] != STATUS_VISITED]
            if fresh:
                h0 = fresh[0]
                cand_ids.extend(int(x) for x in g.neighbors[h0] if x < n)

        improved = False
        for nid in cand_ids:
            if status[nid] == STATUS_VISITED:
                continue
            status[nid] = STATUS_VISITED
            dn = exact(nid)
            if dn < best_seen:
                best_seen = dn
                improved = True
            if dn < upper or len(T) < efs:
                heapq.heappush(C, (dn, nid))
                heapq.heappush(T, (-dn, nid))
                if len(T) > efs:
                    heapq.heappop(T)
                upper = -T[0][0]
        if not stage2:
            stalls = 0 if improved else stalls + 1
            if stalls >= s1_patience:
                stage2 = True   # switch to thorough near-query exploration

    out = sorted(((-d, i) for d, i in T))
    ids_out = np.full(efs, -1, np.int64)
    ds_out = np.full(efs, np.inf, np.float32)
    for j, (d, i) in enumerate(out[:efs]):
        ids_out[j] = i
        ds_out[j] = d
    return ids_out, ds_out, stats
