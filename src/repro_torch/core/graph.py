"""Graph-index container shared by the HNSW and K-NN graph builders.

A NumPy copy of ``repro.core.graph`` (the port imports nothing of the JAX
package).  Adjacency is a padded int32 ``[N, M]`` matrix (pad = N sentinel)
with a parallel ``[N, M]`` float32 matrix of *Euclidean* edge distances —
the extra state CRouting keeps from construction.  ``core/search.py``
copies both to the device with one pad row appended.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class GraphIndex:
    """Layer-0 search graph + optional HNSW upper layers."""

    vectors: np.ndarray          # [N, d] float32 (normalized when metric=cosine)
    neighbors: np.ndarray        # [N, M] int32, pad = N
    edge_eu_dist: np.ndarray     # [N, M] float32 Euclidean dist c->n, pad = +inf
    entry_point: int
    metric: str = "l2"
    norms: Optional[np.ndarray] = None   # [N] float32, required for ip/cosine
    # HNSW hierarchy: per upper layer (top..1), node ids and their adjacency
    # *into global id space*; empty for flat graphs (NSG / KNN).
    upper_ids: Optional[List[np.ndarray]] = None       # each [n_l] int64
    upper_neighbors: Optional[List[np.ndarray]] = None  # each [n_l, M_up] int32 global ids, pad = N
    # Provenance / bookkeeping.
    kind: str = "flat"
    build_stats: Optional[dict] = None

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    def memory_bytes(self, with_edge_dist: bool = True) -> dict:
        """Index-size accounting (paper Table 7): vectors + graph + mem_dist."""
        out = {
            "vectors": int(self.vectors.nbytes),
            "graph": int(self.neighbors.nbytes),
            "mem_dist": int(self.edge_eu_dist.nbytes) if with_edge_dist else 0,
        }
        if self.upper_neighbors:
            out["graph"] += int(sum(a.nbytes for a in self.upper_neighbors))
        if self.norms is not None:
            out["norms"] = int(self.norms.nbytes)
        out["total"] = sum(v for k, v in out.items() if k != "total")
        return out


def pad_adjacency(adj_lists: List[np.ndarray], dists: List[np.ndarray],
                  n: int, max_degree: int):
    """Lists-of-neighbors -> padded [N, M] matrices (pad id = n, pad dist = inf)."""
    nb = np.full((n, max_degree), n, dtype=np.int32)
    ed = np.full((n, max_degree), np.inf, dtype=np.float32)
    for i, (a, d) in enumerate(zip(adj_lists, dists)):
        m = min(len(a), max_degree)
        nb[i, :m] = a[:m]
        ed[i, :m] = d[:m]
    return nb, ed


def validate_graph(g: GraphIndex, check_dists: bool = True, atol: float = 1e-3):
    """Structural invariants used by property tests."""
    n = g.n
    assert g.neighbors.shape == g.edge_eu_dist.shape
    assert g.neighbors.dtype == np.int32
    valid = g.neighbors < n
    assert (g.neighbors[valid] >= 0).all()
    assert np.isinf(g.edge_eu_dist[~valid]).all(), "pad slots must be +inf"
    if check_dists and n <= 20_000:
        # spot-check stored edge distances against recomputation
        rng = np.random.default_rng(0)
        rows = rng.integers(0, n, size=min(64, n))
        for i in rows:
            nbrs = g.neighbors[i][g.neighbors[i] < n]
            if len(nbrs) == 0:
                continue
            d = np.linalg.norm(g.vectors[nbrs] - g.vectors[i], axis=1)
            s = g.edge_eu_dist[i][: len(nbrs)]
            assert np.allclose(d, s, atol=atol, rtol=1e-3), (i, d[:4], s[:4])
