"""Minimal KD-tree used by the TOGG baseline (per-node trees over neighbors).

A NumPy copy of ``repro.core.kdtree``.

Array-encoded balanced KD-tree: median splits on the max-spread axis.  Only
``descend`` (leaf lookup, O(depth) scalar comparisons — no full-vector
distance calls) is needed by TOGG's stage-S1 directional filtering.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class KDTree:
    # internal nodes: split axis + threshold; negative axis => leaf
    axis: np.ndarray        # [n_nodes] int32 (-1 = leaf)
    thresh: np.ndarray      # [n_nodes] float32
    left: np.ndarray        # [n_nodes] int32 child index
    right: np.ndarray       # [n_nodes] int32
    leaf_start: np.ndarray  # [n_nodes] int32 into `items`
    leaf_end: np.ndarray    # [n_nodes] int32
    items: np.ndarray       # [n_points] int32 (permutation of input ids)


def build_kdtree(points: np.ndarray, ids: np.ndarray, leaf_size: int = 8) -> KDTree:
    axis: List[int] = []
    thresh: List[float] = []
    left: List[int] = []
    right: List[int] = []
    ls: List[int] = []
    le: List[int] = []
    items: List[int] = []

    def rec(idx: np.ndarray) -> int:
        node = len(axis)
        axis.append(-1); thresh.append(0.0); left.append(-1); right.append(-1)
        ls.append(-1); le.append(-1)
        if len(idx) <= leaf_size:
            ls[node] = len(items)
            items.extend(int(ids[i]) for i in idx)
            le[node] = len(items)
            return node
        pts = points[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        med = float(np.median(pts[:, ax]))
        lo = idx[pts[:, ax] <= med]
        hi = idx[pts[:, ax] > med]
        if len(lo) == 0 or len(hi) == 0:     # degenerate split -> leaf
            ls[node] = len(items)
            items.extend(int(ids[i]) for i in idx)
            le[node] = len(items)
            return node
        axis[node] = ax
        thresh[node] = med
        left[node] = rec(lo)
        right[node] = rec(hi)
        return node

    rec(np.arange(len(ids)))
    return KDTree(axis=np.asarray(axis, np.int32), thresh=np.asarray(thresh, np.float32),
                  left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
                  leaf_start=np.asarray(ls, np.int32), leaf_end=np.asarray(le, np.int32),
                  items=np.asarray(items, np.int32))


def descend(tree: KDTree, q: np.ndarray) -> np.ndarray:
    """Walk to the leaf containing q; return member ids (no distance calls)."""
    node = 0
    while tree.axis[node] >= 0:
        node = int(tree.left[node] if q[tree.axis[node]] <= tree.thresh[node]
                   else tree.right[node])
    return tree.items[tree.leaf_start[node]: tree.leaf_end[node]]
