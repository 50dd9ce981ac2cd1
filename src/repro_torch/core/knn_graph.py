"""Exact K-NN graph construction via blocked brute force on the device.

The counterpart of ``repro.core.knn_graph``.  Each block of rows is one
fp32 ``torch.matmul`` distance matrix (the metric's matmul form, TF32 off)
plus ``torch.topk``: a plain large product outside any kernel, as the JAX
package leaves it to XLA.  The per-row Python loop of the JAX version
is tensor code here; at 1M rows a Python loop would cost minutes.

Tie order follows ``lax.top_k``: among equal distances the lower index
comes first.  ``torch.topk`` promises no order among ties, so it selects
``k+1+TIE_MARGIN`` candidates, which are re-sorted stably by (distance, id)
before the first ``k+1`` are kept.  Only a run of more than ``TIE_MARGIN``
exactly equal distances at the boundary could still pick other members
than XLA does.

The device seconds of the blocks' products (``met.pairwise``) and of their
selection (``topk``, the two stable sorts, the self drop and the gathers)
add to the totals ``knn.product_s`` and ``knn.select_s`` of
``repro_torch.trace``, timed by CUDA events read after the final copy to
the host (on the CPU, by the host clock).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import distances as D
from repro_torch.core.graph import GraphIndex
from repro_torch.device import DeviceLike, resolve_device

TIE_MARGIN = 8


def _sort_by_dist_then_id(dist: torch.Tensor, idx: torch.Tensor):
    """Stable lexicographic (dist, id) order of each row."""
    o = torch.sort(idx, dim=1, stable=True).indices
    dist, idx = dist.gather(1, o), idx.gather(1, o)
    o = torch.sort(dist, dim=1, stable=True).indices
    return dist.gather(1, o), idx.gather(1, o)


def build_knn_graph(base: np.ndarray, k: int = 32, metric: str = "l2",
                    block: int = 1024, device: DeviceLike = None) -> GraphIndex:
    """Exact K-NN graph of ``base``; self is dropped from each row."""
    dev = resolve_device(device)
    base = D.preprocess_vectors(np.ascontiguousarray(base, np.float32), metric)
    n = base.shape[0]
    if not 0 < k < n:
        raise ValueError(f"build_knn_graph: need 0 < k < n, got k={k}, n={n}")
    met = D.get_metric(metric)
    xb = torch.as_tensor(base, device=dev)
    norms = np.linalg.norm(base, axis=1).astype(np.float32)
    norms_t = torch.as_tensor(norms, device=dev)
    nb = torch.empty((n, k), dtype=torch.int32, device=dev)
    ed = torch.empty((n, k), dtype=torch.float32, device=dev)
    kk = k + 1
    watch = trace.Stopwatch(dev)
    for s in range(0, n, block):
        q = xb[s: s + block]
        rows = torch.arange(s, s + q.shape[0], device=dev)
        t0 = watch.mark()
        dmat = met.pairwise(q, xb)
        t1 = watch.mark()
        dvals, idx = torch.topk(dmat, min(kk + TIE_MARGIN, n), dim=1,
                                largest=False, sorted=False)
        del dmat
        dvals, idx = _sort_by_dist_then_id(dvals, idx)
        dvals, idx = dvals[:, :kk], idx[:, :kk]
        # drop the self lane; a row whose k+1 nearest miss self drops its
        # last lane instead (the JAX version keeps the first k non-self)
        drop = idx == rows[:, None]
        drop[:, -1] |= ~drop.any(dim=1)
        keep = torch.sort(drop.to(torch.int8), dim=1, stable=True).indices[:, :k]
        ids = idx.gather(1, keep)
        rank = dvals.gather(1, keep)
        watch.lap("knn.product_s", t0, t1)
        watch.lap("knn.select_s", t1, watch.mark())
        if metric == "l2":
            eu = torch.sqrt(torch.clamp_min(rank, 0.0))
        else:
            na = norms_t[rows][:, None]
            nbn = norms_t[ids]
            eu = torch.sqrt(torch.clamp_min(
                na * na + nbn * nbn + 2.0 * rank - 2.0, 0.0))
        nb[s: s + q.shape[0]] = ids.to(torch.int32)
        ed[s: s + q.shape[0]] = eu
    # entry = medoid (node nearest to the dataset centroid), NumPy as in
    # the JAX package
    centroid = base.mean(axis=0, keepdims=True)
    entry = int(np.argmin(D.pairwise_np(centroid, base, metric)[0]))
    neighbors, edges = nb.cpu().numpy(), ed.cpu().numpy()
    watch.commit()              # the copies waited for every block
    return GraphIndex(vectors=base, neighbors=neighbors, edge_eu_dist=edges,
                      entry_point=entry, metric=metric, norms=norms,
                      kind="knn", build_stats={"k": k})
