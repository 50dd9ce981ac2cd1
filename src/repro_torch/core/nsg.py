"""NSG construction (Fu et al., VLDB'19) with CRouting bookkeeping.

The counterpart of ``repro.core.nsg``; on the same base it builds the same
graph.  Pipeline:
  1. exact K-NN graph on the device (``core/knn_graph.py``);
  2. medoid = navigating node;
  3. per node p: candidate pool = search(p, on the K-NN graph, pool C),
     batched through the port's engine (``build_search_fn``; the spec's
     engine defaults to ``fused``, so the ``fused_expand`` and
     ``pool_merge`` kernels run it on the card);
  4. the pool united with p's K-NN list (host NumPy, per node, as in the
     reference), then MRNG edge selection over the candidates in (rank, id)
     order: keep c iff no kept s has dist(c, s) < dist(c, p), stopping at
     R.  The reference's per-node Python double loop is tensor code here
     (``mrng_select``): a block of nodes at a time, one step per candidate
     position over a ``[nodes, C]`` kept mask, the pairwise distances of
     each node's candidates as one batched fp32 ``torch.bmm`` (a plain
     product outside any kernel, TF32 off) in ``pairwise_np``'s form.
     ``_mrng_select`` is the NumPy copy of the reference's loop, the plain
     version the tests hold it against;
  5. grow a spanning tree from the medoid to guarantee connectivity (host
     NumPy): each node the kept edges do not reach, in id order, gets an
     in-edge from its nearest node reachable so far.  The reference copies
     the reachable rows and takes one orphan's distances to them at a
     time, and on clustered data most nodes are orphans; here a block of
     orphans' distances to every row is one product, the columns not yet
     reachable masked.  The same targets, but the lengths of these edges
     round differently (within 1e-5 on the tests' data).

Defaults follow the paper §5.1: R=70 (degree), C=500 (candidates), L=60
(search pool).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.graph import GraphIndex, pad_adjacency
from repro_torch.core.knn_graph import build_knn_graph
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec
from repro_torch.device import DeviceLike, resolve_device

# elements of one block's [nodes, C, C] pairwise matrix (1 GiB of fp32)
MRNG_PW_ELEMENTS = 2 ** 28
# elements of one block of orphans' distance rows (128 MiB of fp32)
ORPHAN_ROW_ELEMENTS = 2 ** 25


def _mrng_select(p: int, cand_ids: np.ndarray, cand_rank: np.ndarray,
                 base: np.ndarray, metric: str, r: int):
    """MRNG pruning, the NumPy copy of the reference's loop: candidates in
    ascending distance; keep c iff for all already-kept s:
    dist(c, s) >= dist(c, p)."""
    order = np.argsort(cand_rank, kind="stable")
    cand_ids, cand_rank = cand_ids[order], cand_rank[order]
    cvecs = base[cand_ids]
    pw = D.pairwise_np(cvecs, cvecs, metric)
    kept: List[int] = []
    kept_rank: List[float] = []
    for pos in range(len(cand_ids)):
        if len(kept) >= r:
            break
        ok = True
        for kpos in kept:
            if pw[pos, kpos] < cand_rank[pos]:
                ok = False
                break
        if ok:
            kept.append(pos)
            kept_rank.append(float(cand_rank[pos]))
    return cand_ids[kept], np.asarray(kept_rank, np.float32)


def candidate_pool(p: int, ids: np.ndarray, rank: np.ndarray,
                   knn_row: np.ndarray, base: np.ndarray, metric: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Node ``p``'s search pool (``ids``/``rank``, pad id n) united with its
    K-NN list: ids unique (a search hit keeps its search rank), in (rank,
    id) order."""
    n = base.shape[0]
    mask = (ids != p) & (ids < n)
    kn = knn_row[knn_row < n].astype(np.int64)
    kn_rank = D.pairwise_np(base[p: p + 1], base[kn], metric)[0]
    ids = np.concatenate([ids[mask], kn])
    rank = np.concatenate([rank[mask], kn_rank])
    ids, uniq = np.unique(ids, return_index=True)
    rank = rank[uniq]
    order = np.argsort(rank, kind="stable")
    return ids[order], rank[order]


def pack_pools(pools: List[Tuple[np.ndarray, np.ndarray]], n: int):
    """Per-node pools -> padded ``[nodes, C]`` ids (pad n, int64) and ranks
    (pad +inf, float32)."""
    width = max(len(ids) for ids, _ in pools)
    ids = np.full((len(pools), width), n, np.int64)
    rank = np.full((len(pools), width), np.inf, np.float32)
    for i, (a, r) in enumerate(pools):
        ids[i, : len(a)] = a
        rank[i, : len(r)] = r
    return ids, rank


def mrng_select(cand_ids: torch.Tensor, cand_rank: torch.Tensor,
                vecs: torch.Tensor, metric: str, r: int) -> torch.Tensor:
    """MRNG selection for a block of nodes at once.

    ``cand_ids`` [nodes, C] int64 (each row in (rank, id) order, pad = n,
    the zero row of ``vecs`` [n+1, d]), ``cand_rank`` [nodes, C] f32 (pad
    +inf).  Returns the kept mask [nodes, C]: position c is kept iff no
    kept position s < c has ``pw[c, s] < rank[c]`` and fewer than ``r``
    are kept before it, as ``_mrng_select`` decides.  ``pw`` is
    ``pairwise_np``'s form, ``max(|c|^2 + |s|^2 - 2 c.s, 0)`` (l2) or
    ``1 - c.s``.
    """
    n = vecs.shape[0] - 1
    X = vecs[cand_ids]                                   # [nodes, C, d]
    dots = torch.bmm(X, X.transpose(1, 2))               # [nodes, C, C]
    if metric == "l2":
        sq = torch.sum(X * X, dim=-1)
        pw = torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2.0 * dots,
                             0.0)
    else:
        pw = 1.0 - dots
    del X, dots
    valid = cand_ids < n
    kept = torch.zeros_like(valid)
    count = torch.zeros(valid.shape[0], dtype=torch.int32,
                        device=valid.device)
    # valid lanes come first in every row: no row has a candidate past
    # the longest row's count
    for pos in range(int(valid.sum(1).max())):
        blocked = (kept[:, :pos] & (pw[:, pos, :pos]
                                    < cand_rank[:, pos: pos + 1])).any(1)
        ok = valid[:, pos] & ~blocked & (count < r)
        kept[:, pos] = ok
        count += ok
    return kept


def acquisition_spec(search_spec: SearchSpec, pool: int,
                     metric: str) -> SearchSpec:
    """Step 3's search spec: ``search_spec`` with the construction's
    pool-shaping overrides (efs = pool, max_hops = 4 * pool, no hierarchy,
    the beam clamped to the pool)."""
    return dataclasses.replace(
        search_spec, efs=pool, metric=metric, max_hops=4 * pool,
        use_hierarchy=False,
        beam_width=max(1, min(search_spec.beam_width, pool)))


def acquire_candidates(knn: GraphIndex, queries: np.ndarray, cfg: SearchSpec,
                       batch_size: int, device: DeviceLike = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Step 3: search each row of ``queries`` on the K-NN graph under
    ``cfg``, ``batch_size`` rows a batch; returns the pools' ids (int64, pad
    n) and ranking distances [len(queries), cfg.efs] on the host."""
    _, fn = build_search_fn(knn, cfg, device=device)
    ids = np.empty((len(queries), cfg.efs), np.int64)
    rank = np.empty((len(queries), cfg.efs), np.float32)
    for s in range(0, len(queries), batch_size):
        res = fn(queries[s: s + batch_size], 0.0)
        ids[s: s + batch_size] = res.ids.cpu().numpy()
        rank[s: s + batch_size] = res.dists.cpu().numpy()
    return ids, rank


def build_nsg(base: np.ndarray, metric: str = "l2", r: int = 70, c: int = 500,
              l: int = 60, knn_k: int = 64, seed: int = 0,
              search_batch_size: int = 512, beam_width: int = 4,
              estimate: str = "exact",
              search_spec: Optional[SearchSpec] = None,
              device: DeviceLike = None) -> GraphIndex:
    """Construct an NSG on ``device`` (the K-NN graph, the candidate
    acquisition and the MRNG selection; the union and the spanning tree run
    on the host).  ``search_spec`` configures the candidate-acquisition
    searches (router/engine/beam/estimate); its pool-shaping fields (efs,
    max_hops, metric, hierarchy) are overridden by the construction
    requirements.  ``beam_width``/``estimate`` remain as shorthand for the
    common knobs when no spec is given.  ``build_stats`` carries the
    reference's keys plus the seconds of each step.
    """
    dev = resolve_device(device)
    t0 = time.time()
    base = D.preprocess_vectors(np.ascontiguousarray(base, np.float32), metric)
    n = base.shape[0]
    knn = build_knn_graph(base, k=knn_k, metric=metric, device=dev)
    norms = knn.norms
    medoid = knn.entry_point
    t1 = time.time()

    # --- step 3: batched candidate acquisition on the KNN graph -------------
    pool = max(l, min(c, n - 1))
    if search_spec is None:
        search_spec = SearchSpec(router="none", beam_width=beam_width,
                                 estimate=estimate)
    cand_ids, cand_rank = acquire_candidates(
        knn, base, acquisition_spec(search_spec, pool, metric),
        search_batch_size, dev)
    t2 = time.time()

    # --- step 4: union with the KNN list, then MRNG selection ---------------
    vecs = torch.as_tensor(np.concatenate([base, np.zeros((1, base.shape[1]),
                                                          np.float32)]),
                           device=dev)
    width = pool + knn_k
    block = max(1, MRNG_PW_ELEMENTS // (width * width))
    adj: List[np.ndarray] = [None] * n
    dists: List[np.ndarray] = [None] * n
    for s in range(0, n, block):
        nodes = range(s, min(s + block, n))
        ids, rank = pack_pools([candidate_pool(
            p, cand_ids[p], cand_rank[p], knn.neighbors[p], base, metric)
            for p in nodes], n)
        kept = mrng_select(torch.as_tensor(ids, device=dev),
                           torch.as_tensor(rank, device=dev), vecs, metric,
                           r).cpu().numpy()
        for i, p in enumerate(nodes):
            adj[p] = ids[i, kept[i]]
            dists[p] = D.rank_to_eu_np(rank[i, kept[i]], norms[p],
                                       norms[adj[p]], metric)
    del vecs
    t3 = time.time()

    # --- step 5: connectivity (spanning tree from medoid) -------------------
    seen = np.zeros(n, bool)
    stack = [medoid]
    seen[medoid] = True
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    # attach each orphan, in id order, to its nearest node reachable so far
    # (earlier orphans included).  The reference computes one orphan's row
    # against the reachable rows at a time; here a block of orphans' rows
    # against every row is one product, and the columns not yet reachable
    # are masked (an attached orphan's column opens for the rows after it)
    orphans = np.nonzero(~seen)[0]
    step = max(1, ORPHAN_ROW_ELEMENTS // n)
    for s in range(0, len(orphans), step):
        block = orphans[s: s + step]
        dd = D.pairwise_np(base[block], base, metric)
        masked = np.where(seen[None, :], dd, np.inf)
        for i, p in enumerate(block):
            tgt = int(np.argmin(masked[i]))
            eu = D.rank_to_eu_np(np.asarray([masked[i, tgt]]), norms[tgt],
                                 norms[p: p + 1], metric)[0]
            adj[tgt] = np.concatenate([adj[tgt], [p]])
            dists[tgt] = np.concatenate([dists[tgt], [eu]])
            seen[p] = True
            masked[i + 1:, p] = dd[i + 1:, p]
    n_orphans = len(orphans)

    max_deg = max(len(a) for a in adj)
    nb, ed = pad_adjacency(adj, dists, n, max(max_deg, r))
    t4 = time.time()
    return GraphIndex(vectors=base, neighbors=nb, edge_eu_dist=ed,
                      entry_point=medoid, metric=metric, norms=norms,
                      kind="nsg",
                      build_stats={"build_secs": t4 - t0, "r": r, "c": c,
                                   "l": l, "knn_k": knn_k,
                                   "orphans": n_orphans,
                                   "knn_secs": t1 - t0,
                                   "acquire_secs": t2 - t1,
                                   "mrng_secs": t3 - t2,
                                   "tree_secs": t4 - t3})
