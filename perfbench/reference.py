"""The plain reference that the benchmark judges the program by.

Plain PyTorch and NumPy.  Nothing here imports the program, the JAX
package or JAX, and nothing takes a table the program made: from the
benchmark's own vectors it works out again what the program's set-up
derives.

Every distance is taken under the configuration's ``metric`` (one of
``METRICS``), as the paper's Eq. 4 defines the ranks: the squared L2
distance (``l2``), ``1 - <q, x>`` (``ip``), and the same on rows normalised
in float64 (``cosine``; ``rows_in`` normalises).  A search keeps its pool
in ranks; the CRouting estimate lives in Euclidean space and reaches it
through ``rank_to_eu2`` and ``eu2_to_rank`` with the rows' norms.

* ``nearest``: exact nearest base rows of given vectors by rank, ties by
  the lower id (the K-NN graph's rows, with the row itself left out, and
  the ground truth);
* ``medoid``: the row of least rank to the centroid, the K-NN graph's
  entry point;
* ``edge_lengths``: the Euclidean length of every edge of a graph, from
  the rows;
* ``profile_angles``: the paper's angle profile (section 4.1): best-first
  search (Algorithm 1) of each profile query in rank order, the angle
  between c->q and c->n by the cosine theorem on the Euclidean lengths at
  every exact distance from an expanded node c;
* ``sq8_tables``: the SQ8 grid (per-dimension min/max over the base rows,
  255 steps, an error radius of half a step) and the codes;
* ``search``: the batched beam search: W best unexpanded pool entries
  expanded an iteration; with the router ``crouting`` the CRouting prune
  on the best slot's lanes (``beam_prune="best"``) or on every slot's
  (``"all"``) and the paper's error correction, with ``none`` no prune;
  with ``estimate="sq8"`` or ``"both"`` the SQ8 stage 1 and the exact
  stage 2.

``precision`` is ``"fp64"`` for the reference.  ``"low"`` is the control:
the same computations a step below the configuration's float32: products
of TF32 operands (the K-NN rows) and bf16 vectors (every distance), under
the same metric.
"""
from __future__ import annotations

import heapq
from typing import Dict, NamedTuple

import numpy as np
import torch

UNVISITED, VISITED, PRUNED = 0, 1, 2
METRICS = ("l2", "ip", "cosine")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 operands rounded to TF32's 10 mantissa bits, as the tensor
    cores read them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _metric_rows(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Vectors as the metric takes them: under ``cosine`` normalised in
    float64, as they stand otherwise."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; the reference "
                         f"computes under {METRICS}")
    if metric != "cosine":
        return x
    x = x.double()
    return x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True),
                               1e-12)


def rows_in(x: torch.Tensor, precision: str, metric: str) -> torch.Tensor:
    """Vectors as a precision computes distances on them under a metric."""
    x = _metric_rows(x, metric)
    if precision == "fp64":
        return x.double()
    if precision == "low":
        return x.to(torch.bfloat16).float()
    raise ValueError(f"unknown precision {precision!r}")


def _products_in(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.double() if precision == "fp64" else _tf32(x)


def nearest(base: torch.Tensor, x: torch.Tensor, k: int, precision: str,
            metric: str, self_rows: torch.Tensor = None, block: int = 256):
    """Ids [R, k] int64 and ranks [R, k] of the k base rows nearest each
    row of ``x`` under ``metric``, ties by the lower id; ``self_rows`` [R]
    leaves each row's own id out."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xb = _products_in(_metric_rows(base, metric), precision)
        x = _metric_rows(x, metric)
        bn = (xb * xb).sum(1) if metric == "l2" else None
        ids, d2 = [], []
        for s in range(0, x.shape[0], block):
            q = _products_in(x[s: s + block], precision)
            if metric == "l2":
                d = ((q * q).sum(1, keepdim=True) + bn[None, :]
                     - 2.0 * (q @ xb.T))
            else:
                d = 1.0 - q @ xb.T
            if self_rows is not None:
                d[torch.arange(q.shape[0], device=d.device),
                  self_rows[s: s + block]] = float("inf")
            dv, iv = torch.topk(d, min(k + 8, d.shape[1]), dim=1,
                                largest=False)
            o = torch.sort(iv, dim=1, stable=True).indices
            dv, iv = dv.gather(1, o), iv.gather(1, o)
            o = torch.sort(dv, dim=1, stable=True).indices[:, :k]
            ids.append(iv.gather(1, o))
            d2.append(dv.gather(1, o))
        return torch.cat(ids), torch.cat(d2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def knn_graph(base: torch.Tensor, k: int, precision: str, metric: str,
              block: int = 1024):
    """A whole K-NN graph: neighbour ids [n, k] and edge lengths [n, k]
    (under ``l2`` the square root of the squared distance the selection
    used; under the others the Euclidean lengths from the rows the
    products took)."""
    n = base.shape[0]
    ids, r = nearest(base, base, k, precision, metric,
                     torch.arange(n, device=base.device), block)
    if metric == "l2":
        return ids, torch.sqrt(torch.clamp_min(r, 0.0)).float()
    return ids, edge_lengths(
        _products_in(_metric_rows(base, metric), precision), ids).float()


def medoid(base: torch.Tensor, precision: str, metric: str) -> int:
    """The row of least rank to the centroid of the rows, ties by the
    lower id."""
    x = rows_in(base, precision, metric)
    c = x.mean(0, keepdim=True)
    if metric == "l2":
        return int(torch.argmin(((x - c) ** 2).sum(1)))
    return int(torch.argmin(rank(c, x[None], metric)[0]))


def sq_dist(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q [B, d], rows [B, L, d] -> squared L2 [B, L]."""
    diff = rows - q[:, None, :]
    return (diff * diff).sum(-1)


def rank(q: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    """q [B, d], rows [B, L, d] -> ranks [B, L]: the squared L2 distance,
    or ``1 - <q, x>`` (``ip``; ``cosine`` on normalised rows)."""
    if metric == "l2":
        return sq_dist(q, rows)
    return 1.0 - torch.einsum("bld,bd->bl", rows, q)


def rank_to_eu2(r, nq, nx, metric: str):
    """A rank as the squared Euclidean distance (paper Eq. 4), with the
    norms |q| and |x| of its two rows."""
    if metric == "l2":
        return r
    return nq * nq + nx * nx + 2.0 * r - 2.0


def eu2_to_rank(eu2, nq, nx, metric: str):
    """The inverse of ``rank_to_eu2``."""
    if metric == "l2":
        return eu2
    return (eu2 - nq * nq - nx * nx + 2.0) / 2.0


def edge_lengths(x: torch.Tensor, nbrs: torch.Tensor,
                 block: int = 4096) -> torch.Tensor:
    """|x_i - x_j| for every edge (i, j) of ``nbrs`` [n, M], in x's dtype."""
    out = torch.empty(nbrs.shape, dtype=x.dtype, device=x.device)
    for s in range(0, nbrs.shape[0], block):
        nb = nbrs[s: s + block]
        out[s: s + block] = torch.sqrt(sq_dist(x[s: s + nb.shape[0]], x[nb]))
    return out


def _rank_np(q: np.ndarray, rows: np.ndarray, metric: str) -> np.ndarray:
    if metric == "l2":
        return ((rows - q) ** 2).sum(-1)
    return 1.0 - rows @ q


def profile_angles(x: np.ndarray, nbrs: np.ndarray, entry: int,
                   queries: np.ndarray, efs: int, metric: str) -> np.ndarray:
    """The profile's angle samples, query after query, in visit order.

    ``x`` holds the base rows in the precision of the computation (float64
    for the reference), as the metric takes them; the search walks in rank
    order, and the three Euclidean lengths of each angle are worked out
    from the rows.
    """
    n = x.shape[0]
    l2 = metric == "l2"
    out = []
    for q in queries:
        visited = {entry}
        d0 = float(_rank_np(q, x[entry], metric))
        cand, top = [(d0, entry)], [(-d0, entry)]
        while cand:
            dc, c = heapq.heappop(cand)
            upper = -top[0][0]
            if dc > upper and len(top) >= efs:
                break
            new = []
            for j in nbrs[c]:
                j = int(j)
                if j >= n:
                    break
                if j not in visited:
                    visited.add(j)
                    new.append(j)
            if not new:
                continue
            rows = x[new]
            dn = _rank_np(q, rows, metric)
            dcn = np.sqrt(((rows - x[c]) ** 2).sum(1))
            dcq = np.sqrt(max(dc, 0.0) if l2 else ((x[c] - q) ** 2).sum())
            if dcq > 1e-9:
                ok = np.isfinite(dcn) & (dcn > 1e-9)
                dnq2 = (np.maximum(dn[ok], 0.0) if l2
                        else ((rows[ok] - q) ** 2).sum(1))
                cos = (dcq * dcq + dcn[ok] ** 2 - dnq2) / (2.0 * dcq * dcn[ok])
                out.append(np.arccos(np.clip(cos, -1.0, 1.0)))
            for d, j in zip(dn.tolist(), new):
                if d < upper or len(top) < efs:
                    heapq.heappush(cand, (d, j))
                    heapq.heappush(top, (-d, j))
                    if len(top) > efs:
                        heapq.heappop(top)
                    upper = -top[0][0]
    return (np.concatenate(out).astype(np.float64) if out
            else np.asarray([np.pi / 2]))


class SQ8(NamedTuple):
    codes: torch.Tensor   # [n + 1, d] uint8, the pad row's codes last
    lo: torch.Tensor      # [d]
    scale: torch.Tensor   # [d]
    eps: torch.Tensor     # [d]


def sq8_tables(base: torch.Tensor) -> SQ8:
    """The SQ8 grid in float32, as the search spec defines it: x ~ lo +
    code * scale, code = round((x - lo) / scale) in [0, 255], error radius
    eps = scale / 2 with a relative slack of 2^-10."""
    x = base.float()
    lo = x.min(0).values
    scale = torch.clamp_min((x.max(0).values - lo) / 255.0, 1e-12)
    eps = 0.5 * scale * (1.0 + 2.0 ** -10)
    rows = torch.cat([x, torch.zeros_like(x[:1])])
    codes = torch.empty(rows.shape, dtype=torch.uint8, device=x.device)
    for s in range(0, rows.shape[0], 65536):
        codes[s: s + 65536] = torch.clamp(torch.round(
            (rows[s: s + 65536] - lo) / scale), 0, 255).to(torch.uint8)
    return SQ8(codes, lo, scale, eps)


class Found(NamedTuple):
    ids: torch.Tensor       # [B, k] int64, n where a slot holds nothing
    dists: torch.Tensor     # [B, k] ranks
    counters: Dict[str, torch.Tensor]   # [B] int64 each


COUNTERS = ("dist_calls", "est_calls", "hops", "sq8_calls", "rerank_calls")
ROUTERS = ("none", "crouting")
TWO_STAGE = ("sq8", "both")   # the estimates that take the SQ8 stages


def _lexsort(d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    o = torch.sort(i, dim=1, stable=True).indices
    return o.gather(1, torch.sort(d.gather(1, o), dim=1, stable=True).indices)


def search(x: torch.Tensor, nbrs: torch.Tensor, edges: torch.Tensor,
           entry: int, queries: torch.Tensor, cos_theta: float, spec: dict,
           metric: str, sq8: SQ8 = None) -> Found:
    """Batched beam search over one block of queries, its pool in ranks
    under ``metric``.

    ``x`` [n + 1, d] holds the rows (pad row n: zeros), ``nbrs`` [n + 1, M]
    int64 the adjacency (pad row and pad slots: n), ``edges`` [n + 1, M]
    the Euclidean edge lengths (pad: inf), all in the precision of the
    computation, as ``queries`` [B, d], rows and queries as the metric
    takes them (``rows_in``).  The CRouting estimate and SQ8's stage 1 work
    in Euclidean space; their results reach the pool's ranks through
    ``eu2_to_rank`` with the norms of the rows and the queries.
    ``spec``: a search spec's fields as a configuration states them:
    ``efs``, ``beam_width``, ``k``, ``max_hops``, ``router`` (one of
    ``ROUTERS``), ``estimate`` ("exact", "angle", "sq8" or "both") and
    ``beam_prune`` ("best" where it is not stated).  Counters as the program defines them: ``dist_calls`` exact
    distances (the entry's and the stage-2 reranks included),
    ``est_calls`` angle estimates, ``hops`` expansions, ``sq8_calls``
    stage-1 estimates, ``rerank_calls`` stage-2 reranks.
    """
    n, M = nbrs.shape[0] - 1, nbrs.shape[1]
    efs, W, k = spec["efs"], spec["beam_width"], spec["k"]
    if spec["router"] not in ROUTERS:
        raise ValueError(f"the reference searches with the routers "
                         f"{ROUTERS}, not {spec['router']!r}")
    prunes = spec["router"] == "crouting"
    max_hops = spec["max_hops"]
    two_stage = spec["estimate"] in TWO_STAGE
    # the prune's lanes: the best slot's, or every slot's
    lanes = M if spec.get("beam_prune", "best") == "best" else W * M
    dev, B, L = x.device, queries.shape[0], W * M
    inf = float("inf")
    i64 = torch.int64
    lane = torch.arange(L, device=dev)[None, :]

    def exact(ids):
        return rank(queries, x[ids], metric)

    xn = torch.linalg.norm(x, dim=1)
    nq = torch.linalg.norm(queries, dim=1)[:, None]

    pool_d = torch.full((B, efs), inf, dtype=x.dtype, device=dev)
    pool_i = torch.full((B, efs), n, dtype=i64, device=dev)
    pool_d[:, 0] = exact(torch.full((B, 1), entry, device=dev))[:, 0]
    pool_i[:, 0] = entry
    expanded = torch.zeros((B, efs), dtype=torch.bool, device=dev)
    approx = torch.zeros_like(expanded)
    status = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    status[:, entry] = VISITED
    cnt = {c: torch.zeros(B, dtype=i64, device=dev) for c in COUNTERS}
    cnt["dist_calls"] += 1
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = 0
    while iters < max_hops and not bool(done.all()):
        cand_d = torch.where(~expanded & (pool_i < n), pool_d, inf)
        beam_d, beam = torch.sort(cand_d, dim=1, stable=True)
        beam_d, beam = beam_d[:, :W], beam[:, :W]
        full = pool_i[:, -1] < n
        upper = torch.where(full, pool_d[:, -1], inf)
        live = (torch.isfinite(beam_d) & (beam_d <= upper[:, None])
                & (~done & (cnt["hops"] < max_hops))[:, None])
        live &= torch.cumsum(live, 1) <= (max_hops - cnt["hops"])[:, None]
        done |= ~live.any(1)
        c = torch.where(live, pool_i.gather(1, beam), n)
        dc = pool_d.gather(1, beam)
        if two_stage:
            # stage 2 at expansion: an approximate entry gets its exact
            # distance before it serves as d(c, q)
            picked = approx.gather(1, beam) & live
            dc = torch.where(picked, exact(c), dc)
            pool_d.scatter_(1, beam, dc)
            approx.scatter_(1, beam, approx.gather(1, beam) & ~picked)
            cnt["rerank_calls"] += picked.sum(1)
            cnt["dist_calls"] += picked.sum(1)
        expanded.scatter_(1, beam, expanded.gather(1, beam) | live)

        nb = nbrs[c].reshape(B, L)
        ed = edges[c].reshape(B, L)
        nx = xn[nb]
        st = status.gather(1, nb)
        ok = ((nb < n) & (st != VISITED)
              & live.repeat_interleave(M, dim=1))
        # one lane per id: the first in tile order (a beam of one slot
        # takes every lane); the sort also finds each id's second lane for
        # the error correction
        key, order = torch.sort(torch.where(ok, nb, n + 1), dim=1,
                                stable=True)
        again = torch.zeros_like(ok)
        if W > 1:
            again[:, 1:] = key[:, 1:] == key[:, :-1]
        first = ok & ~torch.zeros_like(ok).scatter_(1, order, again)

        # CRouting (paper Algorithm 2): the tested slots' unvisited lanes,
        # with the pool full, skip the exact distance when the cosine-
        # theorem estimate reaches the pool bound
        dcq = torch.sqrt(torch.clamp_min(rank_to_eu2(dc, nq, xn[c], metric),
                                         0.0)).repeat_interleave(M, 1)
        tried = (first & (st == UNVISITED) & full[:, None] & (lane < lanes)
                 & prunes)
        cnt["est_calls"] += tried.sum(1)
        est2 = torch.clamp_min(ed * ed + dcq * dcq
                               - 2.0 * ed * dcq * cos_theta, 0.0)
        prune = tried & (eu2_to_rank(est2, nq, nx, metric)
                         >= upper[:, None])
        # error correction: a second lane of a pruned id computes it
        pruned_s = prune.gather(1, order)
        second_s = torch.zeros_like(ok)
        second_s[:, 1:] = again[:, 1:] & pruned_s[:, :-1]
        has_second_s = torch.zeros_like(ok)
        has_second_s[:, :-1] = again[:, 1:]
        rescued = torch.zeros_like(ok).scatter_(1, order, second_s)
        compute = (first & ~prune) | rescued
        # a pruned id stays PRUNED only where no second lane computed it
        prune = torch.zeros_like(ok).scatter_(
            1, order, pruned_s & ~has_second_s)

        safe = torch.where(compute, nb, n)
        if two_stage:
            # stage 1: the code rows' estimate and lower bound; a lane
            # whose bound reaches the pool bound is dropped (PRUNED)
            xhat = (sq8.lo.to(x.dtype)
                    + sq8.codes[safe].to(x.dtype) * sq8.scale.to(x.dtype))
            delta = queries[:, None, :] - xhat
            ad2 = (delta * delta).sum(-1)
            lb2 = torch.clamp_min(ad2 - 2.0 * (delta.abs()
                                               * sq8.eps.to(x.dtype)).sum(-1),
                                  0.0)
            lb = eu2_to_rank(lb2, nq, nx, metric)
            insert = compute & ~(full[:, None] & (lb >= upper[:, None]))
            cnt["sq8_calls"] += compute.sum(1)
            new_d = torch.where(insert, eu2_to_rank(ad2, nq, nx, metric), inf)
        else:
            insert = compute
            new_d = torch.where(compute, exact(safe), inf)
            cnt["dist_calls"] += compute.sum(1)

        b, l_ = torch.nonzero(compute | prune, as_tuple=True)
        status[b, nb[b, l_]] = torch.where(
            insert[b, l_], VISITED, PRUNED).to(torch.uint8)

        md = torch.cat([pool_d, new_d], 1)
        mi = torch.cat([pool_i, torch.where(insert, nb, n)], 1)
        me = torch.cat([expanded, torch.zeros_like(insert)], 1)
        ma = torch.cat([approx, insert & two_stage], 1)
        o = _lexsort(md, mi)[:, :efs]
        pool_d, pool_i = md.gather(1, o), mi.gather(1, o)
        expanded, approx = me.gather(1, o), ma.gather(1, o)
        cnt["hops"] += live.sum(1)
        iters += 1

    if two_stage:
        # stage 2 for every approximate entry left in the pool
        last = approx & (pool_i < n)
        pool_d = torch.where(last, exact(torch.where(last, pool_i, n)),
                             pool_d)
        cnt["rerank_calls"] += last.sum(1)
        cnt["dist_calls"] += last.sum(1)
        o = _lexsort(pool_d, pool_i)
        pool_d, pool_i = pool_d.gather(1, o), pool_i.gather(1, o)
    return Found(pool_i[:, :k], pool_d[:, :k], cnt)


def with_pad(x: torch.Tensor, nbrs: torch.Tensor, edges: torch.Tensor):
    """The search's tables: a zero pad row n in ``x``, n in every pad
    slot of ``nbrs``, inf in ``edges``."""
    n, M = nbrs.shape
    x = torch.cat([x, torch.zeros_like(x[:1])])
    nbrs = torch.cat([nbrs.long(), torch.full((1, M), n, dtype=torch.int64,
                                              device=nbrs.device)])
    edges = torch.cat([edges, torch.full((1, M), float("inf"),
                                         dtype=edges.dtype,
                                         device=edges.device)])
    return x, nbrs, edges


def search_blocks(x, nbrs, edges, entry, queries, cos_theta, spec, metric,
                  sq8=None, block: int = 1024) -> Found:
    """``search`` over the queries in blocks (each query is independent)."""
    parts = [search(x, nbrs, edges, entry, queries[s: s + block], cos_theta,
                    spec, metric, sq8)
             for s in range(0, queries.shape[0], block)]
    return Found(torch.cat([p.ids for p in parts]),
                 torch.cat([p.dists for p in parts]),
                 {c: torch.cat([p.counters[c] for p in parts])
                  for c in COUNTERS})
