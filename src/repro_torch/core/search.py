"""Batched beam-expansion graph search in PyTorch (the serving hot path).

The counterpart of ``repro.core.search``: the paper's Algorithm 1/2
restructured as ONE loop over a whole query batch (DESIGN.md §3).

* The candidate queue C and result queue T collapse into one sorted pool of
  size ``efs`` with per-slot expanded flags.
* Per-node state is a dense ``[B, n+1]`` uint8 status array (0 unvisited /
  1 visited / 2 pruned), allocated once per batch.
* Each iteration picks the best W (``SearchSpec.beam_width``) unexpanded
  pool entries per query, gathers their adjacency into a ``[B, W*M]``
  neighbour tile, lets the router prune lanes on stored edge distances,
  computes exact distances for the survivors, writes the visit status and
  merges the tile into the pool.
* ``SearchSpec.engine`` dispatches the tile work:
    - ``"torch"`` — plain PyTorch ops (the counterpart of ``"jnp"``);
    - ``"fused"`` — the ``fused_expand`` kernel (estimate + prune +
      conditional row load + exact distance) and the ``pool_merge`` kernel
      (the counterpart of ``"pallas"``);
    - ``"unfused"`` — the ``crouting_prune`` kernel, then
      ``gather_distance`` on the lanes left to compute, then ``pool_merge``
      (the counterpart of ``"pallas_unfused"``).
  On CPU tensors the kernel wrappers run their plain versions.

Two-stage quantized distances (``SearchSpec.estimate="sq8"|"both"``): the
surviving lanes of a tile do not read their fp32 rows.  Stage 1 reads the
uint8 SQ8 code row (``sq8_distance``, d bytes instead of 4d) for an
approximate distance and a lower bound; a lane whose bound already reaches
the pool bound is dropped (status PRUNED, so a later encounter may
re-estimate it).  Survivors enter the pool with their approximate distance
and an ``approx`` flag; stage 2 (the fp32 row and exact distance,
``gather_distance`` on the kernel engines) runs only when an approximate
entry is picked for expansion, and for every approximate entry left in the
pool at the end.  ``SearchResult.rerank_calls`` counts stage-2 evaluations
(they also count as ``dist_calls``), ``sq8_calls`` stage-1 evaluations.

The loop runs eagerly: its condition (some query not done, fewer than
``max_hops`` iterations) is read on the host once per iteration, and
``SearchResult.iters`` reports how many there were.  ``repro_torch.trace``
logs each engine call's loop time, split into that read's wait and the
rest, and names the loop's phases as spans.

Translation notes against the JAX engine:

* beam pick: ``lax.top_k`` takes the lower index on ties, which
  ``torch.sort(..., stable=True)`` reproduces (``torch.topk`` does not
  promise it);
* ``jnp.lexsort((id, dist))`` is a stable sort by id followed by a stable
  sort by distance;
* ids, counters and the ``id*4 + flags`` pool payload stay int32;
* the hierarchy descent (``vmap`` of per-query ``while_loop``s in JAX) is
  one batched loop per layer over an ``improved`` mask; a query adds to its
  distance count only while it still improves;
* the exact distance is ``repro_torch.kernels.ref.l2sq_rows``, which sums in
  the ``fused_expand`` and ``gather_distance`` kernels' order, and the
  stage-1 estimate ``repro_torch.quant.sq8.sq8_estimate`` sums in the
  ``sq8_distance`` kernel's order, so every engine sees bit-equal distances
  on the card;
* under ``ip``/``cosine`` the hop loop's exact ranks are
  ``(|q - x|^2 - |q|^2 - |x|^2 + 2) / 2`` on every engine, the form the
  kernel engines derive from the kernels' squared L2 (the JAX ``jnp``
  engine computes ``1 - <q, x>``, which differs by ulps and, at k = 100,
  reordered near-tied results between the engines); the hierarchy descent
  and the entry point keep ``1 - <q, x>`` on every engine.

Pad-row sentinel: ``graph_device_arrays`` appends one zero vector at row N;
adjacency pad slots point at it, and pool slots holding no candidate carry
id N and distance +inf.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.graph import GraphIndex
from repro_torch.core.routers import RouterContext, get_router
from repro_torch.core.spec import SearchSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build, ops
from repro_torch.kernels.ref import l2sq_rows
from repro_torch.quant import sq8 as SQ

STATUS_UNVISITED = 0
STATUS_VISITED = 1
STATUS_PRUNED = 2

_I32 = torch.int32


class SearchResult(NamedTuple):
    ids: torch.Tensor         # [B, efs] int32, N = empty
    dists: torch.Tensor       # [B, efs] ranking distance
    dist_calls: torch.Tensor  # [B] int32 exact distance evaluations
    est_calls: torch.Tensor   # [B] int32 router estimates evaluated
    hops: torch.Tensor        # [B] int32 node expansions
    iters: int                # batch-level hop-loop iterations
    rerank_calls: torch.Tensor  # [B] int32 stage-2 exact reranks (sq8 path)
    sq8_calls: torch.Tensor     # [B] int32 stage-1 quantized estimates
    # per-router [B] int32 counters (Router.extra_counters), e.g. finger's
    # finger_est_calls
    extra: Dict[str, torch.Tensor]


def graph_device_arrays(g: GraphIndex, device: DeviceLike = None) -> Dict[str, Any]:
    """Copy a GraphIndex to ``device`` with a sentinel pad row at index N.

    Row N of ``vectors`` (an all-zero vector, norm 1) is the sentinel every
    masked lane resolves to: adjacency pad slots point at it, dead beam
    slots expand it (its neighbour list is all pad), and pool slots holding
    no candidate carry id N.  The SQ8 tables are added by
    ``ensure_sq8_arrays``, which ``build_search_fn`` calls the first time an
    sq8/both spec asks.
    """
    dev = resolve_device(device)
    n, d = g.n, g.dim
    vecs = np.concatenate([g.vectors, np.zeros((1, d), np.float32)], axis=0)
    nbrs = np.concatenate([g.neighbors, np.full((1, g.max_degree), n, np.int32)], axis=0)
    ed = np.concatenate([g.edge_eu_dist, np.full((1, g.max_degree), np.inf,
                                                 g.edge_eu_dist.dtype)], axis=0)
    norms = g.norms if g.norms is not None else np.linalg.norm(g.vectors, axis=1)
    norms = np.concatenate([norms.astype(np.float32), np.ones(1, np.float32)])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    out = {"vectors": t(vecs), "neighbors": t(nbrs.astype(np.int32)),
           "edge_eu": t(ed), "norms": t(norms), "entry": int(g.entry_point),
           "n": n}
    # HNSW hierarchy: id->row maps + per-layer adjacency (top..1)
    if g.upper_neighbors:
        pos_maps, layer_nbrs = [], []
        for ids, mat in zip(g.upper_ids, g.upper_neighbors):
            pos = np.full(n + 1, -1, dtype=np.int32)
            pos[ids] = np.arange(len(ids), dtype=np.int32)
            pos_maps.append(t(pos))
            layer_nbrs.append(t(np.concatenate(
                [mat, np.full((1, mat.shape[1]), n, np.int32)], axis=0)))
        out["upper_pos"] = pos_maps
        out["upper_nbrs"] = layer_nbrs
    return out


def ensure_sq8_arrays(g: GraphIndex, arrays: Dict[str, Any]) -> Dict[str, Any]:
    """Add the SQ8 tables to a device arrays dict (idempotent).

    The grid is fit on the host to the real rows (``sq8_train``), the codes
    are encoded there (``sq8_encode``; the pad row encodes the zero vector
    with the same grid, its distances are always masked) and then moved to
    the arrays' device.  Exact-only searches never pay for them.  The
    host seconds of the fit, the encode and the upload add to the total
    ``engine.sq8_s`` (``repro_torch.trace``).
    """
    if "sq8_codes" not in arrays:
        t0 = time.perf_counter()
        dev = arrays["vectors"].device
        qp = SQ.sq8_train(g.vectors)
        vecs = np.concatenate([g.vectors, np.zeros((1, g.dim), np.float32)],
                              axis=0)
        for key, a in (("sq8_codes", SQ.sq8_encode(vecs, qp)),
                       ("sq8_lo", qp.lo), ("sq8_scale", qp.scale),
                       ("sq8_eps", qp.eps)):
            arrays[key] = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        trace.add("engine.sq8_s", time.perf_counter() - t0)
    return arrays


def _rank_tile(queries, X, metric):
    """queries [B, d], X [B, L, d] -> ranking distances [B, L]."""
    if metric == "l2":
        return l2sq_rows(queries, X)
    return 1.0 - torch.einsum("bld,bd->bl", X, queries)


def _rank_to_eu(rank, nq, nx, metric):
    if metric == "l2":
        return torch.sqrt(torch.clamp_min(rank, 0.0))
    return torch.sqrt(torch.clamp_min(nx * nx + nq * nq + 2.0 * rank - 2.0, 0.0))


def _eu2_to_rank(eu2, nq, nx, metric):
    if metric == "l2":
        return eu2
    return (eu2 - nx * nx - nq * nq + 2.0) / 2.0


def _descend(arrays, queries, metric):
    """Greedy 1-NN descent through the HNSW upper layers, batched.

    Returns (entry [B] int32, d_entry [B], dist_calls [B] int32).  Each
    layer runs while some query still improves; a query stops counting
    distance calls once it no longer improves (``torch.argmin`` returns the
    first minimum, as ``jnp.argmin`` does).
    """
    B = queries.shape[0]
    dev, n = queries.device, arrays["n"]
    vecs = arrays["vectors"]
    cur = torch.full((B,), arrays["entry"], dtype=_I32, device=dev)
    d_cur = _rank_tile(queries, vecs[cur.long()][:, None, :], metric)[:, 0]
    calls = torch.ones((B,), dtype=_I32, device=dev)
    for pos_map, lnbrs in zip(arrays.get("upper_pos", ()),
                              arrays.get("upper_nbrs", ())):
        improved = torch.ones((B,), dtype=torch.bool, device=dev)
        while bool(improved.any()):
            row = pos_map[cur.long()]
            nb = lnbrs[torch.where(row >= 0, row, lnbrs.shape[0] - 1).long()]
            live = nb < n
            dists = _rank_tile(queries, vecs[nb.long()], metric)
            dists = torch.where(live, dists, torch.full_like(dists, float("inf")))
            calls = calls + torch.where(improved, live.sum(1, dtype=_I32), 0)
            j = torch.argmin(dists, dim=1, keepdim=True)
            dj = dists.gather(1, j)[:, 0]
            better = improved & (dj < d_cur)
            cur = torch.where(better, nb.gather(1, j)[:, 0], cur)
            d_cur = torch.where(better, dj, d_cur)
            improved = better
    return cur, d_cur, calls


def _first_occurrence(nbrs, valid, n):
    """Keep only the first valid lane per distinct neighbour id (per row).

    With a beam of W nodes the [B, W*M] tile can name the same neighbour
    from two expansion nodes; sequential Algorithm 1 would visit it once, so
    the tile must too.  Returns (first_mask, order, sorted_keys); the latter
    two let _rescue_pruned_duplicates reuse the same sort.
    """
    key = torch.where(valid, nbrs, n + 1)
    sk, order = torch.sort(key, dim=1, stable=True)
    dup_sorted = torch.zeros_like(valid)
    dup_sorted[:, 1:] = sk[:, 1:] == sk[:, :-1]
    dup = torch.zeros_like(valid).scatter_(1, order, dup_sorted)
    return valid & ~dup, order, sk


def _rescue_pruned_duplicates(order, sk, prune):
    """Within-tile error correction, reusing the dedup sort.

    Returns (rescued, prune_final): ``rescued`` marks the SECOND valid lane
    of each id whose first lane was pruned (it is computed exactly — the
    paper's PRUNED-revisit rule collapsed into one tile); ``prune_final``
    clears the prune mark for such rescued ids.
    """
    pr_s = prune.gather(1, order)
    same = sk[:, 1:] == sk[:, :-1]
    rescued_s = torch.zeros_like(prune)
    rescued_s[:, 1:] = same & pr_s[:, :-1]
    same_next = torch.zeros_like(prune)
    same_next[:, :-1] = same
    keep_prune_s = pr_s & ~same_next      # pruned ids with no second lane
    rescued = torch.zeros_like(prune).scatter_(1, order, rescued_s)
    prune_final = torch.zeros_like(prune).scatter_(1, order, keep_prune_s)
    return rescued, prune_final


def _lexsort_dist_id(d, i):
    """Row-wise permutation sorting by (dist, id): stable by id, then by dist."""
    o1 = torch.sort(i, dim=1, stable=True).indices
    o2 = torch.sort(d.gather(1, o1), dim=1, stable=True).indices
    return o1.gather(1, o2)


def _search_batch(arrays, queries, cos_theta, cfg: SearchSpec, valid=None,
                  tombstone=None) -> SearchResult:
    """Whole-batch Algorithm 1/2 with W-wide beam expansion per iteration.

    ``valid`` ([B] bool, optional) marks the real query lanes of a padded
    batch: padded lanes start done, never expand a node, and count zero in
    every counter.  ``tombstone`` ([n+1] bool, pad row False, optional)
    marks deleted nodes: they keep routing, but are masked out of the
    result pool after the loop (id -> n, dist -> +inf), before the sq8
    path's final rerank, then re-sorted.

    Its phases are spans of ``repro_torch.trace``: ``search.init``, then an
    iteration ``hop`` each with ``hop.sync`` (the one host sync),
    ``hop.beam``, ``hop.tile``, ``hop.route``, ``hop.dist``, ``hop.status``
    and ``hop.merge``, then ``search.final``.  The loop's host time, split
    into the time blocked in the sync and the rest, adds to the engine call
    in progress (``trace.hop_loop``).
    """
    metric, efs, n = cfg.metric, cfg.efs, arrays["n"]
    W, engine = cfg.beam_width, cfg.engine
    rt = get_router(cfg.router)
    if not 1 <= W <= efs:
        raise ValueError("beam_width must be in [1, efs]")
    if cfg.estimate in ("angle", "both") and not rt.prunes:
        raise ValueError(f"estimate={cfg.estimate!r} needs a pruning router, "
                         f"got {cfg.router!r}")
    sq8_on = cfg.estimate in ("sq8", "both")
    kernels = engine in ("fused", "unfused")
    if kernels and n >= 2 ** 29:
        raise ValueError("the kernel engines encode ids as id*4+flags in "
                         "int32: shard below 2^29 vectors or use "
                         "engine='torch'")
    ph = trace.phases()
    ph.to("search.init")
    dev = queries.device
    vecs, norms = arrays["vectors"], arrays["norms"]
    queries = queries.to(torch.float32).contiguous()
    # the engine's cos(theta*) is an f32 value, as the JAX engine's traced
    # f32 scalar is
    cos_theta = float(np.float32(cos_theta))
    B = queries.shape[0]
    M = arrays["neighbors"].shape[1]
    L = W * M
    rows = torch.arange(B, device=dev)
    inf = float("inf")

    nq = (torch.linalg.norm(queries, dim=1) if metric != "l2"
          else torch.ones((B,), dtype=torch.float32, device=dev))

    def _exact_rerank(ids, mask):
        """Stage 2: exact ranking distances for the pool entries in
        ``mask``; the fp32 rows are read here and only here on the sq8
        path, and other lanes report +inf.  ``ids`` lie in [0, n] (n: the
        pad row)."""
        if kernels:
            # the kernel takes the mask as it is and skips the other lanes
            eu2 = ops.gather_distance_where(ids, mask, queries, vecs)
        else:
            eu2 = l2sq_rows(queries, vecs[torch.where(mask, ids, n).long()])
        r = _eu2_to_rank(eu2, nq[:, None], norms[ids.long()], metric)
        return torch.where(mask, r, inf)

    if cfg.use_hierarchy:
        entry, d_entry, calls0 = _descend(arrays, queries, metric)
    else:
        entry = torch.full((B,), arrays["entry"], dtype=_I32, device=dev)
        d_entry = _rank_tile(queries, vecs[entry.long()][:, None, :], metric)[:, 0]
        calls0 = torch.ones((B,), dtype=_I32, device=dev)

    if valid is None:
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
    else:
        valid = valid.to(device=dev, dtype=torch.bool)
        done = ~valid                      # padded lanes are born done
        calls0 = torch.where(valid, calls0, 0)

    pool_d = torch.full((B, efs), inf, dtype=torch.float32, device=dev)
    pool_d[:, 0] = d_entry
    pool_id = torch.full((B, efs), n, dtype=_I32, device=dev)
    pool_id[:, 0] = entry
    pool_exp = torch.zeros((B, efs), dtype=torch.bool, device=dev)
    pool_apx = torch.zeros((B, efs), dtype=torch.bool, device=dev)
    status = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    status[rows, entry.long()] = STATUS_VISITED
    dcalls = calls0
    ecalls = torch.zeros((B,), dtype=_I32, device=dev)
    rrcalls = torch.zeros((B,), dtype=_I32, device=dev)
    sqcalls = torch.zeros((B,), dtype=_I32, device=dev)
    # per-router counters (registry-declared, see Router.extra_counters)
    extras = {name: torch.zeros((B,), dtype=_I32, device=dev)
              for name in rt.extra_counters}
    hops = torch.zeros((B,), dtype=_I32, device=dev)
    iters = 0

    prunes = rt.prunes
    ct_eff = rt.cos_theta_eff(cos_theta)
    rescue = W > 1 and prunes and rt.revisit_pruned and not rt.permanent
    # with sq8 the fused fp32 kernel never runs, so the prune decision is
    # taken outside it (the router hook or crouting_prune: the same f32 math)
    kernel_prunes = (engine == "fused" and rt.kernel_estimate and not rescue
                     and not sq8_on)
    best_slot = torch.arange(L, device=dev)[None, :] < M

    t_loop, sync_ns = time.perf_counter_ns(), 0
    while iters < cfg.max_hops:
        ph.hop()
        # --- the iteration's one host sync: is every query done? ----------
        ph.to("hop.sync")
        all_done = done.all()
        t0 = time.perf_counter_ns()
        finished = bool(all_done)
        sync_ns += time.perf_counter_ns() - t0
        if finished:
            break

        # --- beam selection: best W unexpanded pool entries per query -----
        ph.to("hop.beam")
        cand = (~pool_exp) & (pool_id < n)
        cand_d = torch.where(cand, pool_d, inf)
        beam_d, beam_idx = torch.sort(cand_d, dim=1, stable=True)
        beam_d, beam_idx = beam_d[:, :W], beam_idx[:, :W]
        pool_full = pool_id[:, efs - 1] < n
        upper = torch.where(pool_full, pool_d[:, efs - 1], inf)      # [B]
        active = (~done) & (hops < cfg.max_hops)
        slot_live = torch.isfinite(beam_d) & (beam_d <= upper[:, None]) \
            & active[:, None]                                         # [B, W]
        # keep the per-query hop budget exact
        budget = cfg.max_hops - hops
        slot_live = slot_live & (torch.cumsum(slot_live, dim=1, dtype=_I32)
                                 <= budget[:, None])
        done = done | ~slot_live.any(dim=1)

        c = torch.where(slot_live, pool_id.gather(1, beam_idx), n)    # [B, W]
        dc = pool_d.gather(1, beam_idx)                               # [B, W]
        if sq8_on:
            # stage-2 rerank at expansion: an approximate entry picked for
            # the beam gets its exact distance (and loses its flag) before
            # that distance is used as d(c, q) for the tile's estimates
            apx = pool_apx.gather(1, beam_idx)
            sel_apx = apx & slot_live
            dc = torch.where(sel_apx, _exact_rerank(c, sel_apx), dc)
            pool_d.scatter_(1, beam_idx, dc)
            pool_apx.scatter_(1, beam_idx, apx & ~sel_apx)
            nrr = sel_apx.sum(1, dtype=_I32)
            rrcalls = rrcalls + nrr
            dcalls = dcalls + nrr
        pool_exp.scatter_(1, beam_idx, pool_exp.gather(1, beam_idx) | slot_live)

        # --- dense [B, W*M] neighbour tile ---------------------------------
        ph.to("hop.tile")
        cl = c.long()
        nbrs = arrays["neighbors"][cl].reshape(B, L)                  # [B, L]
        # stored edge distances may be bf16; the estimate math is f32
        ed = arrays["edge_eu"][cl].to(torch.float32).reshape(B, L)
        nbl = nbrs.long()
        st = status.gather(1, nbl)                                    # [B, L]
        lane_live = slot_live[:, :, None].expand(B, W, M).reshape(B, L)
        lane_ok = (nbrs < n) & (st != STATUS_VISITED) & lane_live
        if not rt.revisit_pruned:
            lane_ok = lane_ok & (st != STATUS_PRUNED)
        if W > 1:
            first, dd_order, dd_keys = _first_occurrence(nbrs, lane_ok, n)
        else:
            first = lane_ok

        dcq_eu = _rank_to_eu(dc, nq[:, None], norms[cl], metric)      # [B, W]
        # per lane as a [B, W, M] view: the fused_expand and crouting_prune
        # kernels read it through its zero stride; the router paths take
        # the [B, L] copy
        dcq_w = dcq_eu[:, :, None].expand(B, W, M)
        nx = norms[nbl]                                               # [B, L]
        if metric == "l2":
            bound2 = upper[:, None].expand(B, L)
        else:
            # est_rank >= upper  <=>  est2 >= inverse rank->eu^2 per lane
            bound2 = 2.0 * upper[:, None] + nx * nx + (nq * nq)[:, None] - 2.0

        # --- router: estimate + prune (no neighbour row is read here) ------
        ph.to("hop.route")
        if prunes:
            try_prune = first & (st == STATUS_UNVISITED) & pool_full[:, None]
            if W > 1 and cfg.beam_prune == "best":
                # slot 0 is the node sequential search would expand now;
                # only its lanes run the estimate test
                try_prune = try_prune & best_slot
            if rt.counts_est:
                ecalls = ecalls + try_prune.sum(1, dtype=_I32)
        else:
            try_prune = torch.zeros_like(first)

        if not prunes or kernel_prunes:
            prune = torch.zeros_like(first)
        elif engine == "unfused" and rt.kernel_estimate:
            prune = ops.crouting_prune(ed, dcq_w, bound2, try_prune,
                                       ct_eff)[1]
        else:
            ctx = RouterContext(
                arrays=arrays, queries=queries, nq=nq, c=c, dc=dc, nbrs=nbrs,
                ed=ed, dcq=dcq_w.reshape(B, L), nx=nx, try_prune=try_prune,
                upper=upper, cos_theta=cos_theta, metric=metric, n=n,
                beam_width=W, max_degree=M)
            est_rank, extra_inc = rt.estimate_rank(ctx)
            prune = try_prune & (est_rank >= upper[:, None])
            extras = {k: v + extra_inc.get(k, 0) for k, v in extras.items()}

        if rescue:
            # within-tile error correction (paper Alg. 2): a second valid
            # lane of a pruned id computes, and the id ends VISITED
            rescued, prune_kept = _rescue_pruned_duplicates(dd_order, dd_keys,
                                                            prune)
            compute = (first & ~prune) | rescued
            prune = prune_kept
        else:
            compute = first & ~prune

        # --- distances: stage-1 quantized estimate (sq8) or exact fp32 -----
        ph.to("hop.dist")
        if sq8_on:
            # stage 1: uint8 code rows -> estimate + lower bound for every
            # surviving lane; no fp32 row is read here (that is stage 2)
            sq8_args = (arrays["sq8_codes"], arrays["sq8_lo"],
                        arrays["sq8_scale"], arrays["sq8_eps"])
            if kernels:
                ad2, lb2 = ops.sq8_estimate(nbrs, queries, compute, *sq8_args)
            else:
                codes, lo, scale, eps = sq8_args
                xhat = SQ.sq8_dequantize_rows(
                    codes[torch.where(compute, nbl, n)], lo, scale)
                ad2, lb2 = SQ.sq8_estimate(queries, xhat, eps)
                ad2 = torch.where(compute, ad2, inf)
                lb2 = torch.where(compute, lb2, inf)
            ad_rank = _eu2_to_rank(ad2, nq[:, None], nx, metric)
            lb_rank = _eu2_to_rank(lb2, nq[:, None], nx, metric)
            # a lane whose true distance provably cannot beat the pool
            # bound is dropped without its fp32 row; PRUNED (not VISITED),
            # so a later encounter may re-estimate it against a tighter bound
            sq8_skip = (compute & pool_full[:, None]
                        & (lb_rank >= upper[:, None]))
            insert = compute & ~sq8_skip
            sqcalls = sqcalls + compute.sum(1, dtype=_I32)
            new_d = torch.where(insert, ad_rank, inf)
        else:
            # exact fp32 distances (pruned/masked lanes load no row)
            if engine == "fused":
                d2eu, prune_k = ops.fused_expand(
                    nbrs, queries, ed, dcq_w, bound2, ct_eff, vecs,
                    eval_mask=compute,
                    prune_eligible=try_prune if kernel_prunes else None,
                    prunes=kernel_prunes)
                if kernel_prunes:
                    # the kernel made the prune decision and skipped those rows
                    prune = prune_k
                    compute = compute & ~prune
            elif engine == "unfused":
                d2eu = ops.gather_distance_where(nbrs, compute, queries, vecs)
            else:
                d2eu = l2sq_rows(queries, vecs[torch.where(compute, nbl, n)])
            exact = _eu2_to_rank(d2eu, nq[:, None], nx, metric)
            insert = compute
            new_d = torch.where(compute, exact, inf)
            dcalls = dcalls + compute.sum(1, dtype=_I32)

        # --- status scatter: unchanged lanes write the pad column's own
        # value to the pad column, so the scatter stays deterministic -------
        ph.to("hop.status")
        change = compute | prune
        if rt.permanent:
            new_st = torch.full_like(st, STATUS_VISITED)
        else:
            new_st = torch.where(insert, STATUS_VISITED, STATUS_PRUNED
                                 ).to(torch.uint8)
        pad_val = status[:, n:n + 1].expand(B, L)
        status.scatter_(1, torch.where(change, nbl, n),
                        torch.where(change, new_st, pad_val))

        # --- pool merge (merge-then-truncate == evolving-bound insertion) --
        ph.to("hop.merge")
        new_id = torch.where(insert, nbrs, n)
        new_apx = insert if sq8_on else torch.zeros_like(insert)
        if kernels:
            # the approx and expanded flags ride the merge in the id's low
            # bits: id*4 + approx*2 + (not expanded).  Two entries can share
            # (dist, id) only when an adjacency row names a node twice (an
            # NSG's orphan edges can): the beam expands the first copy, and
            # the torch engine's stable sort keeps it first; with the bit
            # set for an unexpanded entry the kernel orders them the same
            enc_pool = (pool_id * 4 + pool_apx.to(_I32) * 2
                        + (~pool_exp).to(_I32))
            pool_d, enc = ops.pool_merge(pool_d, enc_pool, new_d,
                                         new_id * 4 + new_apx.to(_I32) * 2
                                         + 1)
            pool_id = enc >> 2
            pool_apx = (enc & 2) == 2
            pool_exp = (enc & 1) == 0
        else:
            md = torch.cat([pool_d, new_d], dim=1)
            mi = torch.cat([pool_id, new_id], dim=1)
            me = torch.cat([pool_exp, torch.zeros_like(insert)], dim=1)
            ma = torch.cat([pool_apx, new_apx], dim=1)
            # lexicographic (dist, id): the kernel's tie-break
            order = _lexsort_dist_id(md, mi)[:, :efs]
            pool_d, pool_id, pool_exp, pool_apx = (
                md.gather(1, order), mi.gather(1, order),
                me.gather(1, order), ma.gather(1, order))

        hops = hops + slot_live.sum(1, dtype=_I32)
        iters += 1
    trace.hop_loop(iters, time.perf_counter_ns() - t_loop - sync_ns, sync_ns)

    ph.to("search.final")
    if tombstone is not None:
        # emission-time masking: dead entries routed normally; here they
        # collapse to the pad sentinel, so neither the final rerank nor the
        # caller ever sees them
        dead = tombstone.to(dev)[pool_id.long()]
        pool_d = torch.where(dead, inf, pool_d)
        pool_id = torch.where(dead, n, pool_id)
    if sq8_on:
        # stage-2 final rerank: every approximate survivor still in the pool
        # gets its exact distance; entries displaced earlier never paid
        # their fp32 row
        mask = pool_apx & (pool_id < n)
        pool_d = torch.where(mask, _exact_rerank(pool_id, mask), pool_d)
        nrr = mask.sum(1, dtype=_I32)
        rrcalls = rrcalls + nrr
        dcalls = dcalls + nrr
    if sq8_on or tombstone is not None:
        order = _lexsort_dist_id(pool_d, pool_id)
        pool_d, pool_id = pool_d.gather(1, order), pool_id.gather(1, order)
    if valid is not None:
        dcalls, ecalls, rrcalls, sqcalls, hops = (
            torch.where(valid, a, 0)
            for a in (dcalls, ecalls, rrcalls, sqcalls, hops))
        extras = {k: torch.where(valid, v, 0) for k, v in extras.items()}
    ph.close()
    return SearchResult(ids=pool_id, dists=pool_d, dist_calls=dcalls,
                        est_calls=ecalls, hops=hops, iters=iters,
                        rerank_calls=rrcalls, sq8_calls=sqcalls, extra=extras)


# --- engine cache ------------------------------------------------------------
# Device arrays are cached per (graph, device), shared by every spec that
# searches that graph; bound engines per (graph identity, canonical spec,
# router, tombstones, device).  Weakrefs guard against id() reuse after gc,
# and dead-graph entries are purged on every call so their device tensors
# do not stay pinned.  ``_ENGINE_CACHE`` holds at most ``_ENGINE_CACHE_MAX``
# engines; a caller that must not pay an evicted engine's setup again (a
# serving session, a mutable index's snapshot) holds its engine and calls
# it directly.
_ARRAYS_CACHE: "dict[tuple, tuple]" = {}
_ENGINE_CACHE: "dict[tuple, tuple]" = {}
_ENGINE_CACHE_MAX = 16
_CACHE_LOCK = threading.Lock()


def _purge_dead_cache_entries():
    """Drop every cache entry tied to a collected graph."""
    with _CACHE_LOCK:
        for k in [k for k, v in _ARRAYS_CACHE.items() if v[0]() is None]:
            del _ARRAYS_CACHE[k]
        for k in [k for k, v in _ENGINE_CACHE.items()
                  if v[0]() is None or (k[0], k[4]) not in _ARRAYS_CACHE]:
            del _ENGINE_CACHE[k]


def _graph_arrays_cached(g: GraphIndex, dev: torch.device):
    key = (id(g), str(dev))
    with _CACHE_LOCK:
        hit = _ARRAYS_CACHE.get(key)
    if hit is not None and hit[0]() is g:
        return hit[1]
    arrays = graph_device_arrays(g, dev)
    with _CACHE_LOCK:
        hit = _ARRAYS_CACHE.get(key)
        if hit is not None and hit[0]() is g:
            return hit[1]
        _ARRAYS_CACHE[key] = (weakref.ref(g), arrays)
    return arrays


class SearchEngine:
    """A bound search engine: ``fn(queries [B, d], cos_theta)`` ->
    ``SearchResult`` (with ``tombstones=True``: ``fn(queries, cos_theta,
    tombstone [n+1])``).

    It keeps a ledger of *first-use events*, the one-time work a warmup
    has to take off the request path: its own setup (the cache miss that
    built it: graph arrays uploaded, SQ8 codes encoded, router tables
    built), each batch shape it runs for the first time, and each kernel
    library its calls loaded first in the process (``build.load``, which
    may run ``nvcc``).  ``first_uses()`` reads it, where the JAX package
    reads a jitted function's ``_cache_size()``.  Each call is also one
    record of ``repro_torch.trace``'s call log (``trace.call``), marked
    ``first_use`` by the same test.
    """

    def __init__(self, g: GraphIndex, arrays, cfg: SearchSpec,
                 tombstones: bool, dev: torch.device):
        self.graph_ref = weakref.ref(g)
        self.arrays = arrays
        self.cfg = cfg
        self.tombstones = tombstones
        self.dev = dev
        self._lock = threading.Lock()
        self._shapes: set = set()       # guarded by: self._lock
        self._loads = 0                 # guarded by: self._lock

    def __call__(self, queries, cos_theta, tombstone=None) -> SearchResult:
        if (tombstone is not None) != self.tombstones:
            raise TypeError("a tombstones=True engine takes a tombstone "
                            "mask, any other engine none")
        with trace.call() as rec:
            with trace.span("search.init"):
                q = torch.as_tensor(queries, dtype=torch.float32,
                                    device=self.dev)
                if tombstone is not None:
                    tombstone = torch.as_tensor(tombstone, device=self.dev)
            loads0 = build.first_loads_on_this_thread()
            res = _search_batch(self.arrays, q, cos_theta, self.cfg,
                                tombstone=tombstone)
            loads = build.first_loads_on_this_thread() - loads0
            shape = tuple(q.shape)
            with self._lock:
                rec.first_use = loads > 0 or shape not in self._shapes
                self._shapes.add(shape)
                self._loads += loads
            rec.rows = shape[0]
        return res

    def first_uses(self) -> int:
        """Setup (1) + batch shapes run + kernel libraries first loaded."""
        with self._lock:
            return 1 + len(self._shapes) + self._loads


def _insert_locked(key, g: GraphIndex, engine: SearchEngine):
    """Cache ``engine`` under ``key``, evicting the oldest entries past
    ``_ENGINE_CACHE_MAX`` (``_CACHE_LOCK`` held)."""
    _ENGINE_CACHE.pop(key, None)
    while len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    _ENGINE_CACHE[key] = (weakref.ref(g), engine.arrays, engine)


def build_search_fn(g: GraphIndex, cfg: SearchSpec, tombstones: bool = False,
                    device: DeviceLike = None):
    """Returns (arrays, engine) for searching ``g`` under ``cfg`` on
    ``device``.

    ``engine(queries [B, d], cos_theta) -> SearchResult``; with
    ``tombstones=True`` it is ``engine(queries, cos_theta, tombstone
    [n+1])`` (see ``SearchEngine``).  Cached per (graph identity,
    canonical spec, router instance, tombstones, device): a repeat call
    with the same live graph and an equal spec returns the same engine and
    the same device arrays while the cache holds it.
    """
    dev = resolve_device(device)
    _purge_dead_cache_entries()
    cfg = cfg.canonical()
    rt = get_router(cfg.router)
    key = (id(g), cfg, rt, tombstones, str(dev))
    with _CACHE_LOCK:
        hit = _ENGINE_CACHE.get(key)
    if hit is not None and hit[0]() is g:
        return hit[1], hit[2]

    # the setup runs outside the lock: a concurrent lookup of another
    # engine must not wait behind an upload
    arrays = _graph_arrays_cached(g, dev)
    if cfg.estimate in ("sq8", "both"):
        # upgrade the shared cached dict lazily: exact-only searches never
        # pay for the encode pass or the code table
        ensure_sq8_arrays(g, arrays)
    # router companion tables (finger's signatures) upgrade it the same
    # lazy way the first time the router searches this graph
    rt.prepare(g, arrays)
    engine = SearchEngine(g, arrays, cfg, tombstones, dev)
    with _CACHE_LOCK:
        hit = _ENGINE_CACHE.get(key)
        if hit is not None and hit[0]() is g:
            engine = hit[2]         # another thread set it up meanwhile
        else:
            _insert_locked(key, g, engine)
    return engine.arrays, engine


def search_batch(g: GraphIndex, queries: np.ndarray, cfg: SearchSpec,
                 cos_theta: float = 0.0, k: Optional[int] = None,
                 device: DeviceLike = None) -> SearchResult:
    """One-shot batched search (engine cached per (graph, spec, device))."""
    _, fn = build_search_fn(g, cfg, device=device)
    res = fn(queries, cos_theta)
    if k is not None:
        res = res._replace(ids=res.ids[:, :k], dists=res.dists[:, :k])
    return res
