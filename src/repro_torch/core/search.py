"""Batched beam-expansion graph search in PyTorch (the serving hot path).

The counterpart of ``repro.core.search``: the paper's Algorithm 1/2
restructured as ONE loop over a whole query batch (DESIGN.md §3).

* The candidate queue C and result queue T collapse into one sorted pool of
  size ``efs`` with per-slot expanded flags.
* Per-node state is a dense ``[B, n+1]`` uint8 status array (0 unvisited /
  1 visited / 2 pruned), zeroed once per batch.
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
``pruned`` counts the lanes the router pruned (one reduction an
iteration), ``first_stage`` the loop's lanes that took a first-stage
distance: exact fp32, or stage 1 on the two-stage path.

The loop's condition (some query not done, fewer than ``max_hops``
iterations) is read on the host once per iteration, and
``SearchResult.iters`` reports how many there were.  On a CUDA device a
``SearchEngine`` captures the iteration's ~160 launches as one CUDA graph
for each batch shape and replays it once an iteration (``HopGraphs``);
elsewhere, and for a router that does not declare itself ``graph_safe``,
the same iteration runs eagerly.  ``repro_torch.trace`` logs each engine
call's loop time, split into that read's wait and the rest, and how many
iterations were replays, and names the loop's phases as spans.

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

import itertools
import threading
import time
import weakref
from collections import OrderedDict
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
    pruned: torch.Tensor        # [B] int32 lanes the router pruned
    # [B] int32 hop-loop lanes that took a first-stage distance: exact fp32
    # (estimate exact/angle) or the SQ8 stage 1 (sq8/both)
    first_stage: torch.Tensor


_RESULT_TENSORS = ("ids", "dists", "dist_calls", "est_calls", "hops",
                   "rerank_calls", "sq8_calls", "pruned", "first_stage")


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


class _HopState:
    """What a hop iteration reads and writes besides the graph's arrays:
    the queries and their norms, the pool (ids, ranking distances,
    expanded and approximate flags), the ``[B, n+1]`` status, the done
    flags and the counters.

    ``_Hop.step`` writes every new value into these tensors, so they keep
    their addresses: a CUDA graph captured on them replays on whatever
    ``start`` wrote there for the next call."""

    def __init__(self, B, d, efs, n, L, M, extra_names, dev):
        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=dev)
        self.queries, self.nq = empty(B, d), empty(B)
        # the lanes of beam slot 0 in the [B, W*M] tile
        self.best_slot = torch.arange(L, device=dev)[None, :] < M
        self.pool_d = empty(B, efs)
        self.pool_id = empty(B, efs, dtype=_I32)
        self.pool_exp = empty(B, efs, dtype=torch.bool)
        self.pool_apx = empty(B, efs, dtype=torch.bool)
        self.status = empty(B, n + 1, dtype=torch.uint8)
        self.done = empty(B, dtype=torch.bool)
        (self.dcalls, self.ecalls, self.rrcalls, self.sqcalls, self.hops,
         self.pruned) = (empty(B, dtype=_I32) for _ in range(6))
        # per-router counters (registry-declared, see Router.extra_counters)
        self.extras = {name: empty(B, dtype=_I32) for name in extra_names}

    @staticmethod
    def nbytes(B, d, efs, n, L, M, extra_names) -> int:
        """The bytes ``_HopState(B, d, efs, n, L, M, extra_names, dev)``
        allocates, known before it does."""
        return (B * (n + 1) + B * (4 * d + 4 + 10 * efs + 1)
                + 4 * B * (6 + len(extra_names)) + L)

    def start(self, queries, nq, entry, d_entry, calls0, valid, n):
        """A call's starting values, written in place: the pool holds
        ``entry`` [B] (at ``d_entry``), which alone is VISITED; the
        distance count is ``calls0``; padded lanes (``valid`` False) are
        born done and count zero."""
        self.queries.copy_(queries)
        self.nq.copy_(nq)
        self.pool_d.fill_(float("inf"))
        self.pool_d[:, 0] = d_entry
        self.pool_id.fill_(n)
        self.pool_id[:, 0] = entry
        self.pool_exp.zero_()
        self.pool_apx.zero_()
        self.status.zero_()
        rows = torch.arange(entry.shape[0], device=entry.device)
        self.status[rows, entry.long()] = STATUS_VISITED
        if valid is None:
            self.done.zero_()
            self.dcalls.copy_(calls0)
        else:
            torch.logical_not(valid, out=self.done)
            self.dcalls.copy_(torch.where(valid, calls0, 0))
        for t in (self.ecalls, self.rrcalls, self.sqcalls, self.hops,
                  self.pruned, *self.extras.values()):
            t.zero_()


class _Hop:
    """One hop iteration, fixed by the graph's arrays, the spec, the
    router and cos(theta*): ``step(s, ph)`` advances the state ``s`` by
    one iteration in place.

    Which operations it issues depends on those alone, never on the data,
    and it reads nothing back to the host; so the operations of one call
    captured as a CUDA graph are those of every later call on the same
    state (``_HopGraph``)."""

    def __init__(self, arrays, cfg: SearchSpec, rt, cos_theta: float):
        self.arrays, self.cfg, self.rt = arrays, cfg, rt
        self.cos_theta = cos_theta
        self.n = arrays["n"]
        self.M = arrays["neighbors"].shape[1]
        self.L = cfg.beam_width * self.M
        self.sq8_on = cfg.estimate in ("sq8", "both")
        self.kernels = cfg.engine in ("fused", "unfused")
        self.ct_eff = rt.cos_theta_eff(cos_theta)
        self.rescue = (cfg.beam_width > 1 and rt.prunes and rt.revisit_pruned
                       and not rt.permanent)
        # with sq8 the fused fp32 kernel never runs, so the prune decision
        # is taken outside it (the router hook or crouting_prune: the same
        # f32 math)
        self.kernel_prunes = (cfg.engine == "fused" and rt.kernel_estimate
                              and not self.rescue and not self.sq8_on)

    def graph_key(self):
        """What a captured iteration bakes in besides the state: the spec,
        the router, cos(theta*) and the address and shape of each of the
        graph's arrays (``ensure_sq8_arrays``, a router's ``prepare`` or a
        mutation may replace one)."""
        return (self.cfg, self.rt, self.cos_theta, tuple(
            (k, v.data_ptr(), tuple(v.shape), v.dtype)
            for k, v in sorted(self.arrays.items())
            if isinstance(v, torch.Tensor)))

    def rerank(self, s: _HopState, ids, mask):
        """Stage 2: exact ranking distances for the pool entries in
        ``mask``; the fp32 rows are read here and only here on the sq8
        path, and other lanes report +inf.  ``ids`` lie in [0, n] (n: the
        pad row)."""
        vecs, n = self.arrays["vectors"], self.n
        if self.kernels:
            # the kernel takes the mask as it is and skips the other lanes
            eu2 = ops.gather_distance_where(ids, mask, s.queries, vecs)
        else:
            eu2 = l2sq_rows(s.queries, vecs[torch.where(mask, ids, n).long()])
        r = _eu2_to_rank(eu2, s.nq[:, None], self.arrays["norms"][ids.long()],
                         self.cfg.metric)
        return torch.where(mask, r, float("inf"))

    def step(self, s: _HopState, ph) -> None:
        cfg, arrays, rt = self.cfg, self.arrays, self.rt
        metric, efs, n = cfg.metric, cfg.efs, self.n
        W, M, L, engine = cfg.beam_width, self.M, self.L, cfg.engine
        B = s.done.shape[0]
        queries, nq = s.queries, s.nq
        vecs, norms = arrays["vectors"], arrays["norms"]
        pool_d, pool_id, pool_exp, pool_apx = (s.pool_d, s.pool_id,
                                               s.pool_exp, s.pool_apx)
        inf = float("inf")

        # --- beam selection: best W unexpanded pool entries per query -----
        ph.to("hop.beam")
        cand = (~pool_exp) & (pool_id < n)
        cand_d = torch.where(cand, pool_d, inf)
        beam_d, beam_idx = torch.sort(cand_d, dim=1, stable=True)
        beam_d, beam_idx = beam_d[:, :W], beam_idx[:, :W]
        pool_full = pool_id[:, efs - 1] < n
        upper = torch.where(pool_full, pool_d[:, efs - 1], inf)      # [B]
        active = (~s.done) & (s.hops < cfg.max_hops)
        slot_live = torch.isfinite(beam_d) & (beam_d <= upper[:, None]) \
            & active[:, None]                                         # [B, W]
        # keep the per-query hop budget exact
        budget = cfg.max_hops - s.hops
        slot_live = slot_live & (torch.cumsum(slot_live, dim=1, dtype=_I32)
                                 <= budget[:, None])
        s.done |= ~slot_live.any(dim=1)

        c = torch.where(slot_live, pool_id.gather(1, beam_idx), n)    # [B, W]
        dc = pool_d.gather(1, beam_idx)                               # [B, W]
        if self.sq8_on:
            # stage-2 rerank at expansion: an approximate entry picked for
            # the beam gets its exact distance (and loses its flag) before
            # that distance is used as d(c, q) for the tile's estimates
            apx = pool_apx.gather(1, beam_idx)
            sel_apx = apx & slot_live
            dc = torch.where(sel_apx, self.rerank(s, c, sel_apx), dc)
            pool_d.scatter_(1, beam_idx, dc)
            pool_apx.scatter_(1, beam_idx, apx & ~sel_apx)
            nrr = sel_apx.sum(1, dtype=_I32)
            s.rrcalls += nrr
            s.dcalls += nrr
        pool_exp.scatter_(1, beam_idx, pool_exp.gather(1, beam_idx) | slot_live)

        # --- dense [B, W*M] neighbour tile ---------------------------------
        ph.to("hop.tile")
        cl = c.long()
        nbrs = arrays["neighbors"][cl].reshape(B, L)                  # [B, L]
        # stored edge distances may be bf16; the estimate math is f32
        ed = arrays["edge_eu"][cl].to(torch.float32).reshape(B, L)
        nbl = nbrs.long()
        st = s.status.gather(1, nbl)                                  # [B, L]
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
        if rt.prunes:
            try_prune = first & (st == STATUS_UNVISITED) & pool_full[:, None]
            if W > 1 and cfg.beam_prune == "best":
                # slot 0 is the node sequential search would expand now;
                # only its lanes run the estimate test
                try_prune = try_prune & s.best_slot
            if rt.counts_est:
                s.ecalls += try_prune.sum(1, dtype=_I32)
        else:
            try_prune = torch.zeros_like(first)

        if not rt.prunes or self.kernel_prunes:
            prune = torch.zeros_like(first)
        elif engine == "unfused" and rt.kernel_estimate:
            prune = ops.crouting_prune(ed, dcq_w, bound2, try_prune,
                                       self.ct_eff)[1]
        else:
            ctx = RouterContext(
                arrays=arrays, queries=queries, nq=nq, c=c, dc=dc, nbrs=nbrs,
                ed=ed, dcq=dcq_w.reshape(B, L), nx=nx, try_prune=try_prune,
                upper=upper, cos_theta=self.cos_theta, metric=metric, n=n,
                beam_width=W, max_degree=M)
            est_rank, extra_inc = rt.estimate_rank(ctx)
            prune = try_prune & (est_rank >= upper[:, None])
            for k, v in s.extras.items():
                if k in extra_inc:
                    v += extra_inc[k]

        if self.rescue:
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
        if self.sq8_on:
            # stage 1: uint8 code rows -> estimate + lower bound for every
            # surviving lane; no fp32 row is read here (that is stage 2)
            sq8_args = (arrays["sq8_codes"], arrays["sq8_lo"],
                        arrays["sq8_scale"], arrays["sq8_eps"])
            if self.kernels:
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
            s.sqcalls += compute.sum(1, dtype=_I32)
            new_d = torch.where(insert, ad_rank, inf)
        else:
            # exact fp32 distances (pruned/masked lanes load no row)
            if engine == "fused":
                d2eu, prune_k = ops.fused_expand(
                    nbrs, queries, ed, dcq_w, bound2, self.ct_eff, vecs,
                    eval_mask=compute,
                    prune_eligible=try_prune if self.kernel_prunes else None,
                    prunes=self.kernel_prunes)
                if self.kernel_prunes:
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
            s.dcalls += compute.sum(1, dtype=_I32)

        # --- status scatter: unchanged lanes write the pad column's own
        # value to the pad column, so the scatter stays deterministic -------
        ph.to("hop.status")
        change = compute | prune
        if rt.prunes:
            s.pruned += prune.sum(1, dtype=_I32)
        if rt.permanent:
            new_st = torch.full_like(st, STATUS_VISITED)
        else:
            new_st = torch.where(insert, STATUS_VISITED, STATUS_PRUNED
                                 ).to(torch.uint8)
        pad_val = s.status[:, n:n + 1].expand(B, L)
        s.status.scatter_(1, torch.where(change, nbl, n),
                          torch.where(change, new_st, pad_val))

        # --- pool merge (merge-then-truncate == evolving-bound insertion),
        # written back into the state's pool ------------------------------
        ph.to("hop.merge")
        new_id = torch.where(insert, nbrs, n)
        new_apx = insert if self.sq8_on else torch.zeros_like(insert)
        if self.kernels:
            # the approx and expanded flags ride the merge in the id's low
            # bits: id*4 + approx*2 + (not expanded).  Two entries can share
            # (dist, id) only when an adjacency row names a node twice (an
            # NSG's orphan edges can): the beam expands the first copy, and
            # the torch engine's stable sort keeps it first; with the bit
            # set for an unexpanded entry the kernel orders them the same
            enc_pool = (pool_id * 4 + pool_apx.to(_I32) * 2
                        + (~pool_exp).to(_I32))
            merged_d, enc = ops.pool_merge(pool_d, enc_pool, new_d,
                                           new_id * 4 + new_apx.to(_I32) * 2
                                           + 1)
            pool_d.copy_(merged_d)
            torch.bitwise_right_shift(enc, 2, out=pool_id)
            torch.eq(enc & 2, 2, out=pool_apx)
            torch.eq(enc & 1, 0, out=pool_exp)
        else:
            md = torch.cat([pool_d, new_d], dim=1)
            mi = torch.cat([pool_id, new_id], dim=1)
            me = torch.cat([pool_exp, torch.zeros_like(insert)], dim=1)
            ma = torch.cat([pool_apx, new_apx], dim=1)
            # lexicographic (dist, id): the kernel's tie-break
            order = _lexsort_dist_id(md, mi)[:, :efs]
            for src, dst in ((md, pool_d), (mi, pool_id), (me, pool_exp),
                             (ma, pool_apx)):
                torch.gather(src, 1, order, out=dst)

        s.hops += slot_live.sum(1, dtype=_I32)


class _HopGraph:
    """One batch shape's hop state and the iterations captured on it.

    ``graphs`` maps a ``_Hop.graph_key`` to a CUDA graph of one
    ``_Hop.step`` on ``state`` captured for that key, never replayed for
    another, and the kernel launches of one replay: ``HOP_GRAPH_KEYS`` of
    them at most (cos(theta*) values, mostly), the least recently used
    dropped first.  They share one memory pool, as one call at a time
    replays them: the one that holds ``lock``.  ``nbytes`` is the state's
    size (``_HopState.nbytes``) and ``used`` orders the slots of every
    engine by their last use (``HopGraphs``)."""

    def __init__(self, dev: torch.device, nbytes: int):
        self.lock = threading.Lock()
        self.dev, self.nbytes, self.used = dev, nbytes, 0
        self.state: Optional[_HopState] = None
        self.graphs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.pool = None
        self.stream = None

    def find(self, key) -> Optional[tuple]:
        """The ``(graph, launches)`` captured for ``key``, or None."""
        entry = self.graphs.get(key)
        if entry is not None:
            self.graphs.move_to_end(key)
        return entry

    def capture(self, hop: _Hop, key) -> tuple:
        """Capture ``hop.step(self.state)`` for ``key``, which has then not
        run: ``replay`` runs it."""
        dev = self.state.done.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        g = torch.cuda.CUDAGraph()
        # capture on a stream of its own (the default stream cannot be
        # captured); "thread_local": another thread's search is no error
        with torch.cuda.stream(self.stream), \
                ops.recording_launches() as launched:
            g.capture_begin(pool=self.pool,
                            capture_error_mode="thread_local")
            try:
                hop.step(self.state, trace.NO_PHASES)
            finally:
                g.capture_end()
        entry = self.graphs[key] = (g, launched)
        while len(self.graphs) > HOP_GRAPH_KEYS:
            self.graphs.popitem(last=False)
        trace.add("search.graph_captures", 1)
        return entry

    @staticmethod
    def replay(entry: tuple) -> None:
        graph, launches = entry
        graph.replay()
        ops.add_launches(launches)


HOP_GRAPHS_MAX = 8           # batch shapes an engine keeps
HOP_GRAPH_KEYS = 4           # graphs a batch shape keeps
HOP_GRAPHS_MEMORY_SHARE = 0.25
_SLOTS_LOCK = threading.Lock()      # guards every HopGraphs' slots
_ALL_GRAPHS = weakref.WeakSet()     # guarded by: _SLOTS_LOCK
_USES = itertools.count(1)


def _memory_budget(dev: torch.device) -> int:
    """The most the kept hop states of every engine on ``dev`` may hold:
    ``HOP_GRAPHS_MEMORY_SHARE`` of its memory."""
    return int(HOP_GRAPHS_MEMORY_SHARE
               * torch.cuda.get_device_properties(dev).total_memory)


def _make_room(dev: torch.device, nbytes: int) -> bool:
    """Drop idle slots of any engine on ``dev``, least recently used first,
    until ``nbytes`` more fit the budget; False if they do not (``_SLOTS_LOCK``
    held)."""
    budget = _memory_budget(dev)
    if nbytes > budget:
        return False
    kept = [(slot.used, graphs, shape, slot)
            # repolint: ignore[guarded-by] caller holds _SLOTS_LOCK
            for graphs in list(_ALL_GRAPHS)
            for shape, slot in graphs._slots.items() if slot.dev == dev]
    held = sum(k[3].nbytes for k in kept)
    for _, graphs, shape, slot in sorted(kept, key=lambda k: k[0]):
        if held + nbytes <= budget:
            break
        if slot.lock.acquire(blocking=False):       # idle: drop it
            del graphs._slots[shape]
            held -= slot.nbytes
            slot.lock.release()
    return held + nbytes <= budget


class HopGraphs:
    """The captured hop iterations of one engine, a ``_HopGraph`` for each
    batch shape, whose state holds the ``[B, n+1]`` status (10 GB at
    B = 10,000 and n = 1M).  Two bounds, the least recently used slot
    dropped first (its graphs and state are freed once no call holds
    them): ``HOP_GRAPHS_MAX`` shapes an engine, and the states of every
    engine on a device together within ``HOP_GRAPHS_MEMORY_SHARE`` of its
    memory.  A shape whose state does not fit runs eagerly, on a state
    freed after the call, as it would without graphs.

    ``captures_on_this_thread`` counts the captures the calling thread
    made through this engine's slots (``SearchEngine.first_uses``)."""

    def __init__(self):
        # under the module's _SLOTS_LOCK, which every engine's slots share
        self._slots: "OrderedDict[tuple, _HopGraph]" = OrderedDict()
        self._mine = threading.local()
        with _SLOTS_LOCK:
            _ALL_GRAPHS.add(self)

    def __len__(self) -> int:
        with _SLOTS_LOCK:
            return len(self._slots)

    def acquire(self, shape, dev: torch.device, nbytes: int
                ) -> Optional[_HopGraph]:
        """The slot of ``shape`` (a state of ``nbytes`` on ``dev``) with its
        lock taken, or None: another call holds it (that call never waits,
        and runs eagerly), or its state does not fit the budget."""
        with _SLOTS_LOCK:
            slot = self._slots.get(shape)
            if slot is None:
                if not _make_room(dev, nbytes):
                    return None
                slot = self._slots[shape] = _HopGraph(dev, nbytes)
                while len(self._slots) > HOP_GRAPHS_MAX:
                    self._slots.popitem(last=False)
            else:
                self._slots.move_to_end(shape)
            slot.used = next(_USES)
        return slot if slot.lock.acquire(blocking=False) else None

    def captured(self) -> None:
        self._mine.captures = self.captures_on_this_thread() + 1

    def captures_on_this_thread(self) -> int:
        return getattr(self._mine, "captures", 0)


def _graph_slot(graphs: Optional[HopGraphs], dev: torch.device, rt,
                shape, nbytes: int) -> Optional[_HopGraph]:
    """The slot of ``shape`` in ``graphs``, its lock taken, where the hop
    loop may capture and replay its iteration: on a CUDA device, under a
    router that declares itself ``graph_safe``.  Else None: the loop runs
    eagerly."""
    if graphs is None or dev.type != "cuda" or not rt.graph_safe:
        return None
    return graphs.acquire(shape, dev, nbytes)


def _search_batch(arrays, queries, cos_theta, cfg: SearchSpec, valid=None,
                  tombstone=None, graphs: Optional[HopGraphs] = None
                  ) -> SearchResult:
    """Whole-batch Algorithm 1/2 with W-wide beam expansion per iteration.

    ``valid`` ([B] bool, optional) marks the real query lanes of a padded
    batch: padded lanes start done, never expand a node, and count zero in
    every counter.  ``tombstone`` ([n+1] bool, pad row False, optional)
    marks deleted nodes: they keep routing, but are masked out of the
    result pool after the loop (id -> n, dist -> +inf), before the sq8
    path's final rerank, then re-sorted.

    Each iteration is ``_Hop.step`` on a ``_HopState``.  Given ``graphs``,
    on a CUDA device and under a router that declares itself
    ``graph_safe``, the state is the batch shape's own in ``graphs``: the
    first iteration of a key (``_Hop.graph_key``: cos(theta*), the arrays'
    addresses) the shape has no graph for runs eagerly, the next captures
    the iteration as a CUDA graph for that key, and from then on (this
    call's iterations and later calls' with that key) each iteration
    replays it.  A call that finds the shape's state in use, or whose state
    does not fit ``HopGraphs``' memory budget, runs eagerly on a state of
    its own.  The host's loop, its
    ``max_hops`` bound and its one ``done.all()`` read an iteration are
    the same either way.

    Its phases are spans of ``repro_torch.trace``: ``search.init``, then an
    iteration ``hop`` each with ``hop.sync`` (the one host sync), then
    ``hop.beam``, ``hop.tile``, ``hop.route``, ``hop.dist``, ``hop.status``
    and ``hop.merge`` (or ``hop.replay``, after ``hop.capture`` where it
    captures), then ``search.final``.  The loop's host time, split into the
    time blocked in the sync and the rest, and the number of replays add
    to the engine call in progress (``trace.hop_loop``).
    """
    metric, efs, n = cfg.metric, cfg.efs, arrays["n"]
    W, engine = cfg.beam_width, cfg.engine
    rt = get_router(cfg.router)
    if not 1 <= W <= efs:
        raise ValueError("beam_width must be in [1, efs]")
    if cfg.estimate in ("angle", "both") and not rt.prunes:
        raise ValueError(f"estimate={cfg.estimate!r} needs a pruning router, "
                         f"got {cfg.router!r}")
    if engine in ("fused", "unfused") and n >= 2 ** 29:
        raise ValueError("the kernel engines encode ids as id*4+flags in "
                         "int32: shard below 2^29 vectors or use "
                         "engine='torch'")
    ph = trace.phases()
    ph.to("search.init")
    dev = queries.device
    vecs = arrays["vectors"]
    queries = queries.to(torch.float32).contiguous()
    # the engine's cos(theta*) is an f32 value, as the JAX engine's traced
    # f32 scalar is
    hop = _Hop(arrays, cfg, rt, float(np.float32(cos_theta)))
    B = queries.shape[0]
    inf = float("inf")

    nq = (torch.linalg.norm(queries, dim=1) if metric != "l2"
          else torch.ones((B,), dtype=torch.float32, device=dev))

    if cfg.use_hierarchy:
        entry, d_entry, calls0 = _descend(arrays, queries, metric)
    else:
        entry = torch.full((B,), arrays["entry"], dtype=_I32, device=dev)
        d_entry = _rank_tile(queries, vecs[entry.long()][:, None, :], metric)[:, 0]
        calls0 = torch.ones((B,), dtype=_I32, device=dev)
    if valid is not None:
        valid = valid.to(device=dev, dtype=torch.bool)

    dims = (B, queries.shape[1], efs, n, hop.L, hop.M, rt.extra_counters)
    slot = _graph_slot(graphs, dev, rt, dims + (valid is not None, str(dev)),
                       _HopState.nbytes(*dims))
    entry_graph = None
    try:
        if slot is None:
            s = _HopState(*dims, dev)
        else:
            if slot.state is None:
                slot.state = _HopState(*dims, dev)
            s = slot.state
            key = hop.graph_key()
            entry_graph = slot.find(key)
        s.start(queries, nq, entry, d_entry, calls0, valid, n)

        iters = graph_iters = 0
        t_loop, sync_ns = time.perf_counter_ns(), 0
        while iters < cfg.max_hops:
            ph.hop()
            # --- the iteration's one host sync: is every query done? ------
            ph.to("hop.sync")
            all_done = s.done.all()
            t0 = time.perf_counter_ns()
            finished = bool(all_done)
            sync_ns += time.perf_counter_ns() - t0
            if finished:
                break
            # on the shape's own state: the first iteration eager, then
            # the captured one replayed
            if slot is not None and (entry_graph is not None or iters > 0):
                if entry_graph is None:
                    ph.to("hop.capture")
                    entry_graph = slot.capture(hop, key)
                    graphs.captured()
                ph.to("hop.replay")
                slot.replay(entry_graph)
                graph_iters += 1
            else:
                hop.step(s, ph)
            iters += 1
        trace.hop_loop(iters, time.perf_counter_ns() - t_loop - sync_ns,
                       sync_ns, graph_iters)

        ph.to("search.final")
        pool_d, pool_id = s.pool_d, s.pool_id
        dcalls, ecalls, rrcalls, sqcalls, hops, pruned, extras = (
            s.dcalls, s.ecalls, s.rrcalls, s.sqcalls, s.hops, s.pruned,
            s.extras)
        # the loop's first-stage lanes: stage 1 on the sq8 path, else every
        # exact distance but the entry's (and the descent's)
        first = sqcalls if hop.sq8_on else dcalls - calls0
        if tombstone is not None:
            # emission-time masking: dead entries routed normally; here they
            # collapse to the pad sentinel, so neither the final rerank nor
            # the caller ever sees them
            dead = tombstone.to(dev)[pool_id.long()]
            pool_d = torch.where(dead, inf, pool_d)
            pool_id = torch.where(dead, n, pool_id)
        if hop.sq8_on:
            # stage-2 final rerank: every approximate survivor still in the
            # pool gets its exact distance; entries displaced earlier never
            # paid their fp32 row
            mask = s.pool_apx & (pool_id < n)
            pool_d = torch.where(mask, hop.rerank(s, pool_id, mask), pool_d)
            nrr = mask.sum(1, dtype=_I32)
            rrcalls = rrcalls + nrr
            dcalls = dcalls + nrr
        if hop.sq8_on or tombstone is not None:
            order = _lexsort_dist_id(pool_d, pool_id)
            pool_d, pool_id = pool_d.gather(1, order), pool_id.gather(1, order)
        if valid is not None:
            dcalls, ecalls, rrcalls, sqcalls, hops, pruned, first = (
                torch.where(valid, a, 0)
                for a in (dcalls, ecalls, rrcalls, sqcalls, hops, pruned,
                          first))
            extras = {k: torch.where(valid, v, 0) for k, v in extras.items()}
        res = SearchResult(ids=pool_id, dists=pool_d, dist_calls=dcalls,
                           est_calls=ecalls, hops=hops, iters=iters,
                           rerank_calls=rrcalls, sq8_calls=sqcalls,
                           extra=extras, pruned=pruned, first_stage=first)
        if slot is not None:
            # the shape's state is the next call's to overwrite
            res = res._replace(
                extra={k: v.clone() for k, v in res.extra.items()},
                **{f: getattr(res, f).clone() for f in _RESULT_TENSORS})
    finally:
        if slot is not None:
            slot.lock.release()
    ph.close()
    return res


# --- engine cache ------------------------------------------------------------
# Device arrays are cached per (graph, device), shared by every spec that
# searches that graph; bound engines per (graph identity, canonical spec,
# router, tombstones, device).  Weakrefs guard against id() reuse after gc,
# and dead-graph entries are purged on every call so their device tensors
# do not stay pinned.  ``_ENGINE_CACHE`` holds at most ``_ENGINE_CACHE_MAX``
# engines; a caller that must not pay an evicted engine's setup again (a
# serving session, a mutable index's snapshot) holds its engine and calls
# it directly.  An engine's captured hop graphs and their state go with it.
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
    may run ``nvcc``), and each capture of a hop graph on a batch shape
    it has run before (a cos(theta*) or an array address the shape has no
    graph for, or a shape whose slot ``HopGraphs`` dropped); a shape's
    first capture falls inside that shape's first use.  ``first_uses()``
    reads it, where the JAX package reads a jitted function's
    ``_cache_size()``.  Each call is also one record of
    ``repro_torch.trace``'s call log (``trace.call``), marked
    ``first_use`` by the same test.  Its hop iterations replay from
    ``graphs`` (``HopGraphs``) on a CUDA device.
    """

    def __init__(self, g: GraphIndex, arrays, cfg: SearchSpec,
                 tombstones: bool, dev: torch.device):
        self.graph_ref = weakref.ref(g)
        self.arrays = arrays
        self.cfg = cfg
        self.tombstones = tombstones
        self.dev = dev
        self.graphs = HopGraphs()
        self._lock = threading.Lock()
        self._shapes: set = set()       # guarded by: self._lock
        self._loads = 0                 # guarded by: self._lock
        self._recaptures = 0            # guarded by: self._lock

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
            caps0 = self.graphs.captures_on_this_thread()
            res = _search_batch(self.arrays, q, cos_theta, self.cfg,
                                tombstone=tombstone, graphs=self.graphs)
            loads = build.first_loads_on_this_thread() - loads0
            caps = self.graphs.captures_on_this_thread() - caps0
            shape = tuple(q.shape)
            with self._lock:
                new = shape not in self._shapes
                rec.first_use = loads > 0 or new or caps > 0
                self._shapes.add(shape)
                self._loads += loads
                self._recaptures += 0 if new else caps
            rec.rows = shape[0]
        return res

    def first_uses(self) -> int:
        """Setup (1) + batch shapes run + kernel libraries first loaded +
        captures on shapes run before."""
        with self._lock:
            return 1 + len(self._shapes) + self._loads + self._recaptures


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
    if dev.type == "cuda" and g.metric == "cosine":
        # search_on normalises a cosine batch on the card
        # (distances.prepare_queries): its library loads, or builds, here
        build.load("normalize_rows")
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
