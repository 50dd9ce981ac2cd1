"""Plain PyTorch versions of the port's kernels (the CPU path and the
oracles the CUDA kernels are held against on the card).

Counterpart of ``repro.kernels.ref``.  Two deliberate orders make the
kernels' outputs reproducible bit for bit in plain PyTorch:

* every per-row sum (``l2sq_rows``, and the ``ad2`` and slack sums of
  ``sq8_estimate_ref``) goes through ``warp_order_sum``, which adds in the
  CUDA kernels' order (see its docstring), so a kernel's distances equal
  the plain engine's exactly and the two engines walk the same graph path;
* the edge-angle estimate is evaluated as
  ``(ed*ed + dcq*dcq) - ((2*ed)*dcq)*ct`` with each product and sum rounded
  separately (the CUDA kernels use ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``
  so that nvcc cannot contract them into FMAs), then clamped at 0 with NaN
  kept, as ``jnp.maximum`` keeps it.
"""
from __future__ import annotations

import math

import torch

# The CUDA kernels read a row in chunks of 4 elements, 128 elements per warp
# pass: lane t of pass j holds elements 128*j + 4*t + c, c = 0..3.
_WARP = 32
_VEC = 4
_PASS = _WARP * _VEC

_INF = float("inf")


def warp_order_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum ``terms [..., d]`` over the last axis in the kernels' order.

    Per warp lane t the kernel accumulates the terms of elements e = 128*j +
    4*t + c in (j, c) order, starting from 0, then sums the 32 lane partials
    with a ``__shfl_xor_sync`` butterfly (strides 16, 8, 4, 2, 1).  Padding
    d to a multiple of 128 with zeros adds exact zeros, so every d follows
    the same formula.
    """
    terms = terms.to(torch.float32)
    lead, d = terms.shape[:-1], terms.shape[-1]
    pad = (-d) % _PASS
    if pad:
        terms = torch.nn.functional.pad(terms, (0, pad))
    terms = terms.reshape(*lead, -1, _WARP, _VEC)
    acc = torch.zeros((*lead, _WARP), dtype=torch.float32,
                      device=terms.device)
    for j in range(terms.shape[-3]):
        for c in range(_VEC):
            acc = acc + terms[..., j, :, c]
    width = _WARP
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc[..., 0]


def l2sq_rows(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance of each query to its rows, in the kernels' order.

    q ``[B, d]``, rows ``[B, L, d]`` -> ``[B, L]`` float32: the squared
    differences summed by ``warp_order_sum``.
    """
    diff = rows.to(torch.float32) - q.to(torch.float32)[:, None, :]
    return warp_order_sum(diff * diff)


def edge_angle_est2(ed, dcq, cos_theta: float) -> torch.Tensor:
    """``max(ed^2 + dcq^2 - 2*ed*dcq*cos_theta, 0)`` in the kernels' order
    (NaN propagates, as in ``jnp.maximum``)."""
    est2 = (ed * ed + dcq * dcq) - ((2.0 * ed) * dcq) * float(cos_theta)
    return torch.where(est2 < 0, torch.zeros_like(est2), est2)


def l2_distance_ref(q, x, mode: str = "l2"):
    """The distance matrix [Q, C] f32 of q [Q, d] against x [C, d] (f32 or
    bf16, upcast to f32): ``max(|q|^2 + |x|^2 - 2 q.x^T, 0)`` in l2 mode,
    ``1 - q.x^T`` in ip mode (NaN propagates, as in ``jnp.maximum``)."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if mode == "l2":
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        xn = torch.sum(x * x, dim=-1)
        return torch.clamp_min(qn + xn[None, :] - 2.0 * q @ x.T, 0.0)
    return 1.0 - q @ x.T


def crouting_prune_ref(ed, dcq, bound2, valid, cos_theta):
    """dcq/bound2: [B] (broadcast) or per-lane [B, M] (beam tiles).  The
    prune mask is bool, as the kernel writes it."""
    ed = ed.to(torch.float32)
    dcq = dcq.to(torch.float32)
    if dcq.ndim == 1:
        dcq = dcq[:, None]
    if bound2.ndim == 1:
        bound2 = bound2[:, None]
    est2 = edge_angle_est2(ed, dcq, cos_theta)
    return est2, (valid != 0) & (est2 >= bound2)


def fused_expand_ref(nbrs, queries, ed, dcq, bound2, cos_theta, table,
                     eval_mask, prune_eligible):
    """Plain version of the fused CRouting expansion.

    ``eval_mask``/``prune_eligible`` are taken as given: the ops wrapper has
    already intersected them with "id in range" (the JAX oracle
    ``repro.kernels.ref.fused_expand_ref`` does not intersect caller
    masks; ``repro.kernels.ops.fused_expand`` does, and so does the port).
    Lanes that are not evaluated or are pruned read the pad row (the
    table's last row) here and report +inf.  ``prune`` is bool, as the
    kernel writes it.
    """
    n = table.shape[0]
    if dcq.ndim == 1:
        dcq = dcq[:, None]
    if bound2.ndim == 1:
        bound2 = bound2[:, None]
    est2 = edge_angle_est2(ed.to(torch.float32), dcq.to(torch.float32),
                           cos_theta)
    prune = (prune_eligible != 0) & (est2 >= bound2)
    fetch = (eval_mask != 0) & ~prune
    safe = torch.where(fetch, nbrs, n - 1).long()
    d2 = l2sq_rows(queries, table[safe])
    d2 = torch.where(fetch, d2, torch.full_like(d2, float("inf")))
    return d2, prune


def pool_merge_ref(pool_d, pool_i, new_d, new_i):
    """Best P of the union of a pool (sorted or not) and new candidates,
    ordered by (dist, id): a stable sort by id, then a stable sort by
    distance."""
    d = torch.cat([pool_d, new_d], dim=1)
    i = torch.cat([pool_i, new_i], dim=1)
    o = torch.sort(i, dim=1, stable=True).indices
    d, i = d.gather(1, o), i.gather(1, o)
    o = torch.sort(d, dim=1, stable=True).indices
    P = pool_d.shape[1]
    return d.gather(1, o)[:, :P], i.gather(1, o)[:, :P]


def in_range(ids, n_rows):
    """Ids that name a row of an ``n_rows``-row table."""
    return (ids >= 0) & (ids < n_rows)


def sq8_estimate_ref(nbrs, queries, eval_mask, codes, lo, scale, eps):
    """Plain version of the SQ8 stage-1 kernel: dequantize each lane's code
    row, then ``repro_torch.quant.sq8.sq8_estimate`` (the one bound
    implementation).  Lanes not evaluated, or with ids outside
    ``[0, codes.shape[0])``, report +inf in both outputs."""
    from repro_torch.quant.sq8 import sq8_dequantize_rows, sq8_estimate

    n = codes.shape[0]
    fetch = in_range(nbrs, n)
    if eval_mask is not None:
        fetch = fetch & (eval_mask != 0)
    safe = torch.where(fetch, nbrs, n - 1).long()
    xhat = sq8_dequantize_rows(codes[safe], lo, scale)       # [B, L, d]
    ad2, lb2 = sq8_estimate(queries, xhat, eps)
    return (torch.where(fetch, ad2, _INF), torch.where(fetch, lb2, _INF))


def gather_distance_ref(indices, queries, table, skip=None):
    """``dist2[b, m] = |q_b - table[indices[b, m]]|^2`` in the kernels'
    order.  Lanes marked in ``skip`` (int8/bool, optional) or with ids
    outside ``[0, table.shape[0])`` read no row and report +inf."""
    n = table.shape[0]
    fetch = in_range(indices, n)
    if skip is not None:
        fetch = fetch & (skip == 0)
    safe = torch.where(fetch, indices, n - 1).long()
    d2 = l2sq_rows(queries, table[safe])
    return torch.where(fetch, d2, _INF)


def gather_distance_pruned_ref(nbr_ids, prune_mask, queries, table):
    """The exact path under a prune mask: pruned lanes report +inf."""
    return gather_distance_ref(nbr_ids, queries, table, skip=prune_mask)


def segment_sum_ref(data, seg_ids, num_segments: int):
    """``out[s] = sum of data[i] over seg_ids[i] == s`` for ``data [N,
    *tail]``, as ``index_add_`` into zeros adds on the CPU: in increasing
    ``i``, starting from +0; an empty segment is 0.  fp32 data is summed
    in fp32; bf16 data in an fp32 accumulator, rounded to bf16 once at the
    end (the CPU's ``index_add_`` of a 2-D bf16 tensor gives the same
    bits).  ``csrc/segment_sum.cu`` equals this bit for bit."""
    tail = tuple(data.shape[1:])
    rows = data.reshape(data.shape[0], math.prod(tail))
    acc = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros((num_segments, rows.shape[1]), dtype=acc,
                      device=data.device)
    out.index_add_(0, seg_ids.reshape(-1).long(), rows.to(acc))
    return out.to(data.dtype).reshape((num_segments,) + tail)
