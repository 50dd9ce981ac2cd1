"""Public wrappers around the port's CUDA kernels.

The counterpart of ``repro.kernels.ops``.  Each wrapper normalises shapes
and dtypes, applies the masking contract, and then dispatches on where its
tensors lie:

* CUDA tensors launch the hand-written kernel (``csrc/*.cu``, built with
  nvcc on first use) and add one to the wrapper's launch count.  A failed
  build or launch raises; nothing falls back to the plain version.
* CPU tensors run the plain PyTorch version (``repro_torch.kernels.ref``).

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that the
main path went through the kernels (``chip_smoke.py`` resets and reads it).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"fused_expand": 0, "pool_merge": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lanes(x, B, L, dtype):
    """[B] (broadcast over lanes) or [B, L] -> contiguous [B, L] ``dtype``."""
    x = x.to(dtype)
    if x.ndim == 1:
        x = x[:, None].expand(B, L)
    return x.contiguous()


def prepare_fused_expand(nbrs, queries, ed, dcq, bound2, cos_theta, table,
                         eval_mask=None, prune_eligible=None):
    """The arguments ``fused_expand`` hands to its kernel (or plain
    version): contiguous [B, L] lanes, int8 masks intersected with the
    in-range ids, and ``cos_theta`` rounded to f32."""
    B, L = nbrs.shape
    nbrs = nbrs.to(torch.int32).contiguous()
    in_range = (nbrs >= 0) & (nbrs < table.shape[0])
    eval_mask = in_range if eval_mask is None else (eval_mask != 0) & in_range
    prune_eligible = (in_range if prune_eligible is None
                      else (prune_eligible != 0) & in_range)
    return (nbrs, queries.to(torch.float32).contiguous(),
            _lanes(ed, B, L, torch.float32), _lanes(dcq, B, L, torch.float32),
            _lanes(bound2, B, L, torch.float32),
            float(torch.tensor(float(cos_theta), dtype=torch.float32)),
            table, eval_mask.to(torch.int8).contiguous(),
            prune_eligible.to(torch.int8).contiguous())


def fused_expand(nbrs, queries, ed, dcq, bound2, cos_theta, table,
                 eval_mask=None, prune_eligible=None):
    """Fused CRouting expansion: estimate + prune + conditional row load +
    exact squared L2 distance in one kernel (the paper's Alg. 2 inner loop).

    nbrs [B, L] ids into ``table`` [N, d]; dcq/bound2 [B] or per-lane
    [B, L].  ``eval_mask`` marks lanes to evaluate exactly when not pruned,
    ``prune_eligible`` the lanes the estimate test applies to; both default
    to "id in range".  As in ``repro.kernels.ops.fused_expand`` (and unlike
    the JAX oracle ``repro.kernels.ref.fused_expand_ref``), both masks are
    always intersected with ``0 <= nbr < N``: the kernel reads rows
    unchecked.  Returns (dist2 [B, L] f32 with +inf for pruned/masked lanes,
    prune [B, L] int8).
    """
    args = prepare_fused_expand(nbrs, queries, ed, dcq, bound2, cos_theta,
                                table, eval_mask, prune_eligible)
    if args[0].is_cuda:
        from repro_torch.kernels.fused_expand import fused_expand_cuda
        out = fused_expand_cuda(*args)
        LAUNCHES["fused_expand"] += 1
        return out
    return ref.fused_expand_ref(*args)


def pool_merge(pool_d, pool_i, new_d, new_i):
    """Merge new candidates into sorted pools and keep the best P, ordered
    by (dist, id).  pool_d/i [B, P] sorted, new_d/i [B, L]."""
    args = (pool_d.to(torch.float32).contiguous(),
            pool_i.to(torch.int32).contiguous(),
            new_d.to(torch.float32).contiguous(),
            new_i.to(torch.int32).contiguous())
    if pool_d.is_cuda:
        from repro_torch.kernels.pool_merge import pool_merge_cuda
        out = pool_merge_cuda(*args)
        LAUNCHES["pool_merge"] += 1
        return out
    return ref.pool_merge_ref(*args)
