"""Public wrappers around the port's CUDA kernels.

The counterpart of ``repro.kernels.ops``.  Each wrapper normalises shapes
and dtypes, applies the masking contract, and then dispatches on where its
tensors lie (``fused_expand``, ``sq8_estimate``, the gather wrappers and
``crouting_prune`` leave the range check, strided operands and the mask
forms to their kernels, so that on the search loop's tensors nothing runs
before the launch but the output allocations):

* CUDA tensors launch the hand-written kernel (``csrc/*.cu``, built with
  nvcc on first use) and add one to the wrapper's launch count.  A failed
  build or launch raises; nothing falls back to the plain version.
* CPU tensors run the plain PyTorch version (``repro_torch.kernels.ref``).

``LAUNCHES`` counts launches per kernel (``gather_distance`` serves the
three gather wrappers), so a run can show that the main path went through
the kernels (``chip_smoke.py`` resets and reads it); each thread's own
launches are counted besides (``thread_launch_counts``).  A launch issued
while a CUDA graph is captured runs nothing then: ``recording_launches``
collects those instead, and ``add_launches`` counts them again at each
replay of the graph.

``normalize_rows`` (a cosine index's query rows, ``kernels/normalize_rows.py``)
is exposed here too; it runs outside the hop loop and counts its launches
in its own module's ``LAUNCHES``, as ``segment_sum`` does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.normalize_rows import normalize_rows  # noqa: F401

LAUNCHES: Dict[str, int] = {"fused_expand": 0, "pool_merge": 0,
                            "sq8_distance": 0, "gather_distance": 0,
                            "crouting_prune": 0, "l2_distance": 0}


_LAUNCH_LOCK = threading.Lock()
_THREAD = threading.local()     # .launches: this thread's counts


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _launched(name: str) -> None:
    """Count one launch of ``name``: in ``LAUNCHES`` and in the calling
    thread's own counts (inside ``recording_launches``: in its record)."""
    rec = getattr(_THREAD, "recording", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    add_launches({name: 1})


def add_launches(counts: Dict[str, int]) -> None:
    """Count ``counts[name]`` launches of each ``name``: in ``LAUNCHES``
    and in the calling thread's own counts."""
    with _LAUNCH_LOCK:
        for name, k in counts.items():
            LAUNCHES[name] += k
    mine = getattr(_THREAD, "launches", None)
    if mine is None:
        mine = _THREAD.launches = dict.fromkeys(LAUNCHES, 0)
    for name, k in counts.items():
        mine[name] += k


@contextlib.contextmanager
def recording_launches():
    """Count none of the calling thread's launches inside the block; yields
    a dict that collects them by kernel instead (the launches of a CUDA
    graph's capture, which ``add_launches`` counts at each replay)."""
    rec: Dict[str, int] = {}
    _THREAD.recording = rec
    try:
        yield rec
    finally:
        _THREAD.recording = None


def thread_launch_counts() -> Dict[str, int]:
    """The launches made by the calling thread since it started (a merge
    thread's build, apart from the searches served beside it)."""
    return dict(getattr(_THREAD, "launches", None)
                or dict.fromkeys(LAUNCHES, 0))


def _lanes(x, B, L, dtype):
    """[B] (broadcast over lanes), [B, L] or [B, W, M] (W*M == L) ->
    contiguous [B, L] ``dtype``."""
    x = x.to(dtype)
    if x.ndim == 1:
        x = x[:, None].expand(B, L)
    return x.reshape(B, L).contiguous()


def _f32(x):
    return x.to(torch.float32).contiguous()


def _f32_scalar(x) -> float:
    """A Python scalar rounded to f32, as the kernels take it."""
    return float(np.float32(x))


def _mask_bytes(x):
    """A mask as the kernels read it: bool or int8 bytes as given, else
    ``!= 0``."""
    if x is None:
        return None
    if x.dtype not in (torch.bool, torch.int8, torch.uint8):
        x = x != 0
    return x.contiguous()


def prepare_fused_expand(nbrs, queries, ed, dcq, bound2, cos_theta, table,
                         eval_mask=None, prune_eligible=None, prunes=True):
    """The plain version's arguments: contiguous [B, L] lanes, int8 masks
    intersected with the in-range ids (``prunes=False``: no lane is
    prune-eligible), and ``cos_theta`` rounded to f32."""
    B, L = nbrs.shape
    nbrs = nbrs.to(torch.int32).contiguous()
    in_range = ref.in_range(nbrs, table.shape[0])
    eval_mask = in_range if eval_mask is None else (eval_mask != 0) & in_range
    if not prunes:
        prune_eligible = torch.zeros_like(in_range)
    elif prune_eligible is None:
        prune_eligible = in_range
    else:
        prune_eligible = (prune_eligible != 0) & in_range
    return (nbrs, queries.to(torch.float32).contiguous(),
            _lanes(ed, B, L, torch.float32), _lanes(dcq, B, L, torch.float32),
            _lanes(bound2, B, L, torch.float32),
            _f32_scalar(cos_theta), table,
            eval_mask.to(torch.int8).contiguous(),
            prune_eligible.to(torch.int8).contiguous())


def cuda_args_fused_expand(nbrs, queries, ed, dcq, bound2, cos_theta, table,
                           eval_mask=None, prune_eligible=None, prunes=True):
    """What ``fused_expand`` hands ``fused_expand_cuda``: each argument as
    given where the kernel takes its form (int32 ids, f32 side operands of
    any strides, bool or int8 masks), else converted.  On the search
    loop's forms this runs no tensor op (a conversion to the form a tensor
    already has dispatches none)."""
    ed, dcq, bound2 = (x.to(torch.float32) for x in (ed, dcq, bound2))
    return (nbrs.to(torch.int32).contiguous(), _f32(queries), ed, dcq,
            bound2, cos_theta, table, _mask_bytes(eval_mask),
            _mask_bytes(prune_eligible), prunes)


def fused_expand(nbrs, queries, ed, dcq, bound2, cos_theta, table,
                 eval_mask=None, prune_eligible=None, prunes=True):
    """Fused CRouting expansion: estimate + prune + conditional row load +
    exact squared L2 distance in one kernel (the paper's Alg. 2 inner loop).

    nbrs [B, L] ids into ``table`` [N, d]; ed/dcq/bound2 [B] (broadcast),
    [B, L] or [B, W, M] with W*M == L (an expanded view costs no copy).
    ``eval_mask`` marks lanes to evaluate exactly when not pruned,
    ``prune_eligible`` the lanes the estimate test applies to (bool or
    int8); both default to "id in range", and ``prunes=False`` prunes no
    lane.  As in ``repro.kernels.ops.fused_expand`` (and unlike the JAX
    oracle ``repro.kernels.ref.fused_expand_ref``), lanes with ids outside
    ``[0, N)`` are never evaluated and never pruned.  Returns (dist2
    [B, L] f32 with +inf for pruned/masked lanes, prune [B, L] bool).

    On CUDA tensors of the search loop's forms (int32 ids, f32 operands,
    bool masks) no tensor op runs before the launch: the kernel reads the
    operands through their strides and does the range check itself.
    """
    if nbrs.is_cuda:
        from repro_torch.kernels.fused_expand import fused_expand_cuda
        out = fused_expand_cuda(*cuda_args_fused_expand(
            nbrs, queries, ed, dcq, bound2, cos_theta, table, eval_mask,
            prune_eligible, prunes))
        _launched("fused_expand")
        return out
    return ref.fused_expand_ref(*prepare_fused_expand(
        nbrs, queries, ed, dcq, bound2, cos_theta, table, eval_mask,
        prune_eligible, prunes))


def pool_merge(pool_d, pool_i, new_d, new_i):
    """Merge new candidates into the pools and keep the best P, ordered by
    (dist, id).  pool_d/i [B, P], new_d/i [B, L].  The pool is sorted
    except after a stage-2 rerank, which writes exact distances into it in
    place (``core/search.py``); the kernel and the plain version order the
    whole union and assume neither input sorted."""
    args = (pool_d.to(torch.float32).contiguous(),
            pool_i.to(torch.int32).contiguous(),
            new_d.to(torch.float32).contiguous(),
            new_i.to(torch.int32).contiguous())
    if pool_d.is_cuda:
        from repro_torch.kernels.pool_merge import pool_merge_cuda
        out = pool_merge_cuda(*args)
        _launched("pool_merge")
        return out
    return ref.pool_merge_ref(*args)


def prepare_sq8_estimate(nbrs, queries, eval_mask, codes, lo, scale, eps):
    """The plain version's arguments: int32 ids, the eval mask intersected
    with the in-range ids as int8, f32 queries and grid arrays, all
    contiguous."""
    nbrs = nbrs.to(torch.int32).contiguous()
    in_range = ref.in_range(nbrs, codes.shape[0])
    eval_mask = in_range if eval_mask is None else (eval_mask != 0) & in_range
    return (nbrs, _f32(queries), eval_mask.to(torch.int8).contiguous(),
            codes.contiguous(), _f32(lo), _f32(scale), _f32(eps))


def cuda_args_sq8_estimate(nbrs, queries, eval_mask, codes, lo, scale,
                           eps):
    """What ``sq8_estimate`` hands ``sq8_distance_cuda``: each argument as
    given where the kernel takes its form, else converted.  On the search
    loop's forms this runs no tensor op."""
    return (nbrs.to(torch.int32).contiguous(), _f32(queries),
            _mask_bytes(eval_mask), codes.contiguous(), _f32(lo), _f32(scale),
            _f32(eps))


def sq8_estimate(nbrs, queries, eval_mask, codes, lo, scale, eps):
    """Stage-1 SQ8 estimate + conservative lower bound over a neighbour
    tile (the two-stage search path).

    nbrs [B, L] rows of the uint8 code table ``codes`` [N, d]; lanes with
    ``eval_mask == 0`` (bool or int8; None: every lane) or ids outside
    ``[0, N)`` read no code row and report +inf in both outputs.  Returns
    (ad2, lb2) [B, L] f32 in squared-Euclidean space.  On CUDA tensors of
    the search loop's forms no tensor op runs before the launch.
    """
    if nbrs.is_cuda:
        from repro_torch.kernels.sq8_distance import sq8_distance_cuda
        out = sq8_distance_cuda(*cuda_args_sq8_estimate(
            nbrs, queries, eval_mask, codes, lo, scale, eps))
        _launched("sq8_distance")
        return out
    return ref.sq8_estimate_ref(*prepare_sq8_estimate(
        nbrs, queries, eval_mask, codes, lo, scale, eps))


def prepare_gather_distance(indices, queries, table, mask=None,
                            computes=False):
    """The plain version's arguments (``ref.gather_distance_ref``'s order):
    int32 ids, f32 queries, the table and an int8 skip mask that covers
    every id outside ``[0, N)`` and every lane ``mask`` does not compute
    (``computes``: a set byte computes; else a set byte skips), all
    contiguous."""
    idx = indices.to(torch.int32).contiguous()
    skip = ~ref.in_range(idx, table.shape[0])
    if mask is not None:
        skip = skip | ((mask == 0) if computes else (mask != 0))
    return idx, _f32(queries), table, skip.to(torch.int8).contiguous()


def cuda_args_gather_distance(indices, queries, table, mask=None,
                              computes=False):
    """What the gather wrappers hand ``gather_distance_cuda``: each argument
    as given where the kernel takes its form (int32 ids, f32 queries, a
    bool, int8 or uint8 mask in either polarity), else converted.  On the
    search loop's forms this runs no tensor op."""
    return (indices.to(torch.int32).contiguous(), _f32(queries), table,
            _mask_bytes(mask), computes)


def _gather(indices, queries, table, mask=None, computes=False):
    if indices.is_cuda:
        from repro_torch.kernels.gather_distance import gather_distance_cuda
        out = gather_distance_cuda(*cuda_args_gather_distance(
            indices, queries, table, mask, computes))
        _launched("gather_distance")
        return out
    return ref.gather_distance_ref(*prepare_gather_distance(
        indices, queries, table, mask, computes))


def gather_distance(indices, queries, table):
    """``dist2[b, m] = |q_b - table[indices[b, m]]|^2`` [B, M] f32, summed
    in the kernels' order.  Ids outside ``[0, N)`` read no row and report
    +inf (the JAX wrapper leaves them to the caller)."""
    return _gather(indices, queries, table)


def gather_distance_pruned(nbr_ids, prune_mask, queries, table):
    """The exact path under a prune mask: lanes with ``prune_mask != 0``
    read no row and report +inf.  On the TPU pruned lanes were remapped to
    the pad row so that their DMA was de-duplicated; the CUDA kernel simply
    skips them."""
    return _gather(nbr_ids, queries, table, prune_mask, computes=False)


def gather_distance_where(ids, compute, queries, table):
    """``gather_distance`` on the lanes with ``compute != 0`` (bool, int8 or
    uint8) and in-range ids; every other lane reads no row and reports
    +inf.  The search loop's entry: it hands over its own ids and compute
    mask as they are, and on CUDA tensors no tensor op runs before the
    launch."""
    return _gather(ids, queries, table, compute, computes=True)


def prepare_crouting_prune(ed, dcq, bound2, valid, cos_theta):
    """The plain version's arguments: contiguous [B, L] f32 lanes (each of
    ed/dcq/bound2 given as [B], [B, L] or [B, W, M] with W*M == L; [B, L]
    is ``valid``'s shape), an int8 valid mask and ``cos_theta`` rounded to
    f32."""
    B, L = valid.shape
    return (_lanes(ed, B, L, torch.float32), _lanes(dcq, B, L, torch.float32),
            _lanes(bound2, B, L, torch.float32),
            (valid != 0).to(torch.int8).contiguous(), _f32_scalar(cos_theta))


def cuda_args_crouting_prune(ed, dcq, bound2, valid, cos_theta):
    """What ``crouting_prune`` hands ``crouting_prune_cuda``: f32 operands
    of any strides, the valid mask as bool, int8 or uint8 bytes as given
    (else ``!= 0``), ``cos_theta`` rounded to f32.  On the search loop's
    forms this runs no tensor op."""
    ed, dcq, bound2 = (x.to(torch.float32) for x in (ed, dcq, bound2))
    return ed, dcq, bound2, _mask_bytes(valid), _f32_scalar(cos_theta)


def crouting_prune(ed, dcq, bound2, valid, cos_theta):
    """Edge-angle estimate + prune mask over a [B, L] tile (``valid``'s
    shape).

    ed, dcq and bound2 may each be [B] (broadcast over lanes), [B, L] or
    [B, W, M] with W*M == L (an expanded view costs no copy); ``valid`` is
    bool, int8 or uint8.  Returns (est2 [B, L] f32, prune [B, L] bool);
    ``prune = valid & (est2 >= bound2)``, and a NaN estimate never prunes.
    On CUDA tensors of the search loop's forms no tensor op runs before the
    launch.
    """
    if valid.is_cuda:
        from repro_torch.kernels.crouting_prune import crouting_prune_cuda
        out = crouting_prune_cuda(*cuda_args_crouting_prune(
            ed, dcq, bound2, valid, cos_theta))
        _launched("crouting_prune")
        return out
    return ref.crouting_prune_ref(*prepare_crouting_prune(
        ed, dcq, bound2, valid, cos_theta))


def l2_distance(q, x, mode: str = "l2"):
    """Distance matrix [Q, C] f32 between q [Q, d] and x [C, d]: squared L2
    (``mode="l2"``) or the inner-product distance ``1 - <q, x>``
    (``mode="ip"``).  Takes any Q, C and d, and fp32 or bf16 inputs (bf16
    is upcast on load; mixed types are taken as fp32).  Unlike
    ``repro.kernels.ops.l2_distance`` it pads nothing and takes no block
    sizes: the CUDA kernel masks its own ragged edges and owns its tile."""
    if mode not in ("l2", "ip"):
        raise ValueError(f"l2_distance: mode must be 'l2' or 'ip', got {mode!r}")
    dt = (torch.bfloat16 if q.dtype == x.dtype == torch.bfloat16
          else torch.float32)
    q, x = q.to(dt).contiguous(), x.to(dt).contiguous()
    if q.is_cuda:
        from repro_torch.kernels.l2_distance import l2_distance_cuda
        out = l2_distance_cuda(q, x, mode)
        _launched("l2_distance")
        return out
    return ref.l2_distance_ref(q, x, mode)
