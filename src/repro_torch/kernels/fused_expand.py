"""Binding of the hand-written CUDA kernel ``csrc/fused_expand.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_expand``
(``fused_expand_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card and how its design answers that; the plain PyTorch
version is ``repro_torch.kernels.ref.fused_expand_ref``, and the public
wrapper is ``repro_torch.kernels.ops.fused_expand``.

``launch_args`` turns the search loop's own tensors into the kernel's
arguments without a tensor op: the kernel reads ``ed``/``dcq``/``bound2``
through their strides, takes the masks as bool or int8 bytes, and does the
range check itself.  Only the outputs are allocated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 5 + [ctypes.POINTER(ctypes.c_longlong), _P, _P, _I, _P,
                         ctypes.c_longlong, _P, _P, _I, _I, _I,
                         ctypes.c_float, _I, _P])
_PRUNE_NONE, _PRUNE_ALL, _PRUNE_MASK = 0, 1, 2


def _lib():
    fn = build.load("fused_expand").fused_expand_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def lane_strides(x, B: int, L: int, kernel: str = "fused_expand_cuda"):
    """(stride_b, stride_w, stride_m, m) that read lane (b, l) of a [B]
    operand (broadcast over lanes), a [B, L] one, or a [B, W, M] one with W*M
    == L (e.g. a [B, W] tensor expanded over M with a zero stride), as
    ``csrc/lanes.cuh`` reads it.  ``fused_expand`` and ``crouting_prune``
    take their side operands this way; ``kernel`` names the caller in the
    error."""
    if x.dtype != torch.float32:
        raise ValueError(f"{kernel}: side operands must be float32, "
                         f"got {x.dtype}")
    if x.ndim == 1 and x.shape[0] == B:
        return (x.stride(0), 0, 0, L)
    if x.ndim == 2 and tuple(x.shape) == (B, L):
        return (x.stride(0), 0, x.stride(1), L)
    if x.ndim == 3 and x.shape[0] == B and x.shape[1] * x.shape[2] == L:
        return (x.stride(0), x.stride(1), x.stride(2), x.shape[2])
    raise ValueError(f"{kernel}: a side operand of shape "
                     f"{tuple(x.shape)} is not [B], [B, L] or [B, W, M] "
                     f"with B={B}, L={L}")


def launch_args(nbrs, queries, ed, dcq, bound2, cos_theta: float, table,
                eval_mask=None, prune_eligible=None, prunes: bool = True):
    """The outputs (dist2 [B, L] f32, prune [B, L] bool), allocated with
    ``torch.empty`` (the only tensor ops here), and the launcher's
    arguments but the stream."""
    B, L = nbrs.shape
    d = queries.shape[1]
    dev = nbrs.device
    build.check_args("fused_expand_cuda", dev, (
        ("nbrs", nbrs, torch.int32, None),
        ("queries", queries, torch.float32, (B, d)),
        ("table", table, torch.float32, (table.shape[0], d))))
    side = (ed, dcq, bound2)
    if any(x.device != dev for x in side):
        raise ValueError("fused_expand_cuda: ed, dcq and bound2 must lie on "
                         f"{dev}")
    lanes = (ctypes.c_longlong * 12)(
        *[s for x in side for s in lane_strides(x, B, L)])
    eval_mask = build.check_mask("fused_expand_cuda", "eval_mask",
                                 eval_mask, (B, L), dev)
    prune_eligible = build.check_mask("fused_expand_cuda", "prune_eligible",
                                      prune_eligible, (B, L), dev)
    if not prunes and prune_eligible is not None:
        raise ValueError("fused_expand_cuda: prunes=False takes no "
                         "prune_eligible mask")
    mode = (_PRUNE_NONE if not prunes else
            _PRUNE_ALL if prune_eligible is None else _PRUNE_MASK)
    dist2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    prune = torch.empty((B, L), dtype=torch.bool, device=dev)
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0
               and queries.data_ptr() % 16 == 0)

    def ptr(x):
        return None if x is None else x.data_ptr()

    return (dist2, prune), (
        nbrs.data_ptr(), queries.data_ptr(), ed.data_ptr(), dcq.data_ptr(),
        bound2.data_ptr(), lanes, ptr(eval_mask), ptr(prune_eligible), mode,
        table.data_ptr(), table.shape[0], dist2.data_ptr(), prune.data_ptr(),
        B, L, d, float(cos_theta), vec4)


def fused_expand_cuda(nbrs, queries, ed, dcq, bound2, cos_theta: float,
                      table, eval_mask=None, prune_eligible=None,
                      prunes: bool = True):
    """Launch the kernel on the current stream.

    nbrs [B, L] int32 (any ids: those outside ``[0, N)`` read no row, are
    never pruned and report +inf), queries [B, d] f32, ed/dcq/bound2 f32 of
    shape [B], [B, L] or [B, W, M] (W*M == L, any strides), eval_mask and
    prune_eligible [B, L] bool or int8 or None (every lane may be
    evaluated / may prune; ``prunes=False``: no lane prunes), table [N, d]
    f32; all on one CUDA device.  ``cos_theta`` is rounded to f32.
    Returns (dist2 [B, L] f32, prune [B, L] bool).  Raises on any launch
    error; there is no fallback.
    """
    outs, args = launch_args(nbrs, queries, ed, dcq, bound2, cos_theta,
                             table, eval_mask, prune_eligible, prunes)
    stream = torch.cuda.current_stream(nbrs.device).cuda_stream
    err = _lib()(*args, stream)
    if err != 0:
        raise RuntimeError(f"fused_expand kernel launch failed: cudaError {err}")
    return outs


def empty_launch(B: int, L: int) -> None:
    """Launch an empty kernel on the grid and block of a [B, L] call: the
    launch floor beside the kernel's own time."""
    fn = build.load("fused_expand").fused_expand_empty_launch
    fn.argtypes = [_I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(B, L, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_expand_empty launch failed: cudaError {err}")
