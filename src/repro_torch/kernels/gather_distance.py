"""Binding of the hand-written CUDA kernel ``csrc/gather_distance.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.gather_distance``
(``gather_distance_pallas``) and its masked form
``repro.kernels.ops.gather_distance_pruned``.  The source note in the
``.cu`` file says what bounds it on the card and how its design answers
that; the plain PyTorch version is
``repro_torch.kernels.ref.gather_distance_ref``, and the public wrappers
are ``repro_torch.kernels.ops.gather_distance``,
``gather_distance_pruned`` (a skip mask) and ``gather_distance_where`` (a
compute mask).

``launch_args`` turns the search loop's own tensors into the kernel's
arguments without a tensor op: the kernel takes the mask as bool, int8 or
uint8 bytes in either polarity and does the range check itself.  Only the
output is allocated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _I, _P, _P, ctypes.c_longlong, _P] + [_I] * 4 + [_P]


def _lib():
    fn = build.load("gather_distance").gather_distance_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_args(idx, queries, table, mask=None, mask_computes=False):
    """The output (dist2 [B, M] f32), allocated with ``torch.empty`` (the
    only tensor op here), and the launcher's arguments but the stream."""
    B, M = idx.shape
    d = queries.shape[1]
    dev = idx.device
    build.check_args("gather_distance_cuda", dev, (
        ("idx", idx, torch.int32, None),
        ("queries", queries, torch.float32, (B, d)),
        ("table", table, torch.float32, (table.shape[0], d))))
    build.check_mask("gather_distance_cuda", "mask", mask, (B, M), dev)
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0
               and queries.data_ptr() % 16 == 0)
    return out, (idx.data_ptr(), None if mask is None else mask.data_ptr(),
                 int(bool(mask_computes)), queries.data_ptr(),
                 table.data_ptr(), table.shape[0], out.data_ptr(), B, M, d,
                 vec4)


def gather_distance_cuda(idx, queries, table, mask=None,
                         mask_computes=False):
    """Launch the kernel on the current stream.

    idx [B, M] int32 (any ids: those outside ``[0, N)`` read no row and
    report +inf), queries [B, d] f32, table [N, d] f32 (any d), mask [B, M]
    bool, int8 or uint8 or None (every lane): with ``mask_computes`` a set
    byte marks a lane to compute, else a lane to skip; all contiguous on one
    CUDA device.  Returns dist2 [B, M] f32, +inf on lanes not computed.
    Raises on any launch error; there is no fallback.
    """
    out, args = launch_args(idx, queries, table, mask, mask_computes)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = _lib()(*args, stream)
    if err != 0:
        raise RuntimeError("gather_distance kernel launch failed: "
                           f"cudaError {err}")
    return out


def gather_distance_empty_launch(B: int, M: int) -> None:
    """Launch an empty kernel on the grid and block of a [B, M] call: the
    launch floor beside the kernel's own time."""
    fn = build.load("gather_distance").gather_distance_empty_launch
    fn.argtypes = [_I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(B, M, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("gather_distance_empty launch failed: "
                           f"cudaError {err}")

