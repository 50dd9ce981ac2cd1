"""Binding of the hand-written CUDA kernel ``csrc/gather_distance.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.gather_distance``
(``gather_distance_pallas``) and its masked form
``repro.kernels.ops.gather_distance_pruned``.  The source note in the
``.cu`` file says what bounds it on the card and how its design answers
that; the plain PyTorch version is
``repro_torch.kernels.ref.gather_distance_ref``, and the public wrappers
with the masking contract are ``repro_torch.kernels.ops.gather_distance``
and ``gather_distance_pruned``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 4 + [_P]
_MAX_D = 48 * 1024 // 4         # the query row in 48 KB of shared memory


def _lib():
    fn = build.load("gather_distance").gather_distance_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def gather_distance_cuda(idx, skip, queries, table):
    """Launch the kernel on the current stream.

    idx [B, M] int32, skip [B, M] int8 (already including every id outside
    ``[0, N)``), queries [B, d] f32, table [N, d] f32 — all contiguous on
    one CUDA device.  Returns dist2 [B, M] f32, +inf on skipped lanes.
    Raises on any launch error; there is no fallback.
    """
    B, M = idx.shape
    d = queries.shape[1]
    dev = idx.device
    build.check_args("gather_distance_cuda", dev, (
        ("idx", idx, torch.int32, None),
        ("skip", skip, torch.int8, (B, M)),
        ("queries", queries, torch.float32, (B, d)),
        ("table", table, torch.float32, (table.shape[0], d))))
    if d > _MAX_D or B > 65535:
        raise ValueError(f"gather_distance_cuda: d={d} or B={B} beyond the "
                         f"kernel's limits (d <= {_MAX_D}, B <= 65535)")
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(idx.data_ptr(), skip.data_ptr(), queries.data_ptr(),
                 table.data_ptr(), out.data_ptr(), B, M, d, vec4, stream)
    if err != 0:
        raise RuntimeError("gather_distance kernel launch failed: "
                           f"cudaError {err}")
    return out
