"""Binding of the hand-written CUDA kernel ``csrc/fused_expand.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_expand``
(``fused_expand_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card and how its design answers that; the plain PyTorch
version is ``repro_torch.kernels.ref.fused_expand_ref``, and the public
wrapper with the masking contract is ``repro_torch.kernels.ops.fused_expand``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, _P]
_MAX_SMEM_FLOATS = 48 * 1024 // 4


def _lib():
    lib = build.load("fused_expand")
    fn = lib.fused_expand_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_expand_cuda(nbrs, queries, ed, dcq, bound2, cos_theta: float,
                      table, eval_mask, prune_eligible):
    """Launch the kernel on the current stream.

    nbrs [B, L] int32, queries [B, d] f32, ed/dcq/bound2 [B, L] f32,
    eval_mask/prune_eligible [B, L] int8 (already intersected with the
    in-range ids), table [N, d] f32 — all contiguous on one CUDA device.
    Returns (dist2 [B, L] f32, prune [B, L] int8).  Raises on any launch
    error; there is no fallback.
    """
    B, L = nbrs.shape
    d = queries.shape[1]
    dev = nbrs.device
    build.check_args("fused_expand_cuda", dev, (
        ("nbrs", nbrs, torch.int32, None),
        ("queries", queries, torch.float32, (B, d)),
        ("ed", ed, torch.float32, (B, L)), ("dcq", dcq, torch.float32, (B, L)),
        ("bound2", bound2, torch.float32, (B, L)),
        ("eval_mask", eval_mask, torch.int8, (B, L)),
        ("prune_eligible", prune_eligible, torch.int8, (B, L)),
        ("table", table, torch.float32, (table.shape[0], d))))
    if d > _MAX_SMEM_FLOATS or B > 65535:
        raise ValueError(f"fused_expand_cuda: d={d} or B={B} beyond the "
                         "kernel's limits (d <= 12288, B <= 65535)")
    dist2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    prune = torch.empty((B, L), dtype=torch.int8, device=dev)
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(nbrs.data_ptr(), queries.data_ptr(), ed.data_ptr(),
                 dcq.data_ptr(), bound2.data_ptr(), eval_mask.data_ptr(),
                 prune_eligible.data_ptr(), table.data_ptr(),
                 dist2.data_ptr(), prune.data_ptr(), B, L, d,
                 float(cos_theta), vec4, stream)
    if err != 0:
        raise RuntimeError(f"fused_expand kernel launch failed: cudaError {err}")
    return dist2, prune
