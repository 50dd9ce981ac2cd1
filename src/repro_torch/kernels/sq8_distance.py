"""Binding of the hand-written CUDA kernel ``csrc/sq8_distance.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.sq8_distance``
(``sq8_distance_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card and how its design answers that; the plain PyTorch
version is ``repro_torch.kernels.ref.sq8_estimate_ref``, and the public
wrapper with the masking contract is ``repro_torch.kernels.ops.sq8_estimate``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 4 + [_P]
_MAX_D = 48 * 1024 // 16       # q, lo, scale, eps in 48 KB of shared memory


def _lib():
    fn = build.load("sq8_distance").sq8_distance_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def sq8_distance_cuda(nbrs, queries, eval_mask, codes, lo, scale, eps):
    """Launch the kernel on the current stream.

    nbrs [B, L] int32, queries [B, d] f32, eval_mask [B, L] int8 (already
    intersected with the in-range ids), codes [N, d] uint8, lo/scale/eps
    [d] f32 — all contiguous on one CUDA device.  Returns (ad2, lb2), each
    [B, L] f32 with +inf on lanes not evaluated.  Raises on any launch
    error; there is no fallback.
    """
    B, L = nbrs.shape
    d = queries.shape[1]
    dev = nbrs.device
    build.check_args("sq8_distance_cuda", dev, (
        ("nbrs", nbrs, torch.int32, None),
        ("queries", queries, torch.float32, (B, d)),
        ("eval_mask", eval_mask, torch.int8, (B, L)),
        ("codes", codes, torch.uint8, (codes.shape[0], d)),
        ("lo", lo, torch.float32, (d,)),
        ("scale", scale, torch.float32, (d,)),
        ("eps", eps, torch.float32, (d,))))
    if d > _MAX_D or B > 65535:
        raise ValueError(f"sq8_distance_cuda: d={d} or B={B} beyond the "
                         f"kernel's limits (d <= {_MAX_D}, B <= 65535)")
    ad2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    lb2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    vec4 = int(d % 4 == 0 and codes.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(nbrs.data_ptr(), queries.data_ptr(), lo.data_ptr(),
                 scale.data_ptr(), eps.data_ptr(), eval_mask.data_ptr(),
                 codes.data_ptr(), ad2.data_ptr(), lb2.data_ptr(), B, L, d,
                 vec4, stream)
    if err != 0:
        raise RuntimeError(f"sq8_distance kernel launch failed: cudaError {err}")
    return ad2, lb2
