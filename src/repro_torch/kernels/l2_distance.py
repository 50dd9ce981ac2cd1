"""Binding of the hand-written CUDA kernel ``csrc/l2_distance.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.l2_distance``
(``l2_distance_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card and how its design answers that; the plain PyTorch
version is ``repro_torch.kernels.ref.l2_distance_ref``, and the public
wrapper is ``repro_torch.kernels.ops.l2_distance``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int, _P]
MODES = ("l2", "ip")


def _lib():
    fn = build.load("l2_distance").l2_distance_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def l2_distance_cuda(q, x, mode: str = "l2"):
    """Launch the kernel on the current stream.

    q [Q, d] and x [C, d], both contiguous fp32 or both bf16 on one CUDA
    device; any Q, C and d (the kernel masks its own ragged edges).
    Returns [Q, C] fp32: squared L2 distances (``mode="l2"``) or
    ``1 - <q, x>`` (``mode="ip"``).  Raises on any launch error; there is
    no fallback.
    """
    if mode not in MODES:
        raise ValueError(f"l2_distance_cuda: mode must be one of {MODES}, "
                         f"got {mode!r}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("l2_distance_cuda: inputs must be float32 or "
                         f"bfloat16, got {q.dtype}")
    Q, d = q.shape
    dev = q.device
    build.check_args("l2_distance_cuda", dev, (
        ("q", q, q.dtype, None),
        ("x", x, q.dtype, (x.shape[0], d))))
    out = torch.empty((Q, x.shape[0]), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), x.data_ptr(), out.data_ptr(), Q, x.shape[0], d,
                 MODES.index(mode), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"l2_distance kernel launch failed: cudaError {err}")
    return out
