"""Binding of the hand-written CUDA kernel ``csrc/l2_distance.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.l2_distance``
(``l2_distance_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card and how its two kernels answer that: a streaming
kernel for few queries over 16-byte aligned rows, a tiled one otherwise;
``choose_variant`` picks one by shape.  The plain
PyTorch version is ``repro_torch.kernels.ref.l2_distance_ref``, and the
public wrapper is ``repro_torch.kernels.ops.l2_distance``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P]
MODES = ("l2", "ip")
VARIANTS = ("tiled", "stream")
# The streaming kernel's limits, which its launcher enforces and reports
# (``l2_distance_stream_limits``; a ``gpu`` test holds these to them).
STREAM_MAX_Q = 16
CHUNK_BYTES = 128          # a candidate row's bytes per pipeline stage
STREAM_MAX_QUERY_BYTES = 64 * 1024   # its fp32 query rows in shared memory
# Where it beats the tiled kernel on the H100 (PERF.md: chip_smoke.py's
# l2_crossover, ip [Q, C, 128]): at every Q <= STREAM_ANY_C_Q, and up to
# STREAM_MAX_Q once C >= STREAM_MIN_C_PER_Q * Q; below that the tiled
# kernel spreads the few candidate tiles over more of the card.
STREAM_ANY_C_Q = 4
STREAM_MIN_C_PER_Q = 4096


def choose_variant(Q: int, C: int, d: int, elem_bytes: int,
                   x_ptr: int) -> str:
    """``"stream"`` for ``Q <= STREAM_ANY_C_Q``, or ``Q <= STREAM_MAX_Q``
    with ``C >= STREAM_MIN_C_PER_Q * Q``, when the candidate rows are
    16-byte aligned (``x_ptr`` and ``d * elem_bytes`` multiples of 16) and
    the fp32 query rows, padded to whole 128-byte chunks, fit
    ``STREAM_MAX_QUERY_BYTES``; ``"tiled"`` otherwise."""
    cols = CHUNK_BYTES // elem_bytes
    padded = -(-d // cols) * cols
    fits = (1 <= Q <= STREAM_MAX_Q and (d * elem_bytes) % 16 == 0
            and x_ptr % 16 == 0 and Q * padded * 4 <= STREAM_MAX_QUERY_BYTES)
    pays = Q <= STREAM_ANY_C_Q or C >= STREAM_MIN_C_PER_Q * Q
    return "stream" if fits and pays else "tiled"


def stream_limits():
    """The launcher's own limits: ``(max Q, chunk bytes, max query
    bytes)``.  Builds the kernel; needs ``nvcc``."""
    limits = (ctypes.c_int * 3)()
    build.load("l2_distance").l2_distance_stream_limits(limits)
    return tuple(limits)


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
    ``1 - <q, x>`` (``mode="ip"``), from the kernel ``choose_variant``
    picks.  Raises on any launch error; there is no fallback.
    """
    if mode not in MODES:
        raise ValueError(f"l2_distance_cuda: mode must be one of {MODES}, "
                         f"got {mode!r}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("l2_distance_cuda: inputs must be float32 or "
                         f"bfloat16, got {q.dtype}")
    Q, d = q.shape
    C = x.shape[0]
    dev = q.device
    build.check_args("l2_distance_cuda", dev, (
        ("q", q, q.dtype, None),
        ("x", x, q.dtype, (C, d))))
    variant = choose_variant(Q, C, d, q.element_size(), x.data_ptr())
    out = torch.empty((Q, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), x.data_ptr(), out.data_ptr(), Q, C, d,
                 MODES.index(mode), int(q.dtype == torch.bfloat16),
                 VARIANTS.index(variant), stream)
    if err != 0:
        raise RuntimeError(f"l2_distance kernel launch failed: cudaError {err}")
    return out
