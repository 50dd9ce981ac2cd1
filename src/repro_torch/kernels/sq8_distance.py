"""Binding of the hand-written CUDA kernel ``csrc/sq8_distance.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.sq8_distance``
(``sq8_distance_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card and how its design answers that; the plain PyTorch
version is ``repro_torch.kernels.ref.sq8_estimate_ref``, and the public
wrapper is ``repro_torch.kernels.ops.sq8_estimate``.

``launch_args`` turns the search loop's own tensors into the kernel's
arguments without a tensor op: the kernel takes the eval mask as bool or
int8 bytes and does the range check itself.  Only the outputs are
allocated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [ctypes.c_longlong, _P, _P] + [_I] * 4 + [_P]


def _lib():
    fn = build.load("sq8_distance").sq8_distance_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_args(nbrs, queries, eval_mask, codes, lo, scale, eps):
    """The outputs (ad2, lb2 [B, L] f32), allocated with ``torch.empty``
    (the only tensor ops here), and the launcher's arguments but the
    stream."""
    B, L = nbrs.shape
    d = queries.shape[1]
    dev = nbrs.device
    build.check_args("sq8_distance_cuda", dev, (
        ("nbrs", nbrs, torch.int32, None),
        ("queries", queries, torch.float32, (B, d)),
        ("codes", codes, torch.uint8, (codes.shape[0], d)),
        ("lo", lo, torch.float32, (d,)),
        ("scale", scale, torch.float32, (d,)),
        ("eps", eps, torch.float32, (d,))))
    build.check_mask("sq8_distance_cuda", "eval_mask", eval_mask, (B, L),
                     dev)
    ad2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    lb2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    vec4 = int(d % 4 == 0 and codes.data_ptr() % 4 == 0
               and all(x.data_ptr() % 16 == 0
                       for x in (queries, lo, scale, eps)))
    return (ad2, lb2), (
        nbrs.data_ptr(), queries.data_ptr(), lo.data_ptr(), scale.data_ptr(),
        eps.data_ptr(), None if eval_mask is None else eval_mask.data_ptr(),
        codes.data_ptr(), codes.shape[0], ad2.data_ptr(), lb2.data_ptr(),
        B, L, d, vec4)


def sq8_distance_cuda(nbrs, queries, eval_mask, codes, lo, scale, eps):
    """Launch the kernel on the current stream.

    nbrs [B, L] int32 (ids outside ``[0, N)`` read no code row), queries
    [B, d] f32, eval_mask [B, L] bool or int8 or None (every lane), codes
    [N, d] uint8, lo/scale/eps [d] f32, all contiguous on one CUDA device.
    Returns (ad2, lb2), each [B, L] f32 with +inf on lanes not evaluated.
    Raises on any launch error; there is no fallback.
    """
    outs, args = launch_args(nbrs, queries, eval_mask, codes, lo, scale, eps)
    stream = torch.cuda.current_stream(nbrs.device).cuda_stream
    err = _lib()(*args, stream)
    if err != 0:
        raise RuntimeError(f"sq8_distance kernel launch failed: cudaError {err}")
    return outs


def empty_launch(B: int, L: int) -> None:
    """Launch an empty kernel on the grid and block of a [B, L] call: the
    launch floor beside the kernel's own time."""
    fn = build.load("sq8_distance").sq8_distance_empty_launch
    fn.argtypes = [_I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(B, L, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sq8_distance_empty launch failed: cudaError {err}")
