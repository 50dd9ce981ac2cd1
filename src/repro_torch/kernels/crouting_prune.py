"""Binding of the hand-written CUDA kernel ``csrc/crouting_prune.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.crouting_prune``
(``crouting_prune_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card; the plain PyTorch version is
``repro_torch.kernels.ref.crouting_prune_ref``, and the public wrapper is
``repro_torch.kernels.ops.crouting_prune``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 6 + [ctypes.c_longlong, ctypes.c_float, _P]


def _lib():
    fn = build.load("crouting_prune").crouting_prune_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def crouting_prune_cuda(ed, dcq, bound2, valid, cos_theta: float):
    """Launch the kernel on the current stream.

    ed/dcq/bound2 [B, M] f32 and valid [B, M] int8, contiguous on one CUDA
    device; ``cos_theta`` is taken as f32.  Returns (est2 [B, M] f32,
    prune [B, M] int8).  Raises on any launch error; there is no fallback.
    """
    shape = tuple(ed.shape)
    dev = ed.device
    build.check_args("crouting_prune_cuda", dev, (
        ("ed", ed, torch.float32, None),
        ("dcq", dcq, torch.float32, shape),
        ("bound2", bound2, torch.float32, shape),
        ("valid", valid, torch.int8, shape)))
    est2 = torch.empty(shape, dtype=torch.float32, device=dev)
    prune = torch.empty(shape, dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(ed.data_ptr(), dcq.data_ptr(), bound2.data_ptr(),
                 valid.data_ptr(), est2.data_ptr(), prune.data_ptr(),
                 ed.numel(), float(cos_theta), stream)
    if err != 0:
        raise RuntimeError("crouting_prune kernel launch failed: "
                           f"cudaError {err}")
    return est2, prune
