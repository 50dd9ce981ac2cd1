"""Binding of the hand-written CUDA kernel ``csrc/crouting_prune.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.crouting_prune``
(``crouting_prune_pallas``).  The source note in the ``.cu`` file says what
bounds it on the card; the plain PyTorch version is
``repro_torch.kernels.ref.crouting_prune_ref``, and the public wrapper is
``repro_torch.kernels.ops.crouting_prune``.

``launch_args`` turns the search loop's own tensors into the kernel's
arguments without a tensor op: the kernel reads ``ed``/``dcq``/``bound2``
through their strides (``fused_expand.lane_strides``) and takes ``valid``
as bool, int8 or uint8 bytes.  Only the outputs are allocated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_expand import lane_strides

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 3 + [ctypes.POINTER(ctypes.c_longlong)] + [_P] * 3
             + [_I, _I, ctypes.c_float, _P])
_KERNEL = "crouting_prune_cuda"


def _lib():
    fn = build.load("crouting_prune").crouting_prune_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_args(ed, dcq, bound2, valid, cos_theta: float):
    """The outputs (est2 [B, L] f32, prune [B, L] bool), allocated with
    ``torch.empty`` (the only tensor ops here), and the launcher's
    arguments but the stream.  [B, L] is ``valid``'s shape."""
    if valid.ndim != 2:
        raise ValueError(f"{_KERNEL}: valid must be [B, L], got "
                         f"{tuple(valid.shape)}")
    B, L = valid.shape
    dev = valid.device
    build.check_mask(_KERNEL, "valid", valid, (B, L), dev)
    side = (ed, dcq, bound2)
    if any(x.device != dev for x in side):
        raise ValueError(f"{_KERNEL}: ed, dcq and bound2 must lie on {dev}")
    lanes = (ctypes.c_longlong * 12)(
        *[s for x in side for s in lane_strides(x, B, L, _KERNEL)])
    est2 = torch.empty((B, L), dtype=torch.float32, device=dev)
    prune = torch.empty((B, L), dtype=torch.bool, device=dev)
    return (est2, prune), (
        ed.data_ptr(), dcq.data_ptr(), bound2.data_ptr(), lanes,
        valid.data_ptr(), est2.data_ptr(), prune.data_ptr(), B, L,
        float(cos_theta))


def crouting_prune_cuda(ed, dcq, bound2, valid, cos_theta: float):
    """Launch the kernel on the current stream.

    valid [B, L] bool, int8 or uint8 (contiguous); ed, dcq and bound2 f32
    of shape [B], [B, L] or [B, W, M] with W*M == L, any strides; all on one
    CUDA device.  ``cos_theta`` is rounded to f32.  Returns (est2 [B, L]
    f32, prune [B, L] bool).  Raises on any launch error; there is no
    fallback.
    """
    outs, args = launch_args(ed, dcq, bound2, valid, cos_theta)
    stream = torch.cuda.current_stream(valid.device).cuda_stream
    err = _lib()(*args, stream)
    if err != 0:
        raise RuntimeError("crouting_prune kernel launch failed: "
                           f"cudaError {err}")
    return outs


def crouting_prune_empty_launch(B: int, L: int) -> None:
    """Launch an empty kernel on the grid and block of a [B, L] call: the
    launch floor beside the kernel's own time."""
    fn = build.load("crouting_prune").crouting_prune_empty_launch
    fn.argtypes = [_I, _I, _P]
    fn.restype = ctypes.c_int
    err = fn(B, L, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("crouting_prune_empty launch failed: "
                           f"cudaError {err}")
