"""Binding and public wrapper of the hand-written CUDA kernel
``csrc/normalize_rows.cu``: each float32 row divided by its Euclidean norm,
``out[i] = x[i] / max(|x[i]|_2, 1e-12)``.

It replaces no Pallas TPU kernel: the reference normalises a cosine index's
queries on the host (``preprocess_vectors``), and so did the port until
``AnnIndex.search_on`` began to upload a CUDA cosine index's queries as
they are and normalise them here, in place, on the card.  It is bound by
bytes (each row read and written once); the source note in the ``.cu`` file
says how.

* CUDA tensors: one launch on the current stream, counted in
  ``LAUNCHES``; no sync, no allocation but ``out`` when the caller gives
  none.  A failed build or launch raises; nothing falls back.
* CPU tensors run the plain version, ``ref.normalize_rows_ref``, which the
  kernel equals bit for bit: the squares are summed in the kernels' warp
  order, so a row's bits depend on the row alone, not on the batch it
  comes in.

``LAUNCHES`` sits beside ``ops.LAUNCHES`` (the six search kernels) as
``segment_sum.LAUNCHES`` does, so the search loop's launch sets stay as
they were.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"normalize_rows": 0}
_LAUNCH_LOCK = threading.Lock()
_KERNEL = "normalize_rows_cuda"
_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["normalize_rows"] = 0


def _check(x, out) -> None:
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{_KERNEL}: x must be a contiguous [B, d] float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"(contiguous={x.is_contiguous()})")
    build.check_args(_KERNEL, x.device,
                     (("out", out, torch.float32, tuple(x.shape)),))


def normalize_rows_cuda(x, out):
    """One launch of the kernel on ``x``'s current stream, into ``out``
    (which may be ``x``); counted."""
    if x.numel():
        fn = build.load("normalize_rows").normalize_rows_launch
        fn.argtypes = [_P, _P, _LL, _LL, _P]
        fn.restype = ctypes.c_int
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"normalize_rows kernel launch failed: "
                               f"cudaError {err}")
        with _LAUNCH_LOCK:
            LAUNCHES["normalize_rows"] += 1
    return out


def normalize_rows(x, out: Optional[torch.Tensor] = None):
    """``x [B, d]`` (contiguous float32) with each row divided by
    ``max(|row|_2, 1e-12)``, into ``out`` (same shape, dtype and device;
    ``out=x`` normalises in place) or a new tensor: the kernel on CUDA
    tensors, the plain version on CPU tensors.  Anything else raises
    ``ValueError``."""
    _check(x, x if out is None else out)
    if out is None:
        out = torch.empty_like(x)
    kind = x.device.type
    if kind == "cuda":
        return normalize_rows_cuda(x, out)
    if kind == "cpu":
        return out.copy_(ref.normalize_rows_ref(x))
    raise ValueError(f"normalize_rows: unsupported device {x.device}")
