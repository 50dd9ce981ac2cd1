"""Binding and public wrapper of the hand-written CUDA kernel
``csrc/segment_sum.cu``: a sum of rows by segment id in a fixed order.

It replaces no Pallas TPU kernel: the reference sums rows by id with XLA's
scatter-add, which repeats bit for bit, and PyTorch's CUDA ``index_add_``
(and ``F.embedding``'s backward) do not.  The source note in the ``.cu``
file says what bounds it on the card.

``segment_sum(data, seg_ids, num_segments)`` returns ``out [S, *tail]``
with ``out[s] = sum of data[i] over seg_ids[i] == s``, added in increasing
``i`` from zero (an empty segment is 0), for ``data [N, *tail]`` in fp32 or
bf16 and integer ``seg_ids [N]`` in ``[0, S)``.  bf16 data is summed in an
fp32 accumulator and rounded to bf16 once (see ``ref.segment_sum_ref``).

* CUDA tensors: a stable ``torch.sort`` of the ids and ``searchsorted``
  for the run offsets (set-up, library calls), then one launch of the
  kernel over the grid ``choose_grid`` picks, counted in ``LAUNCHES``.
  A failed build or launch raises; nothing falls back.  Ids outside
  ``[0, S)`` fall outside every run and are dropped (the CPU's
  ``index_add_`` raises on them).
* CPU tensors run the plain version, ``ref.segment_sum_ref``; so do meta
  tensors (shapes only, for the dry run's counts).

``LAUNCHES`` sits beside ``ops.LAUNCHES`` (the six search kernels), so a
path that must launch none of those can still show this one.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"segment_sum": 0}
_LAUNCH_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "segment_sum_cuda"

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [_P]
# The kernel's grid covers the run starts (the output zeroed first) when
# the segments outnumber the rows by more than this, else the segments
# (``csrc/segment_sum.cu``'s kRunStartRatio; a gpu test holds the two equal).
RUN_START_RATIO = 4


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["segment_sum"] = 0


def _lib():
    fn = build.load("segment_sum").segment_sum_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_run_start_ratio() -> int:
    """The kernel's own threshold (held to ``RUN_START_RATIO`` on the
    card)."""
    fn = build.load("segment_sum").segment_sum_run_start_ratio
    fn.argtypes = []
    fn.restype = ctypes.c_longlong
    return int(fn())


def runs(seg_ids, num_segments: int):
    """The set-up: (sorted_ids [N] int64; order [N] int64, the row numbers
    sorted stably by id; offsets [S + 1] int64, segment s's run is
    ``order[offsets[s]:offsets[s + 1]]``)."""
    ids = seg_ids.reshape(-1).long()
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    return sorted_ids, order, torch.searchsorted(sorted_ids, bounds)


def choose_grid(n_rows: int, num_segments: int) -> str:
    """``"run_starts"`` (a warp for each sorted position, continuing only
    at a run's start, the output zeroed first) when the segments outnumber
    the rows by more than ``RUN_START_RATIO``, as a 4M-row table's
    gradient at B = 65,536 does; else ``"segments"`` (a warp for each
    segment, an empty one writing zeros)."""
    return ("run_starts" if num_segments > RUN_START_RATIO * n_rows
            else "segments")


def launch_runs(data2d, sorted_ids, order, offsets, num_segments: int):
    """One launch of the kernel on the current stream over runs from
    ``runs``: ``data2d [N, d]`` contiguous fp32 or bf16 on a CUDA device;
    returns ``out [S, d]``.  Not counted (``segment_sum_cuda`` counts)."""
    dev = data2d.device
    if data2d.ndim != 2 or data2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"{_KERNEL}: data must be [N, d] float32 or "
                         f"bfloat16, got {data2d.dtype} "
                         f"{tuple(data2d.shape)}")
    N, d = data2d.shape
    build.check_args(_KERNEL, dev, (
        ("data", data2d, data2d.dtype, None),
        ("sorted_ids", sorted_ids, torch.int64, (N,)),
        ("order", order, torch.int64, (N,)),
        ("offsets", offsets, torch.int64, (num_segments + 1,))))
    out = torch.empty((num_segments, d), dtype=data2d.dtype, device=dev)
    grid = choose_grid(N, num_segments) == "run_starts"
    err = _lib()(data2d.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
                 offsets.data_ptr(), out.data_ptr(), N, num_segments, d,
                 _DTYPE_CODE[data2d.dtype], int(grid),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError "
                           f"{err}")
    return out


def segment_sum_cuda(data, seg_ids, num_segments: int):
    """The kernel path: set-up, one launch (counted), ``[S, *tail]``."""
    if seg_ids.device != data.device or seg_ids.numel() != data.shape[0]:
        raise ValueError(f"{_KERNEL}: seg_ids must be [{data.shape[0]}] on "
                         f"{data.device}, got {tuple(seg_ids.shape)} on "
                         f"{seg_ids.device}")
    sorted_ids, order, offsets = runs(seg_ids, num_segments)
    tail = tuple(data.shape[1:])
    out = launch_runs(data.reshape(data.shape[0], math.prod(tail))
                      .contiguous(), sorted_ids, order, offsets,
                      num_segments)
    with _LAUNCH_LOCK:
        LAUNCHES["segment_sum"] += 1
    return out.reshape((num_segments,) + tail)


def segment_sum(data, seg_ids, num_segments: int):
    """Rows of ``data`` summed by ``seg_ids`` in increasing row order (see
    the module docstring): the kernel on CUDA tensors, the plain version
    on CPU and meta tensors."""
    kind = data.device.type
    if kind == "cuda":
        return segment_sum_cuda(data, seg_ids, num_segments)
    if kind in ("cpu", "meta"):
        return ref.segment_sum_ref(data, seg_ids, num_segments)
    raise ValueError(f"segment_sum: unsupported device {data.device}")
