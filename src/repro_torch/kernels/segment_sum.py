"""Binding and public wrapper of the hand-written CUDA kernel
``csrc/segment_sum.cu``: a sum of rows by segment id in a fixed order.

It replaces no Pallas TPU kernel: the reference sums rows by id with XLA's
scatter-add, which repeats bit for bit, and PyTorch's CUDA ``index_add_``
(and ``F.embedding``'s backward) do not.

``segment_sum(data, seg, num_segments)`` returns ``out [S, *tail]`` with
``out[s] = sum of data[i] over seg_ids[i] == s``, added in increasing
``i`` from zero (an empty segment is 0), for ``data [N, *tail]`` in fp32 or
bf16 and ``seg`` either integer ``seg_ids [N]`` in ``[0, S)`` or the
``Runs`` that ``runs(seg_ids, S)`` set up from them.  bf16 data is summed
in an fp32 accumulator and rounded to bf16 once (see
``ref.segment_sum_ref``).

* CUDA tensors: the set-up (``runs``: a stable sort of the ids as int32
  keys, ``searchsorted`` for the run offsets, and the list of runs of at
  least ``LONG_RUN_ROWS`` rows, all library calls on the device with no
  host sync) unless ``seg`` is a ``Runs`` already, then one launch of the
  kernel, counted in ``LAUNCHES``.  A caller that sums over one id list
  many times (the GNN layers) sets it up once and passes the ``Runs``.  A
  failed build or launch raises; nothing falls back.  Ids outside
  ``[0, S)`` fall outside every run and are dropped (the CPU's
  ``index_add_`` raises on them).
* CPU tensors run the plain version, ``ref.segment_sum_ref``, on the ids
  (a ``Runs`` there is only its ids); so do meta tensors (shapes only, for
  the dry run's counts).

What bounds each part of the kernel, and why (the source note in the
``.cu`` file has the detail): runs of ``LONG_RUN_ROWS`` rows or more go
through a ring in shared memory, one CTA a (run, 32-byte column tile), and
are bound by their chain of dependent adds (the fixed order allows no
split); every other run goes to a warp that covers whole rows with vector
loads and reads only the rows the run has, bound by bytes.  ``plan`` is
the launcher's rule, mirrored here and held equal to the kernel's own
(``kernel_plan``) by a gpu test.

``LAUNCHES`` sits beside ``ops.LAUNCHES`` (the six search kernels), so a
path that must launch none of those can still show this one.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"segment_sum": 0}
_LAUNCH_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "segment_sum_cuda"

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_LAUNCH_ARGTYPES = [_P] * 5 + [_LL, _P] + [_LL] * 3 + [ctypes.c_int, _P]

# The launcher's constants (csrc/segment_sum.cu; a gpu test holds ``plan``
# equal to the kernel's own over many shapes):
RUN_START_RATIO = 4        # S > 4 N: the tasks are sorted positions
LONG_RUN_ROWS = 64         # runs this long go through the ring
LONG_CTAS = 1024           # most CTAs of the ring part
WAVE_WARPS = 4096          # warps the short part aims at
MAX_SEGMENTS = 2 ** 31 - 2  # int32 ids, S itself pads the long-run list
RING_ROWS = 512            # rows a ring stage
RING_STAGES = 2
_WARPS = 8                 # warps a CTA
_SECTOR = 32               # bytes of a column tile
_RING_BYTES = RING_STAGES * RING_ROWS * (_SECTOR + 8)   # a tile and an id


class Runs(NamedTuple):
    """An id list set up for the kernel.  ``ids``: the ids as given (any
    shape); ``sorted`` [N] int32, the ids in stable sorted order (an id
    outside ``[0, S)`` as -1 or S), kept only where the segments outnumber
    the rows by more than ``RUN_START_RATIO`` (the run-start grid reads
    it; elsewhere it is None, which spares N * 4 bytes for as long as the
    runs are held); ``order`` [N] int64, their row numbers; ``offsets``
    [S + 1] int64, segment s's run is ``order[offsets[s]:offsets[s + 1]]``;
    ``long`` [ceil(N / 64)] int32, the segments whose runs hold at least
    ``LONG_RUN_ROWS`` rows, in increasing order, padded with S.  Off the
    card the set-up fields may all be None: the plain version reads only
    ``ids``."""
    ids: torch.Tensor
    num_segments: int
    sorted: Optional[torch.Tensor] = None
    order: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    long: Optional[torch.Tensor] = None


class Plan(NamedTuple):
    """The launcher's plan, field for field as ``csrc/segment_sum.cu``'s
    ``Plan``."""
    run_starts: int        # 1: tasks are sorted positions, output zeroed
    vec: int               # elements a vector load of the short part
    lanes: int             # lanes a group (a task's columns)
    passes: int            # warps a task block (column passes)
    tasks_per_warp: int
    task_blocks: int
    short_blocks: int
    copy_bytes: int        # cp.async size of the ring part, 0: no ring
    tiles: int             # 32-byte column tiles a row
    long_min: int          # runs this long go to the ring part, 0: none
    long_blocks: int
    smem_bytes: int


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["segment_sum"] = 0


def _fn(name, argtypes, restype=ctypes.c_int):
    fn = getattr(build.load("segment_sum"), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n_rows: int, num_segments: int, d: int, elem_bytes: int,
         align: int) -> Plan:
    """The launch for ``[n_rows, d]`` rows of ``elem_bytes`` bytes into
    ``num_segments`` segments, with ``align`` the largest power of two up
    to 16 dividing the data's address and its row bytes (``alignment``).
    Tasks are segments unless they outnumber the rows by more than
    ``RUN_START_RATIO`` (then sorted positions); a group of ``lanes`` lanes
    covers a row with ``vec``-element loads (16 bytes where ``align`` is
    16), in ``passes`` warps when wider than 32 lanes; each warp takes
    ``tasks_per_warp`` tasks, halved from 32 until the grid holds
    ``WAVE_WARPS`` warps.  Runs of ``LONG_RUN_ROWS`` rows or more go to
    the ring part (``long_blocks`` CTAs, 16- or 4-byte copies) when the
    rows allow a 4-byte copy and ``n_rows`` reaches one long run."""
    run_starts = int(_run_starts(n_rows, num_segments))
    vec = 16 // elem_bytes if align >= 16 else 1
    nv = d // vec
    lanes = 1
    while lanes < 32 and lanes < nv:
        lanes *= 2
    passes = _cdiv(nv, lanes)
    tasks = n_rows if run_starts else num_segments
    tw = 32
    while tw > 32 // lanes and _cdiv(tasks, tw) * passes < WAVE_WARPS:
        tw //= 2
    task_blocks = _cdiv(tasks, tw)
    copy_bytes = 16 if align >= 16 else (4 if align >= 4 else 0)
    tiles = _cdiv(d * elem_bytes, _SECTOR)
    n_long = _cdiv(n_rows, LONG_RUN_ROWS)
    ring = copy_bytes > 0 and n_long > 0
    return Plan(run_starts, vec, lanes, passes, tw, task_blocks,
                _cdiv(task_blocks * passes, _WARPS), copy_bytes, tiles,
                LONG_RUN_ROWS if ring else 0,
                min(n_long * tiles, LONG_CTAS) if ring else 0,
                _RING_BYTES if ring else 0)


def alignment(data2d) -> int:
    """The largest power of two up to 16 dividing ``data2d``'s address and
    its row bytes (what ``plan`` calls ``align``)."""
    row = data2d.shape[1] * data2d.element_size()
    a = 16
    while a > 1 and (data2d.data_ptr() % a or row % a):
        a //= 2
    return a


def kernel_plan(n_rows: int, num_segments: int, d: int, dtype,
                align: int) -> Plan:
    """The kernel's own plan for the same arguments (held to ``plan`` on
    the card)."""
    fn = _fn("segment_sum_plan", [_LL] * 3 + [ctypes.c_int] * 2 +
             [ctypes.POINTER(_LL)])
    out = (_LL * len(Plan._fields))()
    err = fn(n_rows, num_segments, d, _DTYPE_CODE[dtype], align, out)
    if err:
        raise ValueError(f"segment_sum_plan refused ({n_rows}, "
                         f"{num_segments}, {d}, {dtype}): cudaError {err}")
    return Plan(*[int(v) for v in out])


def add_chain(out, n: int, x: float = 1.0) -> None:
    """``n`` dependent ``__fadd_rn`` of ``x`` in one thread on the card,
    the sum into ``out`` (a CUDA fp32 tensor of one element): what one
    link of a long run's chain costs.  Not counted."""
    fn = _fn("segment_sum_add_chain", [_P, _LL, ctypes.c_float, _P])
    err = fn(out.data_ptr(), n, x,
             torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum add chain launch failed: "
                           f"cudaError {err}")


def long_runs(sorted_ids, offsets, num_segments: int):
    """``Runs.long`` from a stable sort and its offsets: the segment of
    each run of at least ``LONG_RUN_ROWS`` rows, found at the first chunk
    start (a multiple of ``LONG_RUN_ROWS`` in sorted order) inside it, in
    increasing order and padded with ``num_segments``; tensor ops on the
    ids' device, no host sync."""
    L = LONG_RUN_ROWS
    key = sorted_ids[::L]                       # the chunk starts' ids
    if num_segments == 0:
        return torch.zeros_like(key)
    s = key.clamp(0, num_segments - 1)
    lo, hi = offsets[s], offsets[1:][s]
    past = lo + L                               # a long run ends at or past
    pos = torch.arange(0, sorted_ids.shape[0], L, device=sorted_ids.device)
    own = (key == s) & (hi >= past) & (past > pos)
    return torch.where(own, key, num_segments).sort().values


def runs(seg_ids, num_segments: int) -> Runs:
    """The set-up of an id list (``Runs``) on the ids' device."""
    if not 0 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"{_KERNEL}: num_segments must lie in [0, "
                         f"{MAX_SEGMENTS}], got {num_segments}")
    flat = seg_ids.reshape(-1)
    if flat.dtype != torch.int32:       # out-of-range ids stay outside
        flat = flat.clamp(-1, num_segments).to(torch.int32)
    sorted_ids, order = torch.sort(flat, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=flat.device)
    offsets = torch.searchsorted(sorted_ids, bounds)
    long = long_runs(sorted_ids, offsets, num_segments)
    if not _run_starts(flat.shape[0], num_segments):
        sorted_ids = None
    return Runs(seg_ids, num_segments, sorted_ids, order, offsets, long)


def _run_starts(n_rows: int, num_segments: int) -> bool:
    """Whether the short part's tasks are sorted positions (``plan``)."""
    return num_segments > RUN_START_RATIO * n_rows


def as_rows(data):
    """``data [N, *tail]`` as ``[N, prod(tail)]``: a view where the rows
    are contiguous already (no copy), else a contiguous copy."""
    rows = data.reshape(data.shape[0], math.prod(data.shape[1:]))
    return rows if rows.is_contiguous() else rows.contiguous()


def launch_runs(data2d, r: Runs):
    """One launch of the kernel on the current stream over a ``Runs`` set
    up on the card: ``data2d [N, d]`` contiguous fp32 or bf16 on a CUDA
    device; returns ``out [S, d]``.  Not counted (``segment_sum_cuda``
    counts)."""
    dev = data2d.device
    if data2d.ndim != 2 or data2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"{_KERNEL}: data must be [N, d] float32 or "
                         f"bfloat16, got {data2d.dtype} "
                         f"{tuple(data2d.shape)}")
    N, d = data2d.shape
    S = r.num_segments
    starts = _run_starts(N, S)
    if r.order is None or (starts and r.sorted is None):
        raise ValueError(f"{_KERNEL}: the runs hold no set-up for {N} rows "
                         f"into {S} segments (made off the card, or for "
                         "other rows?)")
    n_long = _cdiv(N, LONG_RUN_ROWS)
    build.check_args(_KERNEL, dev, (
        ("data", data2d, data2d.dtype, None),
        ("order", r.order, torch.int64, (N,)),
        ("offsets", r.offsets, torch.int64, (S + 1,)),
        ("long", r.long, torch.int32, (n_long,)))
        + ((("sorted", r.sorted, torch.int32, (N,)),) if starts else ()))
    out = torch.empty((S, d), dtype=data2d.dtype, device=dev)
    err = _fn("segment_sum_launch", _LAUNCH_ARGTYPES)(
        data2d.data_ptr(), r.sorted.data_ptr() if starts else None,
        r.order.data_ptr(),
        r.offsets.data_ptr(), r.long.data_ptr(), n_long, out.data_ptr(), N,
        S, d, _DTYPE_CODE[data2d.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError "
                           f"{err}")
    return out


def _ids(seg, num_segments: int):
    if isinstance(seg, Runs):
        if seg.num_segments != num_segments:
            raise ValueError(f"{_KERNEL}: runs set up for "
                             f"{seg.num_segments} segments, asked for "
                             f"{num_segments}")
        return seg.ids
    return seg


def segment_sum_cuda(data, seg, num_segments: int):
    """The kernel path: the set-up unless ``seg`` brings it, one launch
    (counted), ``[S, *tail]``."""
    ids = _ids(seg, num_segments)
    if ids.device != data.device or ids.numel() != data.shape[0]:
        raise ValueError(f"{_KERNEL}: seg_ids must be [{data.shape[0]}] on "
                         f"{data.device}, got {tuple(ids.shape)} on "
                         f"{ids.device}")
    r = (seg if isinstance(seg, Runs) and seg.order is not None
         else runs(ids, num_segments))
    out = launch_runs(as_rows(data), r)
    with _LAUNCH_LOCK:
        LAUNCHES["segment_sum"] += 1
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def segment_sum(data, seg, num_segments: int):
    """Rows of ``data`` summed by ``seg`` (ids, or their ``Runs``) in
    increasing row order (see the module docstring): the kernel on CUDA
    tensors, the plain version on CPU and meta tensors."""
    kind = data.device.type
    if kind == "cuda":
        return segment_sum_cuda(data, seg, num_segments)
    if kind in ("cpu", "meta"):
        return ref.segment_sum_ref(data, _ids(seg, num_segments),
                                   num_segments)
    raise ValueError(f"segment_sum: unsupported device {data.device}")
