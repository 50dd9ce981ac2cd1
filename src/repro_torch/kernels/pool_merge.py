"""Binding of the hand-written CUDA kernel ``csrc/pool_merge.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.pool_merge``
(``pool_merge_pallas``).  The source note in the ``.cu`` file says what
bounds it and how its two variants answer that: one warp a row with the
entries in registers (``net <= WARP_MAX_NET``), several warps a row through
shared memory beyond; ``choose_variant`` picks one by shape.  The plain
PyTorch version is ``repro_torch.kernels.ref.pool_merge_ref`` and the
public wrapper is ``repro_torch.kernels.ops.pool_merge``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 6 + [ctypes.c_int] * 5 + [_P]
WARP_MAX_NET = 512  # the warp variant: 16 entries a lane in registers
MAX_NET = 4096      # the block variant: shared memory is MAX_NET * 8 = 32 KB
VARIANTS = ("warp", "block")


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def choose_variant(P: int, L: int):
    """The kernel variant for a [B, P] pool and a [B, L] tile, and its
    network length: ``("warp", net)`` while the power of two >= P + L (at
    least 32) is at most ``WARP_MAX_NET``, ``("block", net)`` up to
    ``MAX_NET``.  Raises ``ValueError`` beyond."""
    net = max(next_pow2(P + L), 32)
    if net <= WARP_MAX_NET:
        return "warp", net
    if net <= MAX_NET:
        return "block", net
    raise ValueError(f"pool_merge_cuda: P + L = {P + L} exceeds the "
                     f"kernel's network of {MAX_NET}")


def _lib():
    lib = build.load("pool_merge")
    fn = lib.pool_merge_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pool_merge_cuda(pool_d, pool_i, new_d, new_i):
    """Launch the kernel on the current stream.

    pool_d/pool_i [B, P] f32/int32 (sorted by (dist, id) except after a
    stage-2 rerank; the kernel orders the whole union), new_d/new_i [B, L]
    f32/int32, contiguous on one CUDA device -> best P of the union, from
    the variant ``choose_variant`` picks.  Raises on any launch error;
    there is no fallback.
    """
    B, P = pool_d.shape
    L = new_d.shape[1]
    dev = pool_d.device
    build.check_args("pool_merge_cuda", dev, (
        ("pool_d", pool_d, torch.float32, (B, P)),
        ("pool_i", pool_i, torch.int32, (B, P)),
        ("new_d", new_d, torch.float32, (B, L)),
        ("new_i", new_i, torch.int32, (B, L))))
    variant, net = choose_variant(P, L)
    out_d = torch.empty((B, P), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, P), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(pool_d.data_ptr(), pool_i.data_ptr(), new_d.data_ptr(),
                 new_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                 B, P, L, net, VARIANTS.index(variant), stream)
    if err != 0:
        raise RuntimeError(f"pool_merge kernel launch failed: cudaError {err}")
    return out_d, out_i
