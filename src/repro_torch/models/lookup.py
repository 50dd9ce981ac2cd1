"""Row lookups and segment sums whose gradients repeat bit for bit.

Every sum of rows by id in the port's models goes through here, so that
each one adds in a fixed order on the card as on the CPU
(``kernels/segment_sum.py``: increasing row order, from zero):

* ``embedding(ids, table)``: ``table[ids]``.  The forward is a row gather;
  the backward sums the gradient rows into ``[V, d]`` with
  ``segment_sum``.  ``F.embedding``'s CUDA backward (and ``index_add_``)
  add a row's duplicates in an order that changes from run to run, which
  made DLRM's small tables (3 to 155 rows at B = 65,536) differ between
  two identical steps.
* ``segment_sum(data, seg_ids, S)``: the forward is the kernel; the
  backward gathers the gradient rows back.  It saves only the ids:
  autograd's own ``index_add`` keeps its ``[E, d]`` source for the
  backward (15.8 GB a layer for gin-tu at ogb_products).

On CPU tensors both take the plain version (``ref.segment_sum_ref``,
``index_add_`` into zeros), on meta tensors too (shapes only); on CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segment_sum as K


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        flat = ids.reshape(-1).long()
        return table.index_select(0, flat).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[1]:
            return None, None
        (ids,) = ctx.saved_tensors
        g = grad.reshape((ids.numel(),) + tuple(grad.shape[ids.ndim:]))
        return None, K.segment_sum(g, ids.reshape(-1), ctx.rows)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        return K.segment_sum(data, seg_ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (seg_ids,) = ctx.saved_tensors
        return grad.index_select(0, seg_ids.reshape(-1).long()), None, None


def embedding(ids, table):
    """``table[ids]`` ([*ids.shape, *table.shape[1:]]) with a fixed-order
    backward: the counterpart of ``jnp.take(table, ids, axis=0)``."""
    return _Embedding.apply(ids, table)


def segment_sum(data, seg_ids, num_segments: int):
    """Rows of ``data [N, ...]`` summed by ``seg_ids [N]`` into
    ``[num_segments, ...]`` in increasing row order: the counterpart of
    ``jax.ops.segment_sum``."""
    return _SegmentSum.apply(data, seg_ids, num_segments)
