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
  backward gathers the gradient rows back.  It keeps only the ids (or
  their runs):
  autograd's own ``index_add`` keeps its ``[E, d]`` source for the
  backward (15.8 GB a layer for gin-tu at ogb_products).

Both take the ids or their ``Runs`` (``runs(ids, S)``: the kernel's
set-up, a sort and searchsorted, done once where one id list feeds many
lookups and sums, as the GNN layers' edge lists do; there is no cache).

On CPU tensors both take the plain version (``ref.segment_sum_ref``,
``index_add_`` into zeros, on the ids), on meta tensors too (shapes only);
on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import segment_sum as K


def runs(ids, num_segments: int) -> K.Runs:
    """The set-up of ``ids`` for sums into ``num_segments`` rows, to pass in
    place of the ids: on the card the kernel's ``Runs``; elsewhere only the
    ids (the plain version needs nothing more)."""
    if ids.device.type == "cuda":
        return K.runs(ids, num_segments)
    return K.Runs(ids, num_segments)


def _save(ctx, seg):
    """Save ``seg`` (ids, or their ``Runs``) for the backward through
    ``save_for_backward``, so that autograd checks that none of its tensors
    changed in place meanwhile; returns the ids."""
    if isinstance(seg, K.Runs):
        ctx.num_segments = seg.num_segments
        ctx.save_for_backward(seg.ids, seg.sorted, seg.order, seg.offsets,
                              seg.long)
        return seg.ids
    ctx.num_segments = None
    ctx.save_for_backward(seg)
    return seg


def _saved(ctx):
    """What the kernel takes (the ``Runs`` or the flat ids), from what
    ``_save`` kept."""
    ids, *setup = ctx.saved_tensors
    if ctx.num_segments is None:
        return ids.reshape(-1)
    return K.Runs(ids, ctx.num_segments, *setup)


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seg, table):
        ids = _save(ctx, seg)
        ctx.shape = tuple(ids.shape)
        ctx.rows = table.shape[0]
        flat = ids.reshape(-1).long()
        return table.index_select(0, flat).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[1]:
            return None, None
        n = math.prod(ctx.shape)
        g = grad.reshape((n,) + tuple(grad.shape[len(ctx.shape):]))
        return None, K.segment_sum(g, _saved(ctx), ctx.rows)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg, num_segments):
        if isinstance(seg, K.Runs):
            ctx.save_for_backward(seg.ids)
            return K.segment_sum(data, seg, num_segments)
        ctx.save_for_backward(seg)
        return K.segment_sum(data, seg.reshape(-1), num_segments)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        ids, = ctx.saved_tensors
        return grad.index_select(0, ids.reshape(-1).long()), None, None


def embedding(ids, table):
    """``table[ids]`` ([*ids.shape, *table.shape[1:]]) with a fixed-order
    backward: the counterpart of ``jnp.take(table, ids, axis=0)``.  ``ids``
    may be their ``runs(ids, table.shape[0])``."""
    return _Embedding.apply(ids, table)


def segment_sum(data, seg_ids, num_segments: int):
    """Rows of ``data [N, ...]`` summed by ``seg_ids [N]`` (or their
    ``runs(seg_ids, num_segments)``) into ``[num_segments, ...]`` in
    increasing row order: the counterpart of ``jax.ops.segment_sum``."""
    return _SegmentSum.apply(data, seg_ids, num_segments)
