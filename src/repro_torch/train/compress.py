"""Gradient compression for a cross-pod all-reduce.

The counterpart of ``repro.train.compress``: int8 stochastic-rounding
quantization with a per-tensor scale: quantize -> all-reduce (the sum of
int-valued floats is exact up to the shared scale) -> dequantize.  Cuts the
gradient all-reduce's wire bytes 4x (fp32) / 2x (bf16).  As in the
reference, nothing calls it yet and ``TrainerConfig.grad_compress`` is not
read.

Where the reference splits a JAX key into one key a leaf, the port draws
one seed a leaf from the caller's ``torch.Generator`` and seeds a generator
on that leaf's device with it (``split_generator``).  Error feedback
(residual carry) keeps the quantization noise from biasing convergence.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

# The int8 quantizer lives in repro_torch.quant.sq8 (one implementation,
# shared with the SQ8 tables' module); re-exported here for callers.
from repro_torch.quant.sq8 import (dequantize_int8, quantize_int8,  # noqa: F401
                                   quantize_int8_with_scale)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def split_generator(generator: Optional[torch.Generator],
                    devices) -> List[Optional[torch.Generator]]:
    """One generator on each of ``devices``, seeded from ``generator`` (in
    order), or ``None`` each when ``generator`` is ``None`` (round to
    nearest)."""
    devices = list(devices)
    if generator is None:
        return [None] * len(devices)
    seeds = torch.randint(0, 2 ** 62, (len(devices),), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=d).manual_seed(s)
            for d, s in zip(devices, seeds)]


def compress_tree(grads, generator: Optional[torch.Generator] = None
                  ) -> Tuple[Any, Any]:
    """(int8 tree, scale tree) of ``grads``, each leaf quantized on its own
    with its own generator."""
    leaves = tree_leaves(grads)
    gens = split_generator(generator, [leaf.device for leaf in leaves])
    out = [quantize_int8(leaf.float(), g) for leaf, g in zip(leaves, gens)]
    return (tree_unflatten(grads, [q for q, _ in out]),
            tree_unflatten(grads, [s for _, s in out]))


def decompress_tree(qs, scales):
    return tree_map(dequantize_int8, qs, scales)


def compressed_psum(grads, group: Optional[dist.ProcessGroup] = None,
                    generator: Optional[torch.Generator] = None):
    """Quantize -> sum over ``group`` -> dequantize, with the scale itself
    max-reduced first so all members dequantize identically.  With no
    group it is the one-member form: the max and the sum are the identity,
    so the result is each leaf quantized and dequantized at its scale."""
    leaves = tree_leaves(grads)
    gens = split_generator(generator, [leaf.device for leaf in leaves])
    out = []
    for leaf, g in zip(leaves, gens):
        x = leaf.float()
        amax = x.abs().max()
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = (amax + 1e-12) / 127.0
        y = quantize_int8_with_scale(x, scale, g).float()
        if group is not None:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)  # exact
        out.append(y * scale)
    return tree_unflatten(grads, out)


def with_error_feedback(grads, residual):
    """Add the carried residual; return (to_compress, new_residual_fn)."""
    carried = grads if residual is None else tree_map(
        lambda g, r: g + r, grads, residual)
    return carried, lambda q_deq: tree_map(lambda g, d: g - d, carried,
                                           q_deq)
