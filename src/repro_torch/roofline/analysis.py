"""Three-term roofline for the port's cells (the counterpart of
``repro.roofline.analysis``).

  compute    = FLOPs / peak FLOP/s (by dtype: ``HwSpec.peak``)
  memory     = bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

The reference reads its FLOPs and bytes from XLA's compiled cost analysis
and its collectives from the partitioned HLO text.  The port compiles
nothing: ``count_step`` runs a step on meta tensors (shapes, no data, no
device) and counts what the eager ops would do:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total (matrix
  products, convolutions, attention), split by the dtype of the product's
  first operand (``flops_by_dtype``), since an fp32 product with TF32 off
  runs at another peak than a bf16 one;
* ``bytes_min``: every argument read once and every output written once
  (an output that is an argument, written in place, counts once).  No
  implementation of the step moves less, so the memory term uses it;
* ``bytes_eager``: the sum of each aten op's input and output bytes (views
  and allocations move nothing), what the eager port moves if no operand
  stays in cache, reported beside.

The port produces no HLO and has no partitioner, so it has no counterpart
of ``parse_collectives``: its collective term is 0 on one card, and the
dry run leaves it ``None`` on a multi-device mesh, with the reason.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.roofline.hw import TPU_V5E, HwSpec
from repro_torch.tree import tree_leaves

_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default, torch.ops.aten.detach.default,
          torch.ops.aten.lift_fresh.default}


def operand_bytes(t: torch.Tensor) -> float:
    """Bytes of the distinct elements a tensor holds (an expanded view
    counts its source once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return float(n * t.element_size())


def _tensors(tree):
    return [x for x in _pt_leaves(tree) if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Per aten op: FLOPs by dtype (flop_counter's formulas) and the bytes
    of its tensor operands and results."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            first = _tensors(args)[0]
            dt = str(first.dtype).removeprefix("torch.")
            self.flops[dt] += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        if not (func.is_view or func in _ALLOC):
            self.bytes += sum(operand_bytes(t) for t in
                              _tensors((args, kwargs)) + _tensors(out))
        return out


def count_step(fn, *args) -> dict:
    """Run ``fn(*args)`` on meta tensors and count it: ``flops`` (total,
    from FlopCounterMode), ``flops_by_dtype``, ``bytes_min``,
    ``bytes_eager`` and the number of aten ops (``ops``)."""
    ins = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    if any(t.device.type != "meta" for t in ins):
        raise ValueError("count_step runs on meta tensors only")
    counter = _Counter()
    with FlopCounterMode(display=False) as fc, counter:
        out = fn(*args)
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    seen = {id(t) for t in ins}
    bytes_min = sum(operand_bytes(t) for t in ins) + sum(
        operand_bytes(t) for t in outs if id(t) not in seen)
    total = float(fc.get_total_flops())
    return {"flops": total, "flops_by_dtype": dict(counter.flops),
            "bytes_min": float(bytes_min), "bytes_eager": counter.bytes,
            "ops": counter.ops}


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_wire_bytes: float, hw: HwSpec = TPU_V5E,
                   model_flops_per_dev: Optional[float] = None,
                   flops_by_dtype: Optional[Mapping[str, float]] = None,
                   dtype: str = "bfloat16") -> dict:
    """The reference's terms and keys.  The compute term takes each
    dtype's FLOPs at its own peak where ``flops_by_dtype`` is given, else
    all of ``flops_per_dev`` at ``dtype``'s peak (the bf16 peak by
    default, as the reference takes it); the model's FLOPs count at
    ``dtype``'s peak."""
    if flops_by_dtype:
        t_comp = sum(f / hw.peak(dt) for dt, f in flops_by_dtype.items())
    else:
        t_comp = flops_per_dev / hw.peak(dtype)
    t_mem = bytes_per_dev / hw.hbm_bw
    t_coll = coll_wire_bytes / hw.ici_link_bw
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_comp, t_mem, t_coll)
    out = dict(terms)
    out["dominant"] = dom
    out["step_time_lb_s"] = bound
    out["roofline_fraction"] = (t_comp / bound) if bound > 0 else 0.0
    if model_flops_per_dev is not None:
        out["model_flops_per_dev"] = model_flops_per_dev
        out["useful_flop_ratio"] = (model_flops_per_dev / flops_per_dev
                                    if flops_per_dev else 0.0)
        out["model_compute_s"] = model_flops_per_dev / hw.peak(dtype)
        out["mfu_upper_bound"] = (out["model_compute_s"] / bound
                                  if bound > 0 else 0.0)
    return out
