"""Hardware constants for the roofline terms (the counterpart of
``repro.roofline.hw``, which knows only the TPU v5e).

``H100_SXM`` holds NVIDIA's published figures for the H100 SXM5 80 GB at
its 700 W limit (the data sheet's dense rates, without sparsity).  A card
set below 700 W runs slower under load, so a share of these peaks is stated
with the card's power limit beside it.  ``peak(dtype)`` is the rate the
card multiplies that dtype at: the port runs fp32 products with TF32 off
(``device.py``), so fp32 work is bounded at the non-tensor-core 66.9
TFLOP/s, not at a tensor-core rate.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float     # FLOP/s per chip
    hbm_bw: float              # B/s per chip
    ici_link_bw: float         # B/s per link (NVLink: one direction)
    hbm_bytes: float           # capacity per chip
    peak_flops: Optional[Mapping[str, float]] = None   # by torch dtype name

    def peak(self, dtype: str = "bfloat16") -> float:
        """FLOP/s for products in ``dtype`` (the bf16 peak where the table
        names no other)."""
        return (self.peak_flops or {}).get(dtype, self.peak_flops_bf16)


TPU_V5E = HwSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_link_bw=50e9,
    hbm_bytes=16e9,
)

H100_SXM = HwSpec(
    name="h100-sxm5-80gb-700w",
    peak_flops_bf16=989.4e12,
    hbm_bw=3.35e12,
    ici_link_bw=450e9,
    hbm_bytes=80e9,
    peak_flops={"bfloat16": 989.4e12, "float16": 989.4e12,
                "float32": 66.9e12},
)
