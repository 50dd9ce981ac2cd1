"""SQ8 scalar quantization: table codes and the distance lower bound.

The counterpart of ``repro.quant.sq8``, with its symmetric per-tensor
int8 quantizer (``quantize_int8``; ``train/compress.py`` re-exports it
for gradient compression, so there is one implementation).  Each
dimension j stores an affine grid ``x ~ lo[j] + code * scale[j]`` with
``code in [0, 255]``, so a row costs d bytes instead of 4d: the stage-1
estimate of the two-stage search path reads 4x fewer bytes than the fp32
row it replaces.

With ``xhat = lo + code * scale`` the reconstruction error per dimension is
``|x_j - xhat_j| <= eps_j = scale_j / 2`` (round-to-nearest, plus a small
float slack), so

    d2(q, x) >= ad2 - 2 * sum_j |q_j - xhat_j| * eps_j  =: lb2

with ``ad2 = |q - xhat|^2``: a candidate whose ``lb2`` already reaches the
pool bound can skip its fp32 row.

The NumPy side (``sq8_train`` / ``sq8_encode`` / ``sq8_decode``) is a copy
of the JAX package's, so the codes, ``lo``, ``scale`` and ``eps`` are
bit-equal for the same rows.  The torch side (``sq8_dequantize_rows`` /
``sq8_estimate``) sums in the ``sq8_distance`` CUDA kernel's order
(``repro_torch.kernels.ref.warp_order_sum``), so the plain and kernel
engines take the same stage-1 decisions on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import warp_order_sum

# Relative safety margin on the per-dimension error radius: round-to-nearest
# guarantees scale/2 in real arithmetic; encode/decode/bound evaluation in
# float32 adds ulp-level noise, covered many times over by 2^-10.
EPS_SLACK = 1.0 + 2.0 ** -10


@dataclasses.dataclass(frozen=True)
class SQ8Params:
    """Per-dimension affine grid: x ~ lo + code * scale, code in [0, 255]."""

    lo: np.ndarray      # [d] float32 grid origin (per-dimension min)
    scale: np.ndarray   # [d] float32 grid step, strictly positive
    eps: np.ndarray     # [d] float32 error radius = scale/2 * EPS_SLACK


def sq8_train(x: np.ndarray) -> SQ8Params:
    """Fit the per-dimension grid to the data (min/max range)."""
    x = np.asarray(x, np.float32)
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    # degenerate (constant) dimensions get a tiny step so scale stays > 0
    scale = np.maximum((hi - lo) / 255.0, 1e-12).astype(np.float32)
    eps = (0.5 * scale * EPS_SLACK).astype(np.float32)
    return SQ8Params(lo=lo.astype(np.float32), scale=scale, eps=eps)


def sq8_encode(x: np.ndarray, params: SQ8Params) -> np.ndarray:
    """Rows -> uint8 codes.  Rows outside the trained range clip (their
    reconstruction error exceeds eps — only feed rows the grid was fit on,
    plus sentinel pad rows whose distances are always masked)."""
    x = np.asarray(x, np.float32)
    q = np.rint((x - params.lo[None, :]) / params.scale[None, :])
    return np.clip(q, 0, 255).astype(np.uint8)


def sq8_decode(codes: np.ndarray, params: SQ8Params) -> np.ndarray:
    codes = np.asarray(codes)
    return (params.lo[None, :]
            + codes.astype(np.float32) * params.scale[None, :])


def sq8_dequantize_rows(codes: torch.Tensor, lo: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """uint8 codes [..., d] -> f32 rows ``lo + code * scale``, the product
    and the sum each rounded on its own (as the kernel does)."""
    return lo + codes.to(torch.float32) * scale


def sq8_estimate(queries: torch.Tensor, xhat: torch.Tensor,
                 eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate squared-Euclidean distance + conservative lower bound.

    queries [B, d] f32, xhat [B, L, d] f32 (dequantized rows), eps [d] f32
    -> (ad2 [B, L], lb2 [B, L]).  ``ad2 = sum delta^2`` and
    ``slack = 2 * sum |delta| * eps`` with ``delta = q - xhat``, both summed
    in the kernel's order; ``lb2 = max(ad2 - slack, 0)`` keeps NaN, as
    ``jnp.maximum`` does."""
    delta = queries.to(torch.float32)[:, None, :] - xhat
    ad2 = warp_order_sum(delta * delta)
    slack = 2.0 * warp_order_sum(delta.abs() * eps)
    lb2 = ad2 - slack
    return ad2, torch.where(lb2 < 0, torch.zeros_like(lb2), lb2)


# --------------------------------------------------------------------------
# Symmetric per-tensor int8 (gradient compression; train/compress.py
# re-exports these so there is exactly one int8 quantizer implementation).
# --------------------------------------------------------------------------
def quantize_int8_with_scale(x: torch.Tensor, scale,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """x / scale -> int8 in [-127, 127]: round half to even, or stochastic
    rounding (``floor(y + u)``, u uniform in [0, 1) from ``generator``,
    which must live on x's device) when a generator is given."""
    y = x / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       device=y.device, dtype=y.dtype))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """Returns (q int8, scale) with per-tensor amax/127 scale."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    return quantize_int8_with_scale(x, scale, generator), scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale
