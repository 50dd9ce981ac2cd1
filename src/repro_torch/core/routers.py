"""Pluggable routing strategies: the ``Router`` protocol + registry.

The counterpart of ``repro.core.routers``.  A *router* decides, per
candidate lane of the ``[B, W*M]`` expansion tile, whether the exact
distance call can be skipped.  Each strategy is a registry entry declaring:

* the **flags** the engine consumes (``prunes`` / ``permanent`` /
  ``revisit_pruned`` / ``counts_est`` / ``kernel_estimate``);
* an ``estimate_rank`` hook giving the per-lane estimated ranking distance
  plus any **router-specific counters** it wants surfaced in
  ``SearchStats.extra``;
* a ``prepare`` hook that lazily adds companion tables to the per-graph
  device-array cache (as ``ensure_sq8_arrays`` adds the SQ8 codes the
  first time a quantized spec runs).

Built-ins: ``none`` (Algorithm 1), ``crouting`` / ``crouting_o`` (paper
Algorithm 2 with / without error correction), ``triangle`` (the exact
triangle-inequality lower bound, §3.2) and ``finger``, an engine-integrated
port of the FINGER baseline (Chen et al., WWW'23, ``core/finger.py``):
residual-subspace estimates with sign-LSH signatures, evaluated tile-wide
in plain PyTorch on the index's device.

The edge-angle family evaluates ``est2 = ed^2 + dcq^2 -
2*ed*dcq*cos_theta`` in the same f32 order as the ``fused_expand`` and
``crouting_prune`` kernels, so its prune decisions are bit-equal whether
the hook or a kernel takes them (``kernel_estimate=True``).  FINGER's
estimate has another form: its hook runs under every engine, and the
kernels still do the row gather, the distance and the merge.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distances import get_metric
from repro_torch.core.graph import GraphIndex
from repro_torch.kernels.ref import edge_angle_est2


class RouterContext(NamedTuple):
    """Everything a router's ``estimate_rank`` hook may look at.

    Shapes: B queries, W beam slots, M max degree, L = W*M tile lanes.
    No neighbour row may be read here: a router decides the prune before
    that load happens (the W expansion nodes' own rows are fair game: their
    exact distances are already paid).
    """

    arrays: Dict[str, Any]   # per-graph device tables (graph_device_arrays)
    queries: torch.Tensor    # [B, d] f32
    nq: torch.Tensor         # [B] query norms (ones under l2)
    c: torch.Tensor          # [B, W] expansion-node ids (pad = n)
    dc: torch.Tensor         # [B, W] exact ranking distance d(c, q)
    nbrs: torch.Tensor       # [B, L] neighbour ids (pad = n)
    ed: torch.Tensor         # [B, L] stored edge Euclidean distances d(c, n)
    dcq: torch.Tensor        # [B, L] per-lane Euclidean d(c, q)
    nx: torch.Tensor         # [B, L] neighbour norms
    try_prune: torch.Tensor  # [B, L] bool — lanes eligible for the prune test
    upper: torch.Tensor      # [B] frozen pool upper bound (ranking space)
    cos_theta: float         # cos(theta*) from the profile
    metric: str
    n: int                   # number of real rows (pad row index)
    beam_width: int          # W
    max_degree: int          # M


@dataclasses.dataclass(frozen=True)
class Router:
    """A routing strategy: flags the engine consumes + optional hooks.

    Attributes:
      name: registry key (``SearchSpec.router``).
      prunes: whether the strategy runs an estimate/prune test at all.
      permanent: pruned lanes are marked VISITED — final, never revisited.
        Correct for exact bounds (``triangle``) and strategies that prune
        permanently by design (``finger``).
      revisit_pruned: PRUNED lanes may be re-estimated on a later encounter
        (the paper's error correction).  ``crouting_o`` sets ``False``.
      counts_est: estimate evaluations increment ``est_calls``.
      kernel_estimate: the estimate is the edge-angle form the
        ``fused_expand`` and ``crouting_prune`` kernels implement, so the
        prune decision may be taken in a kernel.
      extra_counters: names of per-router ``[B]`` int32 counters the
        ``estimate_rank`` hook returns; surfaced as ``SearchStats.extra``.
      companion_tables: keys ``prepare`` adds to the arrays cache.
      graph_safe: ``estimate_rank`` waits on nothing from the device (no
        host read of a tensor, no synchronisation) and reads only the
        context's tensors and Python values, so the hop loop may capture
        an iteration that calls it in a CUDA graph and replay it.  A router
        that does not declare it runs every iteration eagerly.  The base
        class leaves it False, as a hook written elsewhere may read the
        device; ``EdgeAngleRouter``, ``FingerRouter`` and ``none`` declare
        it.  A copy of one with ``graph_safe=False`` searches alike, with
        every kernel launched from Python (``chip_smoke.py`` records the
        kernels' inputs so).
    """

    name: str
    prunes: bool = False
    permanent: bool = False
    revisit_pruned: bool = True
    counts_est: bool = True
    kernel_estimate: bool = False
    extra_counters: Tuple[str, ...] = ()
    companion_tables: Tuple[str, ...] = ()
    graph_safe: bool = False

    def cos_theta_eff(self, cos_theta):
        """The cos(theta) the edge-angle estimate uses."""
        return cos_theta

    def prepare(self, g: GraphIndex, arrays: Dict[str, Any]) -> Dict[str, Any]:
        """Lazily add companion device tables to the per-graph cache
        (idempotent; as ``ensure_sq8_arrays``)."""
        return arrays

    def estimate_rank(self, ctx: RouterContext
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Per-lane estimated ranking distance + extra-counter increments.

        Returns ``(est_rank [B, L], {counter_name: [B] int32 increment})``.
        The engine prunes ``try_prune`` lanes whose estimate already
        reaches the frozen pool bound.
        """
        raise NotImplementedError(
            f"router {self.name!r} declares prunes={self.prunes} but no "
            "estimate_rank hook")


@dataclasses.dataclass(frozen=True)
class EdgeAngleRouter(Router):
    """Cosine-theorem family (paper §3): estimate d(n, q) from the stored
    edge distance d(c, n), the known d(c, q) and an angle threshold.

    ``fixed_cos`` pins the angle term: ``triangle`` uses ``1.0``, turning
    the estimate into the exact lower bound ``(d(c,n) - d(c,q))^2``.
    """

    fixed_cos: Optional[float] = None
    graph_safe: bool = True          # the estimate is tensor ops alone

    def cos_theta_eff(self, cos_theta):
        return self.fixed_cos if self.fixed_cos is not None else cos_theta

    def estimate_rank(self, ctx: RouterContext):
        est2 = edge_angle_est2(ctx.ed, ctx.dcq,
                               self.cos_theta_eff(ctx.cos_theta))
        return get_metric(ctx.metric).eu2_to_rank(est2, ctx.nq[:, None],
                                                  ctx.nx), {}


# --------------------------------------------------------------------------
# FINGER (engine-integrated port of core/finger.py)
# --------------------------------------------------------------------------
_FINGER_TABLES = ("finger_H", "finger_c2", "finger_hc", "finger_edge_t",
                  "finger_edge_rn", "finger_edge_sig")


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each element of an int64 tensor holding values in
    [0, 2^32): a SWAR popcount (PyTorch has no popcount op).  On int64
    the shifts are exact for these values and the final product stays
    below 2^57."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def ensure_finger_arrays(g: GraphIndex, arrays: Dict[str, Any],
                         r_bits: int = 64) -> Dict[str, Any]:
    """Add the FINGER companion tables to a device arrays dict (idempotent).

    The tables are built on the host by ``core/finger.py``'s NumPy
    ``build_finger`` (per edge: projection coefficient, residual norm,
    packed sign-LSH signature; per node: |c|^2 and H@c), then the pad row
    is appended (zero vector: t=0, |res|=0, empty signature) and the uint64
    signature words are re-packed into little-endian uint32 pairs, stored
    as int32 with the same bits: bit b of word j is hyperplane column
    32*j + b, matching the query-side packing in ``FingerRouter``.
    """
    if "finger_edge_sig" in arrays:
        return arrays
    from repro_torch.core.finger import build_finger

    dev = arrays["vectors"].device
    fi = build_finger(g, r_bits=r_bits, seed=0)
    m = g.max_degree
    c2 = np.concatenate([fi.node_c2, np.ones(1, np.float32)])
    hc = np.concatenate([fi.node_hc, np.zeros((1, r_bits), np.float32)])
    t = np.concatenate([fi.edge_t, np.zeros((1, m), np.float32)])
    rn = np.concatenate([fi.edge_res_norm, np.zeros((1, m), np.float32)])
    sig = np.concatenate(
        [fi.edge_sig, np.zeros((1, m, r_bits // 64), np.uint64)], axis=0)
    lo = (sig & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (sig >> np.uint64(32)).astype(np.uint32)
    sig32 = np.stack([lo, hi], axis=-1).reshape(g.n + 1, m, r_bits // 32)
    for key, a in (("finger_H", fi.hyperplanes), ("finger_c2", c2),
                   ("finger_hc", hc), ("finger_edge_t", t),
                   ("finger_edge_rn", rn),
                   ("finger_edge_sig", sig32.view(np.int32))):
        arrays[key] = torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return arrays


@dataclasses.dataclass(frozen=True)
class FingerRouter(Router):
    """Residual-subspace estimate (FINGER, Chen et al., WWW'23) as a tile
    hook: per expansion node c the query decomposes into a component along
    c and a residual whose angle to each neighbour's residual is estimated
    from the Hamming distance of sign-LSH signatures.  Prunes permanently,
    like the baseline (``finger_search``).  L2-exact; other metrics go
    through the same Euclidean-to-rank conversion as the edge-angle family.
    The f32 expression follows ``repro.core.routers.FingerRouter`` term by
    term, so the prune decisions agree with the JAX package's.
    """

    r_bits: int = 64
    graph_safe: bool = True          # the estimate is tensor ops alone

    def prepare(self, g, arrays):
        return ensure_finger_arrays(g, arrays, r_bits=self.r_bits)

    def estimate_rank(self, ctx: RouterContext):
        arrays, q, c = ctx.arrays, ctx.queries, ctx.c.long()
        B, L = ctx.nbrs.shape
        H = arrays["finger_H"]                           # [r, d]
        r_bits = H.shape[0]
        cvec = arrays["vectors"][c]                      # [B, W, d]
        c2 = torch.clamp_min(arrays["finger_c2"][c], 1e-12)   # [B, W]
        t_q = torch.einsum("bd,bwd->bw", q, cvec) / c2   # [B, W]
        q2 = torch.sum(q * q, dim=-1)                    # [B]
        q_res2 = torch.clamp_min(q2[:, None] - t_q * t_q * c2, 0.0)
        q_rn = torch.sqrt(q_res2)                        # [B, W]
        # query-residual signature w.r.t. node c: sign(Hq - t_q * Hc)
        hq = q @ H.T                                     # [B, r]
        hc = arrays["finger_hc"][c]                      # [B, W, r]
        bits = (hq[:, None, :] - t_q[..., None] * hc) > 0
        pow2 = torch.arange(32, device=q.device, dtype=torch.int64)
        sig_q = (bits.reshape(bits.shape[:-1] + (r_bits // 32, 32))
                 .to(torch.int64) << pow2).sum(-1)       # [B, W, words]
        esig = arrays["finger_edge_sig"][c].to(torch.int64) & 0xFFFFFFFF
        ham = popcount32(esig ^ sig_q[:, :, None, :]).sum(-1)   # [B, W, M]
        rho = ham.to(torch.float32) / r_bits
        t_n = arrays["finger_edge_t"][c]                 # [B, W, M]
        n_rn = arrays["finger_edge_rn"][c]
        # paper Eq. 1: |q-n|^2 ~= (t_q-t_n)^2 |c|^2 + |q_res|^2 + |n_res|^2
        #                         - 2 |q_res||n_res| cos(pi rho)
        dt = t_q[..., None] - t_n
        est2 = (dt * dt * c2[..., None] + q_res2[..., None] + n_rn * n_rn
                - 2.0 * q_rn[..., None] * n_rn * torch.cos(math.pi * rho))
        est2 = torch.clamp_min(est2, 0.0).reshape(B, L)
        est_rank = get_metric(ctx.metric).eu2_to_rank(
            est2, ctx.nq[:, None], ctx.nx)
        extras = {"finger_est_calls": ctx.try_prune.sum(1, dtype=torch.int32)}
        return est_rank, extras


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, Router] = {}


def register_router(router: Router, overwrite: bool = False) -> Router:
    """Add a routing strategy to the registry (``SearchSpec.router`` key)."""
    if router.name in _REGISTRY and not overwrite:
        raise ValueError(f"router {router.name!r} already registered; pass "
                         "overwrite=True to replace it")
    _REGISTRY[router.name] = router
    return router


def unregister_router(name: str) -> None:
    """Remove a registry entry (built-ins included — tests use this)."""
    _REGISTRY.pop(name, None)


def get_router(name: str) -> Router:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown router {name!r}; registered: {available_routers()}"
        ) from None


def available_routers() -> Tuple[str, ...]:
    """Registered strategy names, registration order (built-ins first)."""
    return tuple(_REGISTRY)


register_router(Router(name="none", prunes=False, graph_safe=True))
register_router(EdgeAngleRouter(name="crouting", prunes=True,
                                kernel_estimate=True))
register_router(EdgeAngleRouter(name="crouting_o", prunes=True,
                                revisit_pruned=False, kernel_estimate=True))
register_router(EdgeAngleRouter(name="triangle", prunes=True, permanent=True,
                                counts_est=False, kernel_estimate=True,
                                fixed_cos=1.0))
register_router(FingerRouter(name="finger", prunes=True, permanent=True,
                             extra_counters=("finger_est_calls",),
                             companion_tables=_FINGER_TABLES))
