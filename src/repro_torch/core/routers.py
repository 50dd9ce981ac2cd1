"""Pluggable routing strategies: the ``Router`` protocol + registry.

The counterpart of ``repro.core.routers``.  A *router* decides, per
candidate lane of the ``[B, W*M]`` expansion tile, whether the exact
distance call can be skipped.  Each strategy is a registry entry declaring
the flags the engine consumes (``prunes`` / ``permanent`` /
``revisit_pruned`` / ``counts_est`` / ``kernel_estimate``) and an
``estimate_rank`` hook giving the per-lane estimated ranking distance.

Built-ins: ``none`` (Algorithm 1), ``crouting`` / ``crouting_o`` (paper
Algorithm 2 with / without error correction) and ``triangle`` (the exact
triangle-inequality lower bound, §3.2).  The edge-angle family evaluates
``est2 = ed^2 + dcq^2 - 2*ed*dcq*cos_theta`` in the same f32 order as the
``fused_expand`` kernel, so its prune decisions are bit-equal whether the
hook or the kernel takes them (``kernel_estimate=True``).  The FINGER
router is not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.distances import get_metric
from repro_torch.kernels.ref import edge_angle_est2


class RouterContext(NamedTuple):
    """Everything a router's ``estimate_rank`` hook may look at.

    Shapes: B queries, W beam slots, M max degree, L = W*M tile lanes.
    No neighbour row may be read here: a router decides the prune before
    that load happens.
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
    """A routing strategy: flags the engine consumes + an estimate hook.

    Attributes:
      name: registry key (``SearchSpec.router``).
      prunes: whether the strategy runs an estimate/prune test at all.
      permanent: pruned lanes are marked VISITED — final, never revisited.
      revisit_pruned: PRUNED lanes may be re-estimated on a later encounter
        (the paper's error correction).  ``crouting_o`` sets ``False``.
      counts_est: estimate evaluations increment ``est_calls``.
      kernel_estimate: the estimate is the edge-angle form the
        ``fused_expand`` kernel implements, so the prune decision may be
        taken in the kernel.
    """

    name: str
    prunes: bool = False
    permanent: bool = False
    revisit_pruned: bool = True
    counts_est: bool = True
    kernel_estimate: bool = False

    def cos_theta_eff(self, cos_theta):
        """The cos(theta) the edge-angle estimate uses."""
        return cos_theta

    def estimate_rank(self, ctx: RouterContext) -> torch.Tensor:
        """Per-lane estimated ranking distance ``[B, L]``; the engine prunes
        ``try_prune`` lanes whose estimate already reaches the pool bound."""
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

    def cos_theta_eff(self, cos_theta):
        return self.fixed_cos if self.fixed_cos is not None else cos_theta

    def estimate_rank(self, ctx: RouterContext) -> torch.Tensor:
        est2 = edge_angle_est2(ctx.ed, ctx.dcq,
                               self.cos_theta_eff(ctx.cos_theta))
        return get_metric(ctx.metric).eu2_to_rank(est2, ctx.nq[:, None],
                                                  ctx.nx)


_REGISTRY: Dict[str, Router] = {}


def register_router(router: Router, overwrite: bool = False) -> Router:
    """Add a routing strategy to the registry (``SearchSpec.router`` key)."""
    if router.name in _REGISTRY and not overwrite:
        raise ValueError(f"router {router.name!r} already registered; pass "
                         "overwrite=True to replace it")
    _REGISTRY[router.name] = router
    return router


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


register_router(Router(name="none", prunes=False))
register_router(EdgeAngleRouter(name="crouting", prunes=True,
                                kernel_estimate=True))
register_router(EdgeAngleRouter(name="crouting_o", prunes=True,
                                revisit_pruned=False, kernel_estimate=True))
register_router(EdgeAngleRouter(name="triangle", prunes=True, permanent=True,
                                counts_est=False, kernel_estimate=True,
                                fixed_cos=1.0))
