"""Typed search configuration + statistics (the port's ``SearchSpec``).

The counterpart of ``repro.core.spec``.  ``SearchSpec`` is the one
search-request object, carried through ``AnnIndex.search`` and
``build_search_fn``; anything else raises ``TypeError``.

Engines (``SearchSpec.engine``):

* ``"fused"`` — the kernel engine, the counterpart of the JAX package's
  ``"pallas"``: the hop loop runs the hand-written CUDA kernels
  ``fused_expand`` (estimate + prune + conditional row load + exact
  distance) and ``pool_merge`` (the sorted-pool merge).  On CPU tensors the
  kernel wrappers run their plain PyTorch versions.  The default.
* ``"unfused"`` — the composable kernel engine, the counterpart of
  ``"pallas_unfused"``: ``crouting_prune`` (estimate + prune), then
  ``gather_distance`` under the prune mask, then ``pool_merge``.
* ``"torch"`` — the plain engine, the counterpart of ``"jnp"``: the same
  loop in plain PyTorch ops (gather + distance, concat + two stable sorts).

Estimates (``SearchSpec.estimate``): ``"exact"`` and ``"angle"`` give
every surviving lane its exact fp32 distance; ``"sq8"`` and ``"both"`` run
the two-stage path (an SQ8 estimate and lower bound from uint8 code rows,
the ``sq8_distance`` kernel, then an exact rerank through
``gather_distance`` only for candidates that are expanded or returned).
``"angle"`` and ``"both"`` need a pruning router.

The fields split into two cost classes: engine-shaping fields key the
engine cache (``canonical()``), request-only fields (``k``/``cos_theta``)
do not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

ENGINES = ("fused", "unfused", "torch")
ESTIMATES = ("exact", "angle", "sq8", "both")
BEAM_PRUNE_POLICIES = ("best", "all")

_K_DEFAULT = 10


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One frozen object describing a search request end to end.

    Engine-shaping fields (everything except ``k``/``cos_theta``) key the
    engine cache; ``k`` only slices the returned pool and ``cos_theta`` is
    a call argument (see ``canonical()``).

    ``metric`` and ``use_hierarchy`` are *index* properties: ``AnnIndex``
    overwrites them from the graph, so user-built specs can leave the
    defaults.
    """

    efs: int = 100                # result-pool size (>= k)
    router: str = "none"          # registry name (repro_torch.core.routers)
    metric: str = "l2"
    max_hops: int = 4096          # hard per-query expansion budget
    use_hierarchy: bool = True
    beam_width: int = 1           # W frontier nodes expanded per iteration
    engine: str = "fused"         # fused | unfused (kernels) | torch (plain)
    # Which beam slots' lanes are eligible for the router's prune test:
    # "best" — only the best slot's neighbours (what sequential Algorithm 2
    # would test now); "all" — every slot's neighbours.
    beam_prune: str = "best"
    # "exact" — every surviving lane gets its exact fp32 distance; "angle" —
    # the same, but requires a pruning router.  "sq8" — surviving lanes
    # read the uint8 code row for an estimate + lower bound; lanes whose
    # bound reaches the pool bound are dropped without their fp32 row, the
    # others enter the pool approximate and are reranked exactly when
    # expanded or returned.  "both" — sq8 behind a pruning router.
    estimate: str = "exact"
    # Request-only fields (do not shape the engine):
    k: int = _K_DEFAULT           # how many results to return per query
    cos_theta: Optional[float] = None   # None -> the index's angle profile

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"choose from {ENGINES}")
        if self.estimate not in ESTIMATES:
            raise ValueError(f"unknown estimate {self.estimate!r}")
        if self.beam_prune not in BEAM_PRUNE_POLICIES:
            raise ValueError(f"unknown beam_prune policy {self.beam_prune!r}")
        if self.beam_width < 1:
            raise ValueError("beam_width must be >= 1")

    def canonical(self) -> "SearchSpec":
        """Strip the request-only fields — the engine cache key."""
        if self.k == _K_DEFAULT and self.cos_theta is None:
            return self
        return dataclasses.replace(self, k=_K_DEFAULT, cos_theta=None)

    def replace(self, **changes) -> "SearchSpec":
        """Functional update (sugar for ``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)


def resolve_search_spec(spec: Optional["SearchSpec"],
                        default: "SearchSpec", owner: str) -> "SearchSpec":
    """Validate a per-call ``spec`` (or fall back to ``default``).

    Anything that is not a ``SearchSpec`` (or ``None``) raises
    ``TypeError`` — there is no kwarg fallback.
    """
    if spec is None:
        return default
    if not isinstance(spec, SearchSpec):
        raise TypeError(f"{owner}: spec must be a SearchSpec, "
                        f"got {type(spec).__name__}")
    return spec


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the per-query [B] counters of SearchStats, in summary() order
_COUNTERS = ("dist_calls", "est_calls", "rerank_calls", "sq8_calls", "hops")


@dataclasses.dataclass
class SearchStats:
    """Typed per-search statistics: per-query ``[B]`` int arrays plus the
    batch-level hop-loop iteration count.  ``extra`` holds per-router
    ``[B]`` counters in registry-declared order
    (``Router.extra_counters``, e.g. the finger router's
    ``finger_est_calls``)."""

    dist_calls: np.ndarray       # exact fp32 distance evaluations
    est_calls: np.ndarray        # router estimate evaluations
    rerank_calls: np.ndarray     # stage-2 exact reranks (sq8 path)
    sq8_calls: np.ndarray        # stage-1 quantized estimates
    hops: np.ndarray             # node expansions
    iters: int                   # batch-level hop-loop iterations
    router: str = "none"
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_result(cls, res, router: str = "none") -> "SearchStats":
        """Build from an engine ``SearchResult`` (device tensors -> host)."""
        return cls(dist_calls=_host(res.dist_calls),
                   est_calls=_host(res.est_calls),
                   rerank_calls=_host(res.rerank_calls),
                   sq8_calls=_host(res.sq8_calls), hops=_host(res.hops),
                   iters=int(res.iters), router=router,
                   extra={k: _host(v) for k, v in res.extra.items()})

    @classmethod
    def merge(cls, stats_list) -> "SearchStats":
        """Fold stats from many dispatches into one record: per-query
        counters (router extras included) concatenate, ``iters`` is the
        max, ``router`` must agree."""
        stats_list = list(stats_list)
        if not stats_list:
            raise ValueError("SearchStats.merge: empty stats list")
        routers = {s.router for s in stats_list}
        if len(routers) > 1:
            raise ValueError(f"SearchStats.merge: mixed routers {routers}")
        keys = set().union(*(s.extra for s in stats_list))
        return cls(
            **{f: np.concatenate([getattr(s, f) for s in stats_list])
               for f in _COUNTERS},
            iters=max(int(s.iters) for s in stats_list),
            router=stats_list[0].router,
            extra={k: np.concatenate([s.extra[k] for s in stats_list
                                      if k in s.extra])
                   for k in sorted(keys)})

    def summary(self) -> dict:
        """JSON-ready digest (per-query means)."""
        out = {"router": self.router, "iters": int(self.iters)}
        for f in _COUNTERS:
            out[f] = round(float(np.mean(getattr(self, f))), 1)
        for k, v in self.extra.items():
            out[k] = round(float(np.mean(v)), 1)
        return out
