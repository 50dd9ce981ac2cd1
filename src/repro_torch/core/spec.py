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

The fields split into two cost classes, and ``canonical()`` is the
authority on which is which (the autotune controller derives its knob cost
classes from it, ``repro_torch.autotune.space``): engine-shaping fields key
the engine cache, request-only fields (``k``/``cos_theta``) do not.
``KNOB_DOMAINS``, ``REQUEST_ONLY_FIELDS`` and ``STRUCTURAL_FIELDS`` put
every field in exactly one class.

``SearchStats`` carries per-query ``[B]`` arrays on the single-index path
and batch totals on the sharded path (``merge`` folds both kinds).
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

# Enumerable knob domains (the autotune search space,
# repro_torch.autotune.space).  The categorical fields enumerate exactly;
# the integer fields are open-ended, so these ladders are recommended
# discrete rungs, not validation, chosen to roughly double the engine's
# cost a step.  Router names live in the registry
# (repro_torch.core.routers.available_routers), not here.
EFS_LADDER = (32, 48, 64, 96, 128, 192)
BEAM_LADDER = (1, 2, 4, 8)
KNOB_DOMAINS: Dict[str, tuple] = {
    "efs": EFS_LADDER,
    "beam_width": BEAM_LADDER,
    "engine": ENGINES,
    "estimate": ESTIMATES,
    "beam_prune": BEAM_PRUNE_POLICIES,
}


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


def is_request_only(field: str) -> bool:
    """True iff changing ``field`` never shapes the engine.

    Derived from ``canonical()`` itself, not from a parallel list that
    could drift: a field is request-only exactly when perturbing it leaves
    the canonical form (the engine cache key) unchanged.  The serving
    frontend and the autotune controller's knob cost classes rest on it.
    """
    base = SearchSpec()
    probe = {"k": base.k + 1, "cos_theta": 0.25,
             "efs": base.efs + 8, "beam_width": base.beam_width + 1,
             "max_hops": base.max_hops + 1, "engine": "torch",
             "estimate": "sq8", "beam_prune": "all", "router": "crouting",
             "metric": "ip", "use_hierarchy": not base.use_hierarchy}
    if field not in probe:
        raise KeyError(f"unknown SearchSpec field {field!r}")
    return base.replace(**{field: probe[field]}).canonical() == \
        base.canonical()


REQUEST_ONLY_FIELDS = ("k", "cos_theta")
assert all(is_request_only(f) for f in REQUEST_ONLY_FIELDS)

# Engine-shaping fields that are not autotune knobs: ``router`` names a
# registry entry the operator picks, ``metric``/``use_hierarchy`` are index
# properties the graph overwrites, and ``max_hops`` is a hard budget, not
# a quality/cost dial.  With KNOB_DOMAINS and REQUEST_ONLY_FIELDS this puts
# every SearchSpec field in exactly one cost class.
STRUCTURAL_FIELDS = ("router", "metric", "max_hops", "use_hierarchy")
assert not (set(STRUCTURAL_FIELDS) & set(KNOB_DOMAINS)
            | set(STRUCTURAL_FIELDS) & set(REQUEST_ONLY_FIELDS))


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
# the hop loop's lane counters, which the sharded path leaves 0 and
# summary() leaves out (it is the JAX package's digest)
_LANE_COUNTERS = ("pruned", "first_stage")


@dataclasses.dataclass
class SearchStats:
    """Typed search statistics.  On the single-index path the counters are
    per-query ``[B]`` int arrays; on the sharded path they are batch totals
    reduced over the shards (``iters`` the maximum over shards, the
    straggler's count).  ``extra`` holds per-router counters in
    registry-declared order (``Router.extra_counters``, e.g. the finger
    router's ``finger_est_calls``).  ``pruned`` and ``first_stage`` are
    the single-index path's alone: the sharded path leaves them 0."""

    dist_calls: np.ndarray       # exact fp32 distance evaluations
    est_calls: np.ndarray        # router estimate evaluations
    rerank_calls: np.ndarray     # stage-2 exact reranks (sq8 path)
    sq8_calls: np.ndarray        # stage-1 quantized estimates
    hops: np.ndarray             # node expansions
    iters: int                   # batch-level hop-loop iterations
    router: str = "none"
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # graceful degradation: a host-composed sharded search that lost
    # shards still resolves, with the survivors' pool and these fields set
    shards_failed: int = 0
    degraded: bool = False
    # lanes the router pruned, and the hop loop's lanes that took a
    # first-stage distance (exact fp32, or SQ8's stage 1)
    pruned: np.ndarray = 0
    first_stage: np.ndarray = 0

    @classmethod
    def from_result(cls, res, router: str = "none") -> "SearchStats":
        """Build from an engine ``SearchResult``: its ``[B]`` counters come
        to the host in one copy."""
        names = _COUNTERS + _LANE_COUNTERS
        host = _host(torch.stack([getattr(res, f) for f in names]
                                 + list(res.extra.values())))
        return cls(**dict(zip(names, host)), iters=int(res.iters),
                   router=router,
                   extra=dict(zip(res.extra, host[len(names):])))

    def rows(self, lo: int, hi: int) -> "SearchStats":
        """The per-query counters of queries ``lo:hi``."""
        s = slice(lo, hi)
        return dataclasses.replace(
            self, **{f: getattr(self, f)[s]
                     for f in _COUNTERS + _LANE_COUNTERS},
            extra={k: v[s] for k, v in self.extra.items()})

    @classmethod
    def merge(cls, stats_list) -> "SearchStats":
        """Fold stats from many dispatches into one record: per-query
        array counters (router extras included) concatenate, scalar totals
        (the sharded path's) add, ``iters`` is the max, ``shards_failed``
        adds, ``degraded`` ORs, ``router`` must agree."""
        stats_list = list(stats_list)
        if not stats_list:
            raise ValueError("SearchStats.merge: empty stats list")
        routers = {s.router for s in stats_list}
        if len(routers) > 1:
            raise ValueError(f"SearchStats.merge: mixed routers {routers}")

        def comb(vals):
            if all(np.ndim(v) > 0 for v in vals):
                return np.concatenate([np.asarray(v) for v in vals])
            return sum(int(np.sum(v)) for v in vals)

        keys = set().union(*(s.extra for s in stats_list))
        return cls(
            **{f: comb([getattr(s, f) for s in stats_list])
               for f in _COUNTERS + _LANE_COUNTERS},
            iters=max(int(s.iters) for s in stats_list),
            router=stats_list[0].router,
            extra={k: comb([s.extra[k] for s in stats_list if k in s.extra])
                   for k in sorted(keys)},
            shards_failed=sum(int(s.shards_failed) for s in stats_list),
            degraded=any(s.degraded for s in stats_list))

    def summary(self) -> dict:
        """JSON-ready digest (per-query means)."""
        out = {"router": self.router, "iters": int(self.iters)}
        for f in _COUNTERS:
            out[f] = round(float(np.mean(getattr(self, f))), 1)
        for k, v in self.extra.items():
            out[k] = round(float(np.mean(v)), 1)
        out["shards_failed"] = int(self.shards_failed)
        out["degraded"] = bool(self.degraded)
        return out
