"""The tunable search space: knobs, cost classes, candidate enumeration.

A copy of ``repro.autotune.space`` over the port's ``SearchSpec``.

A ``TuneSpace`` declares which ``SearchSpec`` fields the autotune
controller may move and over which discrete values.  Every knob carries a
*cost class*, derived from ``SearchSpec.canonical()`` semantics rather
than hand-maintained (``repro_torch.core.spec.is_request_only``):

* ``"request"`` — changing the knob leaves the canonical spec unchanged
  (``k``, ``cos_theta``): it retunes instantly, no new engine, no
  pre-warm (on a CUDA device a new ``cos_theta`` captures each bucket's
  hop graph once, on its first request);
* ``"engine"``  — changing the knob changes the canonical spec
  (``efs``, ``beam_width``, ``estimate``, ``router``, ...): a switch
  creates a new engine session whose every bucket rung MUST be pre-warmed
  off the request path before the atomic active-spec flip
  (``ServeFrontend.activate_spec``) — the zero-recompiles-after-warmup
  invariant survives every controller action.

Candidates are the cartesian product of the knob domains applied to a
base spec, enumerated in a deterministic order (knob declaration order,
then domain order) — the controller's seeded search is reproducible only
because the space underneath it is.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.spec import (BEAM_LADDER, EFS_LADDER, SearchSpec,
                                   is_request_only)

COST_CLASSES = ("request", "engine")


def spec_key(spec: SearchSpec) -> str:
    """Stable compact id for a candidate's *engine-shaping* identity (the
    decision log / quarantine key).  Request-only fields are excluded, so
    two candidates differing only in ``k``/``cos_theta`` share a key —
    exactly the specs that share an engine."""
    c = spec.canonical()
    return (f"efs={c.efs},W={c.beam_width},router={c.router},"
            f"estimate={c.estimate},engine={c.engine},prune={c.beam_prune}")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable ``SearchSpec`` field and its discrete domain."""

    name: str
    values: Tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        assert self.values, f"knob {self.name!r} has an empty domain"

    @property
    def cost(self) -> str:
        """``"request"`` or ``"engine"`` — from canonical() semantics."""
        return "request" if is_request_only(self.name) else "engine"


class TuneSpace:
    """A base spec plus the knobs the controller may move."""

    def __init__(self, base: SearchSpec, knobs: Sequence[Knob]):
        self.base = base
        self.knobs = tuple(knobs)
        names = [k.name for k in self.knobs]
        assert len(set(names)) == len(names), f"duplicate knobs: {names}"
        for k in self.knobs:
            k.cost  # validates the field name against SearchSpec

    @classmethod
    def default(cls, base: SearchSpec, *,
                efs: Optional[Sequence[int]] = None,
                beam_width: Optional[Sequence[int]] = None,
                estimate: Optional[Sequence[str]] = None,
                routers: Optional[Sequence[str]] = None) -> "TuneSpace":
        """The stock serving space: efs ladder x beam ladder (+ optional
        estimate mode / router sweeps).  ``efs`` rungs below the base
        ``k`` are dropped — they could not return ``k`` results."""
        knobs = [
            Knob("efs", tuple(v for v in (efs or EFS_LADDER)
                              if v >= base.k)),
            Knob("beam_width", tuple(beam_width or BEAM_LADDER)),
        ]
        if estimate:
            knobs.append(Knob("estimate", tuple(estimate)))
        if routers:
            knobs.append(Knob("router", tuple(routers)))
        return cls(base, knobs)

    def cost_class(self, field: str) -> str:
        """Cost class of one knob (see module docstring)."""
        return "request" if is_request_only(field) else "engine"

    @property
    def engine_knobs(self) -> Tuple[Knob, ...]:
        return tuple(k for k in self.knobs if k.cost == "engine")

    @property
    def request_knobs(self) -> Tuple[Knob, ...]:
        return tuple(k for k in self.knobs if k.cost == "request")

    def candidates(self) -> List[SearchSpec]:
        """Every candidate spec, in deterministic enumeration order
        (knob declaration order, then each knob's domain order)."""
        out: List[SearchSpec] = []
        seen: Dict[str, SearchSpec] = {}
        domains = [k.values for k in self.knobs]
        for combo in itertools.product(*domains):
            spec = self.base.replace(
                **{k.name: v for k, v in zip(self.knobs, combo)})
            if spec.efs < spec.k:
                continue
            key = spec_key(spec)
            if key in seen:       # request-only knobs collapse onto one
                continue          # engine identity; keep the first
            seen[key] = spec
            out.append(spec)
        assert out, "TuneSpace produced no valid candidates"
        return out

    def describe(self) -> Dict[str, Dict[str, object]]:
        """JSON-ready space declaration (persisted with bench results)."""
        return {k.name: {"values": list(k.values), "cost": k.cost}
                for k in self.knobs}
