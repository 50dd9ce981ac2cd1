"""SLO-driven knob search: successive halving + epsilon-greedy refinement.

A copy of ``repro.autotune.controller`` (pure Python, framework-free).

The controller is deliberately *pure*: it owns no threads, reads no
clocks, and touches no frontend.  It consumes (a) probe measurements from
an injected ``probe_fn`` and (b) windowed telemetry deltas handed to
``step()`` by the driver, and emits typed ``Decision`` records.  All
randomness flows from one seeded PRNG, so the decision log is a
deterministic function of (observation sequence, seed) — the property the
regression tests replay twice and diff.

Objective (DESIGN.md §12): ``max_recall`` maximizes the recall proxy
subject to ``p99 <= slo_p99_ms``; ``min_p99`` minimizes predicted p99
subject to ``recall >= recall_floor``.

Search, not a grid sweep:

1. **Screening — successive halving.**  Every candidate gets a cheap
   probe replay; survivors of each rung (top ``1/eta`` by objective
   score) are re-probed with more replays until at most
   ``max_finalists`` remain.  Candidates whose *probe* latency alone
   blows the SLO are quarantined outright — a single dispatch with no
   queueing is a lower bound on served p99, so they cannot possibly
   comply (the ISSUE's "quarantine of candidate specs that blow the SLO
   during probing").
2. **Refinement — epsilon-greedy bandit.**  Each epoch consumes the
   serving window delta for the incumbent: an SLO violation triggers a
   step DOWN to the best predicted-feasible finalist; sustained headroom
   triggers a step UP to a higher-recall finalist; otherwise the epoch
   exploits (keep) or, with probability epsilon, explores by re-probing a
   seeded-random finalist so its measurement cannot go stale.

The latency model is the "model" in model-based: predicted served p99 of
a candidate = its probe latency x a calibration ratio (EMA of the
incumbent's measured p99 over its own probe latency).  Probe latency
orders candidates by engine cost; the ratio maps that ordering onto the
live workload's queueing regime — and re-calibrates each epoch, which is
what lets the controller chase a workload shift.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional

from repro_torch.autotune.proxy import ProbeMeasurement
from repro_torch.autotune.space import TuneSpace, spec_key
from repro_torch.core.spec import SearchSpec

MODES = ("max_recall", "min_p99")


@dataclasses.dataclass(frozen=True)
class Objective:
    """What "better" means, and the hard constraint.

    ``headroom`` is the fraction of the SLO the controller keeps in
    reserve when predicting feasibility (switch targets must project
    under ``slo * (1 - headroom)``); ``upgrade_margin`` is how far under
    the SLO the *measured* p99 must sit before an upgrade is considered
    (hysteresis — without it the controller oscillates at the boundary).
    """

    slo_p99_ms: float
    mode: str = "max_recall"
    recall_floor: float = 0.0
    headroom: float = 0.2
    upgrade_margin: float = 0.5

    def __post_init__(self):
        assert self.mode in MODES, f"unknown objective mode {self.mode!r}"
        assert self.slo_p99_ms > 0

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Decision:
    """One controller action, JSON-ready for the structured decision log."""

    epoch: int
    kind: str            # screen | keep | switch | probe | fail | idle
    key: Optional[str]   # active candidate key after the decision
    reason: str
    measured: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {"epoch": self.epoch, "kind": self.kind, "key": self.key,
                "reason": self.reason, "measured": self.measured}


class Controller:
    """Deterministic seeded search over a ``TuneSpace`` (see module doc)."""

    def __init__(self, space: TuneSpace, objective: Objective,
                 probe_fn: Callable[..., ProbeMeasurement], *,
                 seed: int = 0, eta: int = 2, screen_replays=(1, 2),
                 max_finalists: int = 4, epsilon: float = 0.1,
                 ratio_alpha: float = 0.5):
        self.space = space
        self.objective = objective
        self._probe = probe_fn
        self.rng = random.Random(seed)
        self.seed = seed
        self.eta = max(2, int(eta))
        self.screen_replays = tuple(screen_replays)
        self.max_finalists = max(1, int(max_finalists))
        self.epsilon = float(epsilon)
        self.ratio_alpha = float(ratio_alpha)

        self.candidates: List[SearchSpec] = space.candidates()
        self.by_key: Dict[str, SearchSpec] = {
            spec_key(c): c for c in self.candidates}
        self.measurements: Dict[str, ProbeMeasurement] = {}
        self.quarantined: Dict[str, str] = {}     # key -> reason
        self.finalists: List[str] = []
        self.incumbent: Optional[str] = None
        self.ratio: Optional[float] = None        # served p99 / probe lat
        self.epoch = 0
        self.decisions: List[Decision] = []

    # --- scoring ----------------------------------------------------------
    def predicted_p99_ms(self, key: str) -> float:
        """Latency model: probe latency x calibration ratio (>= 1)."""
        m = self.measurements[key]
        return m.lat_s * 1e3 * max(self.ratio if self.ratio else 1.0, 1.0)

    def _feasible(self, key: str) -> bool:
        o = self.objective
        if o.mode == "min_p99":
            return self.measurements[key].recall >= o.recall_floor
        return self.predicted_p99_ms(key) <= o.slo_p99_ms * (1 - o.headroom)

    def _score(self, key: str):
        """Sort key: larger is better, infeasible always below feasible."""
        m = self.measurements[key]
        if self.objective.mode == "min_p99":
            return (self._feasible(key), -self.predicted_p99_ms(key),
                    m.recall)
        return (self._feasible(key), m.recall, -m.lat_s)

    def _quarantine_check(self, key: str) -> bool:
        """Probe latency alone blows the SLO -> quarantine (True)."""
        lat_ms = self.measurements[key].lat_s * 1e3
        if lat_ms > self.objective.slo_p99_ms:
            self.quarantined[key] = (
                f"probe latency {lat_ms:.1f}ms > SLO "
                f"{self.objective.slo_p99_ms:.1f}ms")
            return True
        return False

    # --- phase 1: successive halving --------------------------------------
    def screen(self) -> Decision:
        """Probe-and-halve the full candidate set down to the finalists;
        install the best as incumbent.  One decision record carries every
        rung's survivors so the log replays the whole bracket."""
        self.epoch += 1
        alive = [spec_key(c) for c in self.candidates]
        rungs: List[Dict[str, object]] = []
        for r, replays in enumerate(self.screen_replays):
            survivors = []
            for key in alive:
                self.measurements[key] = self._probe(
                    self.by_key[key], replays=replays)
                if not self._quarantine_check(key):
                    survivors.append(key)
            survivors.sort(key=self._score, reverse=True)
            if r < len(self.screen_replays) - 1:
                keep = max(1, math.ceil(len(survivors) / self.eta))
                survivors = survivors[:keep]
            rungs.append({"replays": replays, "evaluated": len(alive),
                          "survivors": list(survivors)})
            alive = survivors
            if len(alive) <= self.max_finalists:
                break
        if not alive:
            # every candidate's probe blew the SLO: serve the least-bad one
            # rather than nothing (fail-open all the way down)
            alive = sorted(self.quarantined,
                           key=lambda k: self.measurements[k].lat_s)[:1]
        self.finalists = alive[:self.max_finalists]
        self.incumbent = self.finalists[0]
        d = Decision(
            epoch=self.epoch, kind="screen", key=self.incumbent,
            reason=(f"successive halving over {len(self.candidates)} "
                    f"candidates -> {len(self.finalists)} finalists"),
            measured={
                "rungs": rungs,
                "quarantined": dict(self.quarantined),
                "finalists": {k: self.measurements[k].to_dict()
                              for k in self.finalists},
            })
        self.decisions.append(d)
        return d

    # --- phase 2: epsilon-greedy refinement --------------------------------
    def step(self, delta: Dict[str, object]) -> Decision:
        """One decision epoch from a windowed telemetry delta.

        ``delta`` is ``ServeTelemetry.window_delta`` output for the period
        since the previous decision — measured behavior of the INCUMBENT
        under the live workload.
        """
        if self.incumbent is None:
            return self.screen()
        self.epoch += 1
        o = self.objective
        p99 = delta.get("p99_ms")
        served = int(delta.get("served") or 0)
        meas = {"p99_ms": p99, "served": served, "qps": delta.get("qps")}
        if p99 is None or served == 0:
            d = Decision(self.epoch, "idle", self.incumbent,
                         "no traffic in the window", meas)
            self.decisions.append(d)
            return d

        # re-calibrate the latency model against the live workload
        probe_ms = self.measurements[self.incumbent].lat_s * 1e3
        if probe_ms > 0:
            r = p99 / probe_ms
            self.ratio = (r if self.ratio is None else
                          (1 - self.ratio_alpha) * self.ratio
                          + self.ratio_alpha * r)
            meas["ratio"] = round(self.ratio, 3)

        if p99 > o.slo_p99_ms:
            return self._react_violation(p99, meas)

        recall_now = self.measurements[self.incumbent].recall
        if o.mode == "max_recall" and p99 <= o.slo_p99_ms * o.upgrade_margin:
            best = self._best_feasible(exclude=self.incumbent,
                                       min_recall=recall_now + 1e-9)
            if best is not None:
                self.incumbent = best
                d = Decision(
                    self.epoch, "switch", best,
                    f"headroom: p99 {p99:.1f}ms <= "
                    f"{o.upgrade_margin:.0%} of SLO; upgrading recall "
                    f"{recall_now:.3f} -> "
                    f"{self.measurements[best].recall:.3f}", meas)
                self.decisions.append(d)
                return d

        if self.rng.random() < self.epsilon:
            key = self._explore_pick()
            if key is not None:
                self.measurements[key] = self._probe(self.by_key[key],
                                                     replays=1)
                self._quarantine_check(key)
                meas["probed"] = self.measurements[key].to_dict()
                d = Decision(self.epoch, "probe", self.incumbent,
                             f"epsilon exploration re-probed {key}", meas)
                self.decisions.append(d)
                return d
        d = Decision(self.epoch, "keep", self.incumbent,
                     f"p99 {p99:.1f}ms within SLO {o.slo_p99_ms:.1f}ms",
                     meas)
        self.decisions.append(d)
        return d

    def _react_violation(self, p99: float, meas: Dict[str, object]
                         ) -> Decision:
        o = self.objective
        target = self._best_feasible(exclude=self.incumbent)
        if target is None:
            # nothing projects feasible: fall to the cheapest finalist
            others = [k for k in self.finalists
                      if k != self.incumbent and k not in self.quarantined]
            target = min(others, default=None,
                         key=lambda k: self.measurements[k].lat_s)
        if target is None or target == self.incumbent:
            d = Decision(self.epoch, "keep", self.incumbent,
                         f"SLO violated (p99 {p99:.1f}ms > "
                         f"{o.slo_p99_ms:.1f}ms) but no cheaper candidate "
                         "remains", meas)
            self.decisions.append(d)
            return d
        old = self.incumbent
        self.incumbent = target
        d = Decision(
            self.epoch, "switch", target,
            f"SLO violated: p99 {p99:.1f}ms > {o.slo_p99_ms:.1f}ms; "
            f"stepping {old} -> {target} "
            f"(predicted {self.predicted_p99_ms(target):.1f}ms)", meas)
        self.decisions.append(d)
        return d

    def _best_feasible(self, exclude: Optional[str] = None,
                       min_recall: float = -1.0) -> Optional[str]:
        """Highest-scoring finalist predicted to meet the constraint."""
        pool = [k for k in self.finalists
                if k != exclude and k not in self.quarantined
                and self._feasible(k)
                and self.measurements[k].recall >= min_recall]
        if not pool:
            return None
        return max(pool, key=self._score)

    def _explore_pick(self) -> Optional[str]:
        pool = [k for k in self.finalists if k != self.incumbent]
        return self.rng.choice(pool) if pool else None

    # --- reporting ---------------------------------------------------------
    def health(self) -> Dict[str, object]:
        last = self.decisions[-1].to_dict() if self.decisions else None
        return {
            "epoch": self.epoch,
            "incumbent": self.incumbent,
            "finalists": list(self.finalists),
            "quarantined": dict(self.quarantined),
            "ratio": round(self.ratio, 3) if self.ratio else None,
            "last_decision": last,
        }
