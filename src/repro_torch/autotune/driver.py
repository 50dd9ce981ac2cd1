"""AutotuneDriver: the loop that closes serving telemetry onto knobs.

The counterpart of ``repro.autotune.driver``, on the port's frontend.

``AutotuneDriver.attach(frontend, slo)`` binds a ``Controller`` +
``RecallProxy`` to a live ``ServeFrontend``:

* each ``step()`` snapshots the frontend's windowed telemetry, diffs it
  against the previous epoch (``ServeTelemetry.window_delta``), feeds the
  delta to the controller, and — when the controller moved the incumbent
  — promotes the new spec via ``ServeFrontend.activate_spec`` (pre-warm
  every bucket rung off the request path, then the atomic default-session
  flip; ``recompiles_after_warmup`` stays 0 across every switch);
* ``start()``/``stop()`` run ``step()`` on a daemon thread at a fixed
  period — the online mode ``repro_torch.launch.serve --autotune`` uses; tests and
  benchmarks drive ``step()`` synchronously;
* every action lands in the structured decision log
  (``driver.decisions``, JSON-ready via ``decision_log()``).

Fail-open is the driver's contract, not an afterthought: ANY exception
inside a step — controller logic, a probe replay, the failpoint sites
``autotune.step``/``autotune.probe``, even a failed pre-warm — is caught,
recorded as a ``kind="fail"`` decision, and leaves the frontend serving
the last-good spec.  The tuner can only ever decline to improve things;
it cannot take serving down.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.autotune.controller import Controller, Decision, Objective
from repro_torch.autotune.proxy import RecallProxy
from repro_torch.autotune.space import TuneSpace, spec_key
from repro_torch.core.spec import SearchSpec
from repro_torch.fault import failpoints as fault


class AutotuneDriver:
    """Owns the controller thread + the frontend binding (see module doc)."""

    def __init__(self, frontend, controller: Controller, proxy: RecallProxy):
        self.frontend = frontend
        self.controller = controller
        self.proxy = proxy
        self.failures = 0
        self.switches = 0
        self.last_error: Optional[str] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # previous epoch's snapshot -- guarded by: self._lock
        self._snap = None
        self._lock = threading.Lock()          # serializes step()
        frontend.autotune = self               # health() surface

    # --- construction -----------------------------------------------------
    @classmethod
    def attach(cls, frontend, slo: Union[Objective, float], *,
               space: Optional[TuneSpace] = None,
               proxy: Optional[RecallProxy] = None,
               probe_queries: Optional[np.ndarray] = None,
               probe_gt: Optional[np.ndarray] = None,
               n_probe: int = 32, seed: int = 0,
               screen: bool = True, **controller_kw) -> "AutotuneDriver":
        """Bind an autotune loop to a frontend.

        ``slo`` is an ``Objective`` or a bare p99 target in ms.  ``space``
        defaults to the stock efs x beam ladder around the frontend's
        active spec; ``proxy`` (or explicit probe queries/gt) defaults to
        synthesized probes with attach-time exact ground truth.  With
        ``screen=True`` the successive-halving bracket runs immediately —
        attach returns with an incumbent installed and active.
        """
        objective = (slo if isinstance(slo, Objective)
                     else Objective(slo_p99_ms=float(slo)))
        base = frontend.active_spec
        if space is None:
            space = TuneSpace.default(base)
        if proxy is None:
            proxy = RecallProxy.for_index(
                frontend.index, n_probe=n_probe, k=base.k, seed=seed,
                buckets=frontend.buckets, queries=probe_queries,
                gt=probe_gt)
        controller = Controller(space, objective, proxy.evaluate,
                                seed=seed, **controller_kw)
        drv = cls(frontend, controller, proxy)
        if screen:
            drv.step()
        return drv

    # --- the loop body ----------------------------------------------------
    def step(self) -> Decision:
        """One epoch: observe -> decide -> (maybe) pre-warm and switch.

        Never raises.  A failure inside the epoch is contained: the
        decision log records ``kind="fail"``, counters tick, and the
        frontend keeps serving the spec it already had (fail-open).
        """
        with self._lock:
            ctl = self.controller
            active_before = spec_key(self.frontend.active_spec)
            try:
                fault.hit("autotune.step")
                if ctl.incumbent is None:
                    decision = ctl.screen()
                    # baseline the epoch window so the FIRST refinement
                    # step diffs against end-of-screen, not attach time
                    self._snap = self.frontend.telemetry.window_snapshot()
                else:
                    snap = self.frontend.telemetry.window_snapshot()
                    delta = (self.frontend.telemetry.window_delta(
                        self._snap, snap) if self._snap is not None
                        else {"p99_ms": None, "served": 0})
                    self._snap = snap
                    decision = ctl.step(delta)
                if ctl.incumbent is not None and \
                        ctl.incumbent != active_before:
                    self._promote(ctl.by_key[ctl.incumbent])
                    # the switch resets the epoch window: post-switch
                    # latency must not be judged against pre-switch samples
                    self._snap = self.frontend.telemetry.window_snapshot()
                return decision
            except Exception as e:              # noqa: BLE001 — fail-open:
                # any controller/probe/warmup error leaves the last-good
                # spec serving; the failure is data in the decision log.
                # Re-point the controller at what is ACTUALLY active (a
                # failed pre-warm must not leave it believing its own
                # un-promoted switch), when that spec is in its space.
                if active_before in ctl.by_key:
                    ctl.incumbent = active_before
                self.failures += 1
                self.last_error = repr(e)
                d = Decision(ctl.epoch, "fail", active_before,
                             f"controller error (fail-open): {e!r}", {})
                ctl.decisions.append(d)
                return d

    def _promote(self, spec: SearchSpec) -> None:
        """Pre-warm across the bucket ladder, then the atomic flip."""
        t0 = time.perf_counter()
        self.frontend.activate_spec(spec)
        self.switches += 1
        self.controller.decisions[-1].measured["warm_swap_s"] = round(
            time.perf_counter() - t0, 3)

    # --- background mode --------------------------------------------------
    def start(self, period_s: float = 2.0) -> "AutotuneDriver":
        """Run ``step()`` every ``period_s`` on a daemon thread."""
        if self._worker is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(timeout=period_s):
                self.step()

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="autotune-driver")
        self._worker.start()
        return self

    def stop(self) -> None:
        if self._worker is None:
            return
        self._stop.set()
        self._worker.join()
        self._worker = None

    def __enter__(self) -> "AutotuneDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- reporting --------------------------------------------------------
    @property
    def decisions(self) -> List[Decision]:
        return self.controller.decisions

    def decision_log(self) -> List[Dict[str, object]]:
        """The structured decision log, JSON-ready."""
        return [d.to_dict() for d in self.controller.decisions]

    def health(self) -> Dict[str, object]:
        """Controller state for ``ServeFrontend.health()['autotune']``."""
        h = self.controller.health()
        h.update({
            "running": self._worker is not None and self._worker.is_alive(),
            "failures": self.failures,
            "switches": self.switches,
            "last_error": self.last_error,
            "objective": self.controller.objective.to_dict(),
        })
        return h
