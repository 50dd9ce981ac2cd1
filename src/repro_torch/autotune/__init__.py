"""Autotune: an online SLO-driven controller over the serving knobs.

The counterpart of ``repro.autotune``, over the port's serving frontend.

Public surface::

    from repro_torch.autotune import AutotuneDriver, Objective, TuneSpace

    fe = ServeFrontend(index, spec)
    drv = AutotuneDriver.attach(fe, Objective(slo_p99_ms=250.0))
    with fe, drv:                    # serve + tune on background threads
        ... submit traffic ...
    print(drv.decision_log())        # structured, deterministic per seed

See DESIGN.md §12 (self-tuning serving) and the README Autotune section.
"""
from repro_torch.autotune.controller import Controller, Decision, Objective
from repro_torch.autotune.driver import AutotuneDriver
from repro_torch.autotune.proxy import ProbeMeasurement, RecallProxy
from repro_torch.autotune.space import Knob, TuneSpace, spec_key

__all__ = [
    "AutotuneDriver", "Controller", "Decision", "Objective",
    "Knob", "TuneSpace", "spec_key",
    "RecallProxy", "ProbeMeasurement",
]
