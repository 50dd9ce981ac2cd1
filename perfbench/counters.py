"""The program's own counters (``repro_torch.trace``) in the run's process,
for the metrics that read them.  A program without that module gives
nothing to read: each function then returns None."""
from __future__ import annotations

import importlib
import importlib.util


def _trace():
    if importlib.util.find_spec("repro_torch.trace") is None:
        return None
    return importlib.import_module("repro_torch.trace")


def total(name: str):
    """The named total (``trace.totals()``), or None where nothing added
    to it."""
    t = _trace()
    return None if t is None else t.totals().get(name)


def host_paced_calls():
    """The search engine calls that ran at the host's own pace, as
    ``device_idle_pct`` reads the window: none under a profiler, none that
    was a first use (a new shape, a kernel library loaded), and none that
    ended after the first profiled call began, since a profiler's tracer,
    once started, slows every later launch of the process."""
    t = _trace()
    if t is None:
        return None
    calls = t.calls()
    first = min((c.start_ns for c in calls if c.profiled), default=None)
    return [c for c in calls if not c.profiled and not c.first_use
            and (first is None or c.end_ns <= first)]
