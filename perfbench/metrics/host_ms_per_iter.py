"""Host milliseconds a hop-loop iteration spent issuing work, not waiting:
the loop's host time less the time blocked in its one ``done.all()`` read
an iteration, summed over the calls at the host's own pace, over their
iterations (``repro_torch.trace``'s call log: ``dispatch_ns``,
``iters``)."""
from perfbench import counters


def read(record):
    calls = counters.host_paced_calls()
    iters = sum(c.iters for c in calls or ())
    if not iters:
        return None
    return sum(c.dispatch_ns for c in calls) / iters / 1e6
