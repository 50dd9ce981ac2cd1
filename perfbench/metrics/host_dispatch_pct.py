"""Share of the hop loop's host time spent issuing work, in percent: the
dispatch time over dispatch and sync (the time blocked in the loop's
``done.all()`` reads), over the calls at the host's own pace
(``repro_torch.trace``'s call log).  Near 100, the host sets the pace; a
loop that issues its work faster, or a device that takes longer, lowers
it."""
from perfbench import counters


def read(record):
    calls = counters.host_paced_calls()
    host = sum(c.dispatch_ns + c.sync_ns for c in calls or ())
    if not host:
        return None
    return 100.0 * sum(c.dispatch_ns for c in calls) / host
