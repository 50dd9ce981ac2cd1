"""Milliseconds in which an operation ran on the device, a batch (a call
of the search): the traced sub-window's device busy time (a trace of the
device alone) over its calls.  It repeats where the host's dispatch does
not, so device-side work stays judgeable under a noisy rate."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0 or not t["calls"]:
        return None
    return 1e3 * t["busy_s"] / t["calls"]
