"""Share of the window's wall time in which no operation ran on the
device, in percent, at the host's own pace: one less the device's busy
time a query (the profiler's trace of the device alone) times the queries
answered before the first profiler started, over the seconds before it.

A profiler's tracer, once started, slows every launch of the process (a
trace of the device alone too, one and a half to two times a batch of
this host-bound loop), so the busy share of the traced sub-window itself
(``device``'s ``busy_s`` over ``window_s``) reads the device idler than
it is untraced.  The device's work a query does not change under it."""


def read(record):
    t, u = record["trace"], record.get("untraced")
    if (not t or t["busy_s"] <= 0 or not t["queries"] or not u
            or u["seconds"] <= 0 or not u["queries"]):
        return None
    busy = t["busy_s"] / t["queries"] * u["queries"]
    return 100.0 * (1.0 - busy / u["seconds"])
