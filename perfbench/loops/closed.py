"""A closed loop with one caller: ``batch`` rows of the query set at a
time (``"all"``: the whole set), the next batch as soon as the last one's
answers are on the host, until the window's seconds have passed.  The
batches take the query set in the run's order (``--seed`` orders it),
from where the last one ended, wrapping round at its end.  The window ends
with the last batch, so a rate over it takes all the work and all the
time.  With tracing on, ``traced_batches`` batches from the middle of the
window run under each profiler.
"""
from __future__ import annotations

import time

import numpy as np


def _batches(ctx):
    b = ctx.mix["batch"]
    b = ctx.n_query if b == "all" else int(b)
    start = 0
    while True:
        yield (start + np.arange(b)) % ctx.n_query
        start = (start + b) % ctx.n_query


def warm(ctx) -> None:
    """The one shape the loop sends: a batch."""
    ctx.search(next(_batches(ctx)))


def run(ctx) -> None:
    batches = _batches(ctx)
    traced = not ctx.trace
    t0 = time.perf_counter()
    while True:
        if not traced and time.perf_counter() - t0 >= ctx.seconds / 2:
            ctx.profile(lambda: [ctx.search(next(batches))
                                 for _ in range(ctx.traced_batches)])
            traced = True
        else:
            ctx.search(next(batches))
        if time.perf_counter() - t0 >= ctx.seconds and traced:
            return
