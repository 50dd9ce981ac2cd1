"""The harness's spans and its profiler window.

``Spans`` times the harness's own calls into each layer on the host clock
(synchronised where the call ends on the device); inside a profiler window
each span is also a ``record_function`` range, so the trace can say what
the host was doing while the device idled.

``profile_window`` is ``chip_smoke.py``'s ``profile_batch`` window: a
``torch.profiler`` trace, padded at both ends with launches of torch's
one-thread spin kernel (late in a long process the trace loses a fixed
number of activity records a window, and these are what it loses instead
of the measured launches), which are left out.  It traces the device
alone, or the host and the device.  Tracing the host's operations slows
a host-bound loop one and a half to two times, so the device's busy and
idle time come from a trace of the device alone; the host's trace only
names what the host was doing in each idle gap.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

PAD_LAUNCHES = 64
PAD_KERNEL = "spin_kernel"
WINDOW = "perfbench.traced"


class Spans:
    """Named host-clock spans; ``seconds[name]`` sums a name's spans."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = defaultdict(float)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = True):
        rf = (torch.profiler.record_function(name) if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.seconds[name] += time.perf_counter() - t0


def _pad(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _activities(host: bool):
    from torch.profiler import ProfilerActivity
    return ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]


def profile_window(run: Callable[[], object], spans: Spans, host: bool):
    """Trace ``run()``, of the device alone or (``host``) of the host and
    the device; returns its result and ``summarize``'s record."""
    from torch.profiler import profile
    spans.traced = host
    try:
        with profile(activities=_activities(host)) as prof:
            _pad(PAD_LAUNCHES)
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                out = run()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _pad(PAD_LAUNCHES)
    finally:
        spans.traced = False
    return out, summarize(prof.events(), wall)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events, wall_s: float, spans=frozenset(("search_on",)),
              top: int = 10) -> dict:
    """Device busy time, kernel count and the idle gaps of a trace.

    ``busy_s``: the union of the device operations' intervals (kernels,
    copies, fills) inside the window (between the spin paddings, in a trace
    of the device alone), the padding left out; ``window_s``: the window's
    host wall time.  In a trace of the host too, each idle gap between
    device operations is named by the harness span open at its midpoint
    and the host operation directly under it (``python`` between
    operations; ``harness`` outside every span), and summed by name.
    """
    dev_iv, by_kernel = [], defaultdict(float)
    kernels = 0
    host, open_spans, win = [], [], None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if "CUDA" in str(e.device_type):
            # record_function ranges are mirrored on the device's timeline
            # as annotations; they are no device operation
            if (PAD_KERNEL in e.name or e.name == WINDOW or e.name in spans
                    or getattr(e, "is_user_annotation", False)):
                continue
            dev_iv.append((a, b))
            by_kernel[e.name[:120]] += (b - a) / 1e6
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif e.name == WINDOW:
            win = (a, b)
        elif e.name in spans:
            open_spans.append((a, b, e.name))
        elif e.cpu_parent is not None and e.cpu_parent.name in spans:
            host.append((a, b, f"{e.cpu_parent.name}/{e.name}"))
    if win is not None:
        dev_iv = [(max(a, win[0]), min(b, win[1])) for a, b in dev_iv
                  if b > win[0] and a < win[1]]
    busy = _union(dev_iv)
    if win is None:
        win = (busy[0][0], busy[-1][1]) if busy else (0.0, 0.0)
    gaps = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid) - 1
        if j >= 0 and host[j][1] >= mid:
            name = host[j][2]
        else:
            span = [s for s0, s1, s in open_spans if s0 <= mid <= s1]
            name = f"{span[0] if span else 'harness'}/python"
        gaps[name] += (b - a) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": wall_s,
            "kernels": kernels, "device_ops": ranked(by_kernel),
            "idle_gaps": ranked(gaps)}
