"""One run of one cell: set-up, the window, the check, the result.

In order: the cell's vectors on the device from the seed (``data.py``);
the index through ``repro_torch`` (``AnnIndex.build`` under the
configuration's metric, then ``sample_angle_profile`` on the benchmark's
profile queries, taken from the rows the program holds: under ``cosine``
normalised); the search
engine held as a serving session holds it (``build_search_fn``); the
mix's loop warms the shapes it will send (``warm``); then it drives the
window for the window's seconds (``run``).  A loop sends requests through
a ``Window``: ``search(rows)`` calls ``AnnIndex.search_on`` on those rows
of the query set and records the answers; a loop that reaches the program
another way (a serving frontend) is given the index, the engine and the
spec, and records what it got back with ``record``.  After the window the
peak memory is read, the program's state is let go, and the reference
works out the exact top-k, the recall and the comparison (``check.py``)
from the recorded answers.
"""
from __future__ import annotations

import gc
import resource
import time
from typing import Callable, List

import numpy as np
import torch

from perfbench import check, data, tracing
from perfbench import reference as R
from perfbench.bench import Cell, read_metrics
from repro_torch.core.angles import sample_angle_profile
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec

TRACED_BATCHES = 2


class Window:
    """What a loop drives, and what the window recorded.

    A loop reads ``mix`` (its traffic file), ``seconds``, ``trace`` and
    ``queries`` (the query set in the run's order, [n_query, dim] float32
    on the host), and may reach the program through ``index``, ``engine``
    and ``spec``.  ``profile(run)`` traces ``run()`` once, in the window.
    """

    def __init__(self, cell: Cell, index: AnnIndex, engine, spec: SearchSpec,
                 queries: np.ndarray, seconds: float, trace: bool,
                 spans: tracing.Spans):
        self.mix, self.index, self.engine, self.spec = (cell.mix, index,
                                                        engine, spec)
        self.queries, self.n_query = queries, len(queries)
        self.seconds, self.trace = seconds, trace
        self.traced_batches = TRACED_BATCHES
        self.spans = spans
        self.recording = False
        self.requests: List[check.Request] = []
        self.iters: List[int] = []    # hop-loop iterations of each call
        self.ends: List[float] = []   # each call's end, host clock
        self.traced = None            # (first, end) request and call indices
        self.summary = None           # the traced sub-window's summary
        self.before = None            # (clock, queries) as profiling began

    def search(self, rows):
        """``AnnIndex.search_on`` on these rows of the query set; the
        answers are recorded."""
        rows = np.asarray(rows, np.int64)
        with self.spans("search_on", sync=False):
            ids, dists, stats = self.index.search_on(
                self.engine, self.queries[rows], self.spec)
        self.record(rows, ids, dists, stats)
        return ids, dists, stats

    def record(self, rows, ids, dists, stats) -> None:
        """The answers to one request: ``ids``/``dists`` [b, k] and the
        ``SearchStats`` of the call that answered it."""
        if not self.recording:
            return
        self.requests.append(check.Request(
            np.asarray(rows, np.int64), ids, dists,
            {c: np.asarray(getattr(stats, c)) for c in R.COUNTERS}))
        self.iters.append(int(stats.iters))
        self.ends.append(time.perf_counter())

    def profile(self, run: Callable[[], object]):
        """Trace ``run()`` twice: under a trace of the device alone (busy
        time, kernels, device operations), then under a trace of the host
        and the device (what the host did in each idle gap)."""
        if self.summary is not None:
            raise RuntimeError("a window is traced once")
        r0, c0 = len(self.requests), len(self.iters)
        self.before = (time.perf_counter(),
                       sum(len(r.rows) for r in self.requests))
        out, self.summary = tracing.profile_window(run, self.spans,
                                                   host=False)
        self.traced = (r0, len(self.requests), c0, len(self.iters))
        _, host = tracing.profile_window(run, self.spans, host=True)
        self.summary.update(idle_gaps=host["idle_gaps"],
                            host_traced_window_s=host["window_s"])
        return out


def _totals(requests) -> dict:
    return {c: int(sum(int(np.sum(r.counters[c])) for r in requests))
            for c in R.COUNTERS}


def _rusage() -> tuple:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime, r.ru_nvcsw, r.ru_nivcsw


def _host_load(before: tuple, after: tuple, wall: float) -> dict:
    """The process's CPU time over the window as a share of its wall time
    (user, system), and its context switches (voluntary, involuntary):
    what the host gave the loop that dispatches to the device."""
    d = [b - a for a, b in zip(before, after)]
    return {"user_share": d[0] / wall, "system_share": d[1] / wall,
            "switches": d[2], "involuntary_switches": d[3]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float):
    """The result of one run (the result line's object); ``t_start`` is
    when the process started, by ``time.perf_counter``."""
    cfg = cell.config
    check.judgeable(cfg)
    spans = tracing.Spans(device)
    with spans("data"):
        inputs = data.make_inputs(cfg, seed, device)
        base = inputs.base.cpu().numpy()
        queries = inputs.queries.cpu().numpy()
        prof_rows = inputs.profile_rows.cpu().numpy()
    graph = cfg["graph"]
    with spans("build"):
        idx = AnnIndex.build(base, graph=graph["kind"], k=graph["k"],
                             metric=cfg["metric"], profile=False,
                             device=device)
    with spans("profile"):
        idx.profile = sample_angle_profile(
            idx.graph, efs=cfg["profile"]["efs"],
            percentile=cfg["profile"]["percentile"],
            queries=idx.graph.vectors[prof_rows])
    spec = SearchSpec(**cfg["search"])
    with spans("engine"):
        _, fn = build_search_fn(idx.graph, idx.engine_spec(spec),
                                device=device)
    win = Window(cell, idx, fn, spec, queries, seconds, trace, spans)
    with spans("warmup"):
        cell.loop.warm(win)
    setup_s = time.perf_counter() - t_start
    win.recording = True
    use0, t0 = _rusage(), time.perf_counter()
    cell.loop.run(win)
    window_s = time.perf_counter() - t0
    host = _host_load(use0, _rusage(), window_s)
    if trace and win.summary is None:
        raise RuntimeError(f"the loop {cell.mix['loop']!r} traced no "
                           "sub-window")
    if not win.requests:
        raise RuntimeError(f"the loop {cell.mix['loop']!r} sent nothing")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    requests, iters = win.requests, win.iters
    n = len(base)
    ans = check.answers(requests, len(queries), n)
    side = check.Side(nbrs=idx.graph.neighbors, edges=idx.graph.edge_eu_dist,
                      angles=np.asarray(idx.profile.samples), answers=ans)
    theta_program = float(idx.profile.theta_star)
    summary, traced = win.summary, win.traced
    queries_answered = sum(len(r.rows) for r in requests)
    # the window at the host's own pace: up to the first profiler, whose
    # tracer, once started, slows every launch of the process
    t1, q1 = win.before or (t0 + window_s, queries_answered)
    ends = np.diff(np.asarray(win.ends) - t0, prepend=0.0)
    del idx, fn, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    gt, _ = R.nearest(inputs.base, inputs.queries[torch.as_tensor(
        ans.rows, device=inputs.base.device)], cfg["search"]["k"], "fp64",
        cfg["metric"])
    correct, checks, info = check.judge(inputs, side, cfg, seed)
    reference_s = time.perf_counter() - t_ref
    record = {
        "config": cfg, "cell": cell.name, "setup_s": setup_s,
        "spans": dict(spans.seconds),
        "window": {"seconds": window_s, "calls": len(iters),
                   "queries": queries_answered, "iters": iters,
                   **_totals(requests)},
        "untraced": {"seconds": t1 - t0, "queries": q1},
        "recall_at_10": check.recall(ans.ids, gt.cpu().numpy(), ans.times),
        "trace": None}
    result = {"correct": bool(correct),
              "attempted": queries_answered,
              "failed": int(ans.differ.sum() + ans.times[info["bad"]].sum())}
    dev_info = {"platform": "gpu" if device.type == "cuda" else
                device.type, "kind": _kind(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    if trace:
        r0, r1, c0, c1 = traced
        record["trace"] = {**summary, "calls": c1 - c0,
                           "queries": sum(len(r.rows)
                                          for r in requests[r0:r1]),
                           "iters": sum(iters[c0:c1]),
                           **_totals(requests[r0:r1])}
        result["metrics"] = read_metrics(cell.per_layer, record)
        dev_info.update(busy_s=summary["busy_s"],
                        window_s=summary["window_s"])
        result["device"] = dev_info
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    else:
        result["metrics"] = read_metrics(cell.end_to_end, record)
        result["device"] = dev_info
    result["info"] = {
        "theta_program": theta_program, "theta_reference": info["theta_ref"],
        "calls": len(iters), "iters": sorted(set(iters)),
        "reference_s": reference_s,
        "call_s": np.quantile(ends, [0, .25, .5, .75, 1]).tolist(),
        "spans_s": dict(spans.seconds), "host": host,
        "untraced": record["untraced"]}
    if trace:
        result["info"]["host_traced_window_s"] = \
            summary["host_traced_window_s"]
    result["checks"] = checks
    return result


def _kind(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)

