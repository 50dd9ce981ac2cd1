"""``repro_torch.trace``: spans and counters inside the port, on the CPU.

Spans are off by default; once enabled they nest as the search runs them
(``search`` > ``hop`` > ``hop.*``); under a torch profiler each phase is a
range directly under the caller's range, which is how the benchmark's
trace summary names an idle gap; the call log marks profiled calls and
first uses; and no setting of the tracer changes a result.
"""
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import tracing
from repro_torch import trace
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec

PHASES = ("hop.sync", "hop.beam", "hop.tile", "hop.route", "hop.dist",
          "hop.status", "hop.merge")
COUNTERS = ("dist_calls", "est_calls", "rerank_calls", "sq8_calls", "hops")


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((600, 16)).astype(np.float32)
    queries = rng.standard_normal((8, 16)).astype(np.float32)
    idx = AnnIndex.build(base, graph="knn", k=12, device="cpu")
    return idx, queries


def _spec(engine="fused", estimate="exact"):
    return SearchSpec(k=10, efs=32, router="crouting", beam_width=4,
                      engine=engine, estimate=estimate)


def _search(idx, queries, spec):
    _, fn = build_search_fn(idx.graph, idx.engine_spec(spec), device="cpu")
    return idx.search_on(fn, queries, spec)


def test_spans_are_off_by_default_and_record_nothing(data):
    idx, q = data
    assert trace.span("a") is trace.span("b")
    assert trace.phases() is trace.phases()
    _search(idx, q, _spec())
    assert trace.drain() == []


def test_enabled_spans_nest_as_the_search_runs_them(data):
    idx, q = data
    _search(idx, q, _spec())                  # the engine's first use
    trace.enable()
    _, _, stats = _search(idx, q, _spec())
    _search(idx, q, _spec())
    trace.disable()
    spans = trace.drain()
    assert trace.drain() == []
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns and isinstance(s.request, int)
    roots = [s for s in spans if s.name == "search"]
    assert len(roots) == 2 and roots[0].request != roots[1].request
    assert all(s.parent is None for s in roots)
    assert [c.request for c in trace.calls()][-2:] == \
        [r.request for r in roots]
    for s in spans:
        if s.name.startswith("hop."):
            parent = by_id[s.parent]
            assert parent.name == "hop" and parent.request == s.request
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        elif s.name in ("hop", "search.init", "search.final"):
            root = by_id[s.parent]
            assert root.name == "search" and root.request == s.request
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        elif s.name == "search.to_host":
            # after the engine call, in the caller: that call's request
            assert s.parent is None
            root = next(r for r in roots if r.request == s.request)
            assert s.start_ns >= root.end_ns
    names = Counter(s.name for s in roots[:1] + [
        s for s in spans if s.request == roots[0].request])
    iters = stats.iters
    # one hop.sync an iteration and the read that ends the loop
    assert names["hop"] == names["hop.sync"] == iters + 1
    for p in PHASES[1:]:
        assert names[p] == iters
    assert names["search.final"] == 1 and names["search.to_host"] == 1
    assert names["search.init"] == 2        # the engine's upload, the loop's


def test_a_span_closes_what_an_exception_left_open():
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("outer", leaf=False):
            ph = trace.phases()
            ph.hop()
            ph.to("hop.beam")
            raise ValueError("inside a phase")
    assert trace._LOCAL.open == []
    spans = {s.name: s for s in trace.drain()}
    assert set(spans) == {"outer", "hop", "hop.beam"}
    assert spans["hop.beam"].parent == spans["hop"].id
    assert spans["hop"].parent == spans["outer"].id
    assert spans["hop.beam"].end_ns <= spans["outer"].end_ns


def _cpu_profile(idx, q, spec):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("search_on"):
            out = _search(idx, q, spec)
    return out, prof.events()


def test_phases_are_ranges_directly_under_the_callers_range(data):
    idx, q = data
    _search(idx, q, _spec())
    _, events = _cpu_profile(idx, q, _spec())
    ours = [e for e in events if e.name.startswith(("hop", "search"))
            and e.name != "search_on"]
    names = Counter(e.name for e in ours)
    # the call and iteration spans open no range
    assert "hop" not in names and "search" not in names
    assert set(names) == set(PHASES) | {"search.init", "search.final",
                                        "search.to_host"}
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "search_on"
               for e in ours)
    # the trace summary names an idle gap inside a phase by that phase
    dist = next(e for e in ours if e.name == "hop.dist")
    a, b = dist.time_range.start, dist.time_range.end
    lo, hi = a + (b - a) / 4, b - (b - a) / 4
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)

    def dev(x, y):
        return SimpleNamespace(name="k", time_range=SimpleNamespace(
            start=x, end=y), device_type="DeviceType.CUDA", cpu_parent=None)
    win = SimpleNamespace(name=tracing.WINDOW, time_range=SimpleNamespace(
        start=start, end=end), device_type="DeviceType.CPU", cpu_parent=None)
    s = tracing.summarize(list(events) + [win, dev(start, lo), dev(hi, end)],
                          (end - start) / 1e6)
    assert s["idle_gaps"] == [["search_on/hop.dist",
                               pytest.approx((hi - lo) / 1e6)]]


def test_the_call_log_marks_profiled_calls_and_first_uses(data):
    idx, q = data
    spec = SearchSpec(k=10, efs=24, router="crouting", beam_width=2)
    _search(idx, q, spec)
    _search(idx, q, spec)
    _cpu_profile(idx, q, spec)
    _, _, stats = _search(idx, q[:3], spec)
    calls = trace.calls()
    assert [c.first_use for c in calls] == [True, False, False, True]
    assert [c.profiled for c in calls] == [False, False, True, False]
    assert [c.rows for c in calls] == [8, 8, 8, 3]
    assert calls[-1].iters == stats.iters > 0
    reqs = [c.request for c in calls]
    assert reqs == sorted(set(reqs))
    for c in calls:
        assert c.start_ns < c.end_ns
        assert c.dispatch_ns > 0 and c.sync_ns > 0
        assert c.dispatch_ns + c.sync_ns <= c.end_ns - c.start_ns
    for a, b in zip(calls, calls[1:]):
        assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("engine", ["torch", "fused", "unfused"])
@pytest.mark.parametrize("estimate", ["exact", "both"])
def test_results_are_bit_identical_off_on_and_under_a_profiler(
        data, engine, estimate):
    idx, q = data
    spec = _spec(engine, estimate)
    off = _search(idx, q, spec)
    trace.enable()
    on = _search(idx, q, spec)
    trace.disable()
    assert trace.drain()
    prof, _ = _cpu_profile(idx, q, spec)
    for other in (on, prof):
        np.testing.assert_array_equal(other[0], off[0])
        np.testing.assert_array_equal(other[1], off[1])
        for c in COUNTERS:
            np.testing.assert_array_equal(getattr(other[2], c),
                                          getattr(off[2], c))
        assert other[2].iters == off[2].iters
        assert other[2].extra.keys() == off[2].extra.keys()
    assert off[2].iters > 0 and off[2].dist_calls.sum() > 0
    if estimate == "both":
        assert off[2].sq8_calls.sum() > 0


def test_a_tiny_build_fills_the_knn_and_sq8_counters():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((700, 12)).astype(np.float32)
    idx = AnnIndex.build(base, graph="knn", k=10, profile=False,
                         device="cpu", block=256)
    t = trace.totals()
    assert t["knn.product_s"] > 0 and t["knn.select_s"] > 0
    assert "engine.sq8_s" not in t
    spec = SearchSpec(k=10, efs=24, router="crouting", cos_theta=0.3,
                      estimate="both")
    build_search_fn(idx.graph, idx.engine_spec(spec), device="cpu")
    sq8 = trace.totals()["engine.sq8_s"]
    assert sq8 > 0
    # the codes are made once a graph: a second SQ8 spec adds nothing
    build_search_fn(idx.graph, idx.engine_spec(
        SearchSpec(k=10, efs=32, router="crouting", cos_theta=0.3,
                   estimate="sq8")), device="cpu")
    assert trace.totals()["engine.sq8_s"] == sq8


def test_a_stopwatch_sums_its_laps_on_the_host_clock():
    w = trace.Stopwatch(torch.device("cpu"))
    a = w.mark()
    b = w.mark()
    w.lap("x", a, b)
    w.lap("x", a, b)
    assert trace.totals() == {}
    w.commit()
    assert trace.totals()["x"] == pytest.approx(2 * (b - a))
    w.commit()
    assert trace.totals()["x"] == pytest.approx(2 * (b - a))
