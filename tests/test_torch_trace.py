"""``repro_torch.trace``: spans and counters inside the port, on the CPU.

Spans are off by default; once enabled they nest as the search runs them
(``search`` > ``hop`` > ``hop.*``); under a torch profiler each phase is a
range directly under the caller's range, which is how the benchmark's
trace summary names an idle gap; the call log marks profiled calls and
first uses; and no setting of the tracer changes a result.
"""
import dataclasses
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import tracing
from repro_torch import trace
from repro_torch.core import routers as TR
from repro_torch.core import search as S
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import HopGraphs, _graph_slot, build_search_fn
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


# --- the hop loop's CUDA graph: what the CPU can check -------------------------

@pytest.mark.parametrize("engine", ["torch", "fused", "unfused"])
def test_the_cpu_loop_captures_and_replays_no_graph(data, engine):
    idx, q = data
    spec = _spec(engine, "both")
    for _ in range(3):
        _search(idx, q, spec)
    calls = trace.calls()
    assert len(calls) == 3 and all(c.iters > 0 for c in calls)
    assert [c.graph_iters for c in calls] == [0, 0, 0]
    assert trace.totals().get("search.graph_captures", 0) == 0
    _, fn = build_search_fn(idx.graph, idx.engine_spec(spec), device="cpu")
    assert len(fn.graphs) == 0


def test_only_a_graph_safe_router_on_a_cuda_device_takes_a_graph_slot(
        monkeypatch):
    """The loop's choice, read without a card: a slot (the path that
    captures and replays) only on a CUDA device, under a router that
    declares itself ``graph_safe``, and only with a ``HopGraphs``."""
    monkeypatch.setattr(S, "_memory_budget", lambda dev: 1 << 40)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name in ("none", "crouting", "crouting_o", "triangle", "finger"):
        rt = TR.get_router(name)
        assert rt.graph_safe, name
        graphs = HopGraphs()
        slot = _graph_slot(graphs, cuda, rt, ("shape",), 10)
        assert slot is not None and slot.lock.locked()
        slot.lock.release()
        assert _graph_slot(graphs, cpu, rt, ("shape",), 10) is None
        assert _graph_slot(None, cuda, rt, ("shape",), 10) is None
    unsafe = TR.EdgeAngleRouter(name="_test_unsafe", prunes=True,
                                kernel_estimate=True, graph_safe=False)
    assert not unsafe.graph_safe and not TR.Router(name="x").graph_safe
    graphs = HopGraphs()
    assert _graph_slot(graphs, cuda, unsafe, ("shape",), 10) is None
    assert len(graphs) == 0


def test_a_registered_router_that_is_not_graph_safe_runs_eagerly(data):
    idx, q = data
    TR.register_router(TR.EdgeAngleRouter(name="_test_unsafe", prunes=True,
                                          kernel_estimate=True,
                                          graph_safe=False))
    try:
        spec = SearchSpec(k=10, efs=32, router="_test_unsafe", beam_width=4)
        ref = _search(idx, q, _spec())
        got = _search(idx, q, spec)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[2].iters == ref[2].iters
        assert trace.calls()[-1].graph_iters == 0
        assert trace.totals().get("search.graph_captures", 0) == 0
    finally:
        TR.unregister_router("_test_unsafe")


def test_hop_graphs_keep_the_recent_shapes_and_lend_each_to_one_call(
        monkeypatch):
    from repro_torch.core.search import HOP_GRAPHS_MAX
    monkeypatch.setattr(S, "_memory_budget", lambda dev: 1 << 40)
    dev = torch.device("cuda")
    g = HopGraphs()
    a = g.acquire("a", dev, 1)
    assert a is not None and g.acquire("a", dev, 1) is None  # in use: eager
    a.lock.release()
    for i in range(HOP_GRAPHS_MAX - 1):
        g.acquire(i, dev, 1).lock.release()
    assert g.acquire("a", dev, 1) is a                  # now the most recent
    a.lock.release()
    g.acquire("new", dev, 1).lock.release()
    kept = list(range(1, HOP_GRAPHS_MAX - 1)) + ["a", "new"]
    assert len(g) == HOP_GRAPHS_MAX and list(g._slots) == kept
    assert g.acquire(0, dev, 1) is not None and 0 in g._slots
    assert 1 not in g._slots


def test_hop_graphs_keep_every_engines_states_within_the_memory_budget(
        monkeypatch):
    """The kept states of all engines on one device share one budget: a
    new shape drops the least recently used idle slots, of any engine on
    that device, until it fits; a slot in use is never dropped; a state
    that cannot fit takes no slot (its call runs eagerly) and drops
    nothing."""
    monkeypatch.setattr(S, "_memory_budget", lambda dev: 100)
    dev, other = torch.device("cuda", 6), torch.device("cuda", 7)
    g1, g2 = HopGraphs(), HopGraphs()
    for g, shape, dv in ((g1, "a", dev), (g2, "b", dev), (g2, "x", other)):
        g.acquire(shape, dv, 40).lock.release()
    c = g1.acquire("c", dev, 40)            # 120 > 100: "a" goes
    assert c is not None and list(g1._slots) == ["c"]
    c.lock.release()
    b = g2.acquire("b", dev, 40)            # in use from here on
    d = g2.acquire("d", dev, 60)            # "c" is idle and older: it goes
    assert d is not None and not g1._slots
    d.lock.release()
    assert list(g2._slots) == ["x", "b", "d"]
    e = g1.acquire("e", dev, 30)            # 130: "d" is idle, "b" is not
    assert e is not None and list(g2._slots) == ["x", "b"]
    e.lock.release()
    assert g1.acquire("big", dev, 101) is None      # never fits
    assert list(g1._slots) == ["e"] and list(g2._slots) == ["x", "b"]
    e = g1.acquire("e", dev, 30)
    f = g1.acquire("f", dev, 70)            # "e" is in use, "b" too
    assert f is None and list(g1._slots) == ["e"]
    b.lock.release()
    e.lock.release()


def test_hop_graphs_lend_a_slot_to_one_thread_at_a_time(monkeypatch):
    """Serving threads share engines: under many threads and a short
    switch interval, no slot is ever lent to two calls at once, and the
    kept states stay within the budget."""
    import sys
    import threading
    monkeypatch.setattr(S, "_memory_budget", lambda dev: 100)
    dev = torch.device("cuda", 5)
    engines = [HopGraphs() for _ in range(3)]
    users, faults = {}, []

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            g = engines[rng.integers(3)]
            slot = g.acquire(int(rng.integers(6)), dev,
                             int(rng.integers(10, 40)))
            if slot is None:
                continue
            if users.setdefault(id(slot), 0):
                faults.append("shared")
            users[id(slot)] += 1
            users[id(slot)] -= 1
            slot.lock.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not faults
    assert sum(slot.nbytes for g in engines
               for slot in g._slots.values()) <= 100


def test_a_hop_state_allocates_the_bytes_it_is_counted_at():
    dims = (5, 16, 32, 600, 48, 12, ("finger_est_calls",))
    s = S._HopState(*dims, torch.device("cpu"))
    got = sum(t.numel() * t.element_size()
              for t in list(vars(s).values()) + list(s.extras.values())
              if isinstance(t, torch.Tensor))
    assert got == S._HopState.nbytes(*dims)


def test_an_engine_counts_a_capture_on_a_shape_it_has_run_as_a_first_use(
        data, monkeypatch):
    """A capture on a new shape falls inside that shape's first use; one
    on a shape the engine has run (a new cos(theta*)) is a first use of
    its own, in ``first_uses()`` and in the call's record.  The CPU
    captures nothing, so the loop here reports a capture where cos(theta*)
    is 0.5."""
    idx, q = data
    real = S._search_batch

    def search(arrays, queries, cos_theta, cfg, graphs=None, **kw):
        if cos_theta == 0.5:
            graphs.captured()
        return real(arrays, queries, cos_theta, cfg, **kw)

    monkeypatch.setattr(S, "_search_batch", search)
    cfg = idx.engine_spec(SearchSpec(k=10, efs=40, router="crouting",
                                     beam_width=4))
    _, fn = build_search_fn(idx.graph, cfg, device="cpu")
    uses = []
    for rows, ct in ((8, 0.3), (8, 0.3), (8, 0.5), (4, 0.5), (8, 0.3)):
        fn(q[:rows], ct)
        uses.append((fn.first_uses(), trace.calls()[-1].first_use))
    base = uses[0][0]
    assert uses == [(base, True), (base, False), (base + 1, True),
                    (base + 2, True), (base + 2, False)]
    assert fn.graphs.captures_on_this_thread() == 2


def test_a_merge_prewarms_with_the_new_snapshots_cos_theta(monkeypatch):
    """A request without a cos(theta*) of its own searches with the
    snapshot's profile; the merge's prewarm does too, so on the card the
    hop graphs a request replays are captured off the request path."""
    from repro_torch.mutate import index as MI
    rng = np.random.default_rng(3)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    idx = AnnIndex.build(base, graph="knn", k=10, device="cpu")
    mi = MI.MutableAnnIndex(idx, MI.MutateConfig(auto_merge="off",
                                                 graph="hnsw",
                                                 graph_kw=dict(m=8, efc=32)))
    mi.search(base[:4])
    seen = []
    real = MI.build_search_fn

    def build(*a, **kw):
        arrays, fn = real(*a, **kw)

        def call(queries, cos_theta, *rest):
            seen.append(cos_theta)
            return fn(queries, cos_theta, *rest)
        call.first_uses = fn.first_uses
        return arrays, call

    monkeypatch.setattr(MI, "build_search_fn", build)
    mi.insert(rng.standard_normal((6, 16)).astype(np.float32))
    mi.delete(mi.live_ids()[:3])
    assert mi.merge()
    profile = mi._state.snapshot.index.profile
    assert seen == [profile.cos_theta_star]


def test_graph_iters_and_the_replay_phase_are_as_documented():
    fields = {f.name: f for f in dataclasses.fields(trace.Call)}
    assert "graph_iters" in fields and trace.Call(request=1).graph_iters == 0
    for word in ("``graph_iters``", "``hop.replay``", "``hop.capture``",
                 "``search.graph_captures``"):
        assert word in trace.__doc__, word
    with trace.call() as rec:
        trace.hop_loop(5, 100, 50, graph_iters=4)
        trace.hop_loop(2, 10, 5)
    assert (rec.iters, rec.graph_iters, rec.dispatch_ns, rec.sync_ns) == \
        (7, 4, 110, 55)
    assert trace.calls()[-1] is rec
    trace.enable()
    ph = trace.phases()
    for _ in range(2):
        ph.hop()
        ph.to("hop.sync")
        ph.to("hop.replay")
    ph.close()
    spans = trace.drain()
    by_id = {s.id: s for s in spans}
    assert Counter(s.name for s in spans) == {"hop": 2, "hop.sync": 2,
                                              "hop.replay": 2}
    for s in spans:
        if s.name == "hop.replay":
            assert by_id[s.parent].name == "hop"
    assert trace.NO_PHASES is not ph
