"""The hop loop's CUDA graph (``core/search.py``'s ``HopGraphs``), on the card.

A graph replay must equal the eager loop bit for bit: ids, distances,
every counter and ``iters``, on the kernel engines and the torch engine,
the SQ8 two-stage path, a padded batch, a tombstoned search and a router
hook (FINGER).  A new cos(theta*) or a replaced array captures anew and
never replays a stale graph; a call that finds the graph in use runs
eagerly; a replay counts the kernel launches the device ran; and an
engine's first uses are those of the eager loop.  Every test here needs
the card (``gpu``); the CPU tests of the same code are in
``test_torch_trace.py``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import routers as TR
from repro_torch.core import search as S
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import (HopGraphs, _search_batch,
                                     build_search_fn, ensure_sq8_arrays)
from repro_torch.core.spec import SearchSpec
from repro_torch.kernels import ops

COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def index(cuda):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((48, 32)).astype(np.float32)
    idx = AnnIndex.build(base, graph="knn", k=16, device=cuda)
    return idx, queries


def _cfg(idx, **kw):
    spec = SearchSpec(**{"k": 10, "efs": 48, "router": "crouting",
                         "beam_width": 4, "engine": "fused", **kw})
    return idx.engine_spec(spec)


def _arrays(idx, cfg):
    arrays, _ = build_search_fn(idx.graph, cfg, device=idx.device)
    if cfg.estimate in ("sq8", "both"):
        ensure_sq8_arrays(idx.graph, arrays)
    return arrays


def _run(arrays, q, ct, cfg, graphs=None, **kw):
    """One search and its call record."""
    with trace.call() as rec:
        res = _search_batch(arrays, q, ct, cfg, graphs=graphs, **kw)
    torch.cuda.synchronize()
    return res, rec


def _assert_same(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.dists.view(torch.int32), b.dists.view(torch.int32))
    for c in COUNTERS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c
    assert a.extra.keys() == b.extra.keys()
    for k in a.extra:
        assert torch.equal(a.extra[k], b.extra[k]), k
    assert a.iters == b.iters


CASES = {
    "crouting_W4_fused": dict(),
    "crouting_W4_unfused": dict(engine="unfused"),
    "crouting_W4_torch": dict(engine="torch"),
    "both_sq8": dict(estimate="both", efs=64),
    "finger_W4": dict(router="finger"),
    "none_W1": dict(router="none", beam_width=1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_equals_the_eager_loop(index, case):
    idx, queries = index
    cfg = _cfg(idx, **CASES[case])
    arrays = _arrays(idx, cfg)
    q = torch.as_tensor(queries, device=idx.device)
    ct = idx.profile.cos_theta_star
    eager, erec = _run(arrays, q, ct, cfg)
    assert erec.graph_iters == 0 and eager.iters > 2
    graphs = HopGraphs()
    captures = trace.totals().get("search.graph_captures", 0)
    first, rec1 = _run(arrays, q, ct, cfg, graphs)
    second, rec2 = _run(arrays, q, ct, cfg, graphs)
    for res in (first, second):
        _assert_same(res, eager)
    # the first call's first iteration runs eagerly, then it captures
    assert rec1.graph_iters == rec1.iters - 1
    assert rec2.graph_iters == rec2.iters == eager.iters
    assert trace.totals()["search.graph_captures"] == captures + 1
    # the results are the caller's: a third call leaves them as they were
    keep = second.ids.clone()
    _run(arrays, q.flip(0), ct, cfg, graphs)
    assert torch.equal(second.ids, keep)


@pytest.mark.gpu
def test_a_padded_batch_replays_equal_to_eager(index):
    idx, queries = index
    cfg = _cfg(idx, estimate="both", efs=64)
    arrays = _arrays(idx, cfg)
    q = torch.as_tensor(queries, device=idx.device)
    valid = torch.arange(q.shape[0], device=idx.device) < 37
    ct = idx.profile.cos_theta_star
    eager, _ = _run(arrays, q, ct, cfg, valid=valid)
    graphs = HopGraphs()
    for _ in range(2):
        res, rec = _run(arrays, q, ct, cfg, graphs, valid=valid)
        _assert_same(res, eager)
    assert rec.graph_iters == rec.iters
    assert int(res.dist_calls[37:].sum()) == 0
    # without valid the same shape has a graph of its own
    res, rec = _run(arrays, q, ct, cfg, graphs)
    _assert_same(res, _run(arrays, q, ct, cfg)[0])
    assert rec.graph_iters == rec.iters - 1 and len(graphs) == 2


@pytest.mark.gpu
def test_a_tombstoned_search_replays_equal_to_eager(index):
    idx, queries = index
    cfg = _cfg(idx)
    arrays = _arrays(idx, cfg)
    q = torch.as_tensor(queries, device=idx.device)
    ct = idx.profile.cos_theta_star
    dead = torch.zeros(idx.graph.n + 1, dtype=torch.bool, device=idx.device)
    dead[::7] = True
    dead[-1] = False
    eager, _ = _run(arrays, q, ct, cfg, tombstone=dead)
    graphs = HopGraphs()
    for _ in range(2):
        res, rec = _run(arrays, q, ct, cfg, graphs, tombstone=dead)
        _assert_same(res, eager)
    assert rec.graph_iters == rec.iters
    live = res.ids[res.ids < idx.graph.n]
    assert not bool(dead[live.long()].any())


@pytest.mark.gpu
def test_a_new_cos_theta_captures_anew(index):
    idx, queries = index
    cfg = _cfg(idx)
    arrays = _arrays(idx, cfg)
    q = torch.as_tensor(queries, device=idx.device)
    graphs = HopGraphs()
    cts = (0.05, 0.4)
    eager = {ct: _run(arrays, q, ct, cfg)[0] for ct in cts}
    assert not torch.equal(eager[cts[0]].dist_calls, eager[cts[1]].dist_calls)
    captures = trace.totals().get("search.graph_captures", 0)
    for i, ct in enumerate(cts + cts):
        res, rec = _run(arrays, q, ct, cfg, graphs)
        _assert_same(res, eager[ct])
        # a value's first call captures from an eager first iteration and
        # never replays the other value's graph; its later calls replay
        # its own
        assert rec.graph_iters == rec.iters - (i < 2)
    assert trace.totals()["search.graph_captures"] == captures + 2
    # a shape keeps HOP_GRAPH_KEYS graphs: the least recently used goes
    more = [0.1 + 0.05 * i for i in range(S.HOP_GRAPH_KEYS - 1)]
    for ct in more:
        _run(arrays, q, ct, cfg, graphs)
    (slot,) = graphs._slots.values()
    assert len(slot.graphs) == S.HOP_GRAPH_KEYS
    res, rec = _run(arrays, q, cts[0], cfg, graphs)
    _assert_same(res, eager[cts[0]])
    assert rec.graph_iters == rec.iters - 1
    assert trace.totals()["search.graph_captures"] == (
        captures + 2 + len(more) + 1)


@pytest.mark.gpu
def test_an_engine_counts_a_new_cos_theta_once_as_a_first_use(index):
    """Alternating cos(theta*) values replay their own graphs; each value's
    first call on a shape the engine has run is one first use (its
    capture), in ``first_uses()`` and in the call's record."""
    idx, queries = index
    cfg = _cfg(idx, efs=60)
    _, fn = build_search_fn(idx.graph, cfg, device=idx.device)
    ct = idx.profile.cos_theta_star
    fn(queries, ct)
    base = fn.first_uses()
    seen = []
    for c in (ct, 0.3, ct, 0.3, 0.2, ct):
        res = fn(queries, c)
        rec = trace.calls()[-1]
        seen.append((fn.first_uses() - base, rec.first_use,
                     rec.graph_iters == rec.iters))
    assert seen == [(0, False, True), (1, True, False), (1, False, True),
                    (1, False, True), (2, True, False), (2, False, True)]


@pytest.mark.gpu
def test_hop_states_beyond_the_memory_budget_run_eagerly(index, monkeypatch):
    """A state that does not fit the budget takes no slot: its calls run
    eagerly and equal the graph's; with room for one state, two shapes
    in turn drop each other's slot, and each capture after the first
    counts as a first use."""
    idx, queries = index
    cfg = _cfg(idx, efs=36)
    arrays = _arrays(idx, cfg)
    q = torch.as_tensor(queries, device=idx.device)
    ct = idx.profile.cos_theta_star
    eager, _ = _run(arrays, q, ct, cfg)
    dims = (q.shape[0], q.shape[1], cfg.efs, idx.graph.n,
            4 * arrays["neighbors"].shape[1], arrays["neighbors"].shape[1],
            ())
    one = S._HopState.nbytes(*dims)
    monkeypatch.setattr(S, "_memory_budget", lambda dev: one - 1)
    graphs = HopGraphs()
    for _ in range(2):
        res, rec = _run(arrays, q, ct, cfg, graphs)
        _assert_same(res, eager)
        assert rec.graph_iters == 0
    assert len(graphs) == 0
    monkeypatch.setattr(S, "_memory_budget", lambda dev: one)
    _, fn = build_search_fn(idx.graph, cfg, device=idx.device)
    fn(queries, ct)
    fn(queries[:40], ct)            # smaller: fits beside nothing else
    base = fn.first_uses()
    for rows in (48, 40, 48):
        res = fn(queries[:rows], ct)
        rec = trace.calls()[-1]
        assert rec.first_use and rec.graph_iters == rec.iters - 1
    assert fn.first_uses() == base + 3
    _assert_same(res, eager)


@pytest.mark.gpu
def test_a_replaced_array_captures_anew(index):
    idx, queries = index
    cfg = _cfg(idx, efs=40)
    arrays = dict(_arrays(idx, cfg))
    q = torch.as_tensor(queries, device=idx.device)
    ct = idx.profile.cos_theta_star
    # a copy of the rows that this test alone holds
    arrays["vectors"] = arrays["vectors"].clone()
    graphs = HopGraphs()
    eager, _ = _run(arrays, q, ct, cfg)
    _run(arrays, q, ct, cfg, graphs)
    old = arrays["vectors"]
    arrays["vectors"] = old.clone()
    # a replay of the stale graph would read the old rows: spoil them
    old.zero_()
    res, rec = _run(arrays, q, ct, cfg, graphs)
    _assert_same(res, eager)
    assert rec.graph_iters == rec.iters - 1
    res, rec = _run(arrays, q, ct, cfg, graphs)
    _assert_same(res, eager)
    assert rec.graph_iters == rec.iters


@pytest.mark.gpu
def test_a_call_that_finds_the_graph_in_use_runs_eagerly(index):
    idx, queries = index
    cfg = _cfg(idx, efs=56)
    _, fn = build_search_fn(idx.graph, cfg, device=idx.device)
    q = torch.as_tensor(queries, device=idx.device)
    ct = idx.profile.cos_theta_star
    first = fn(q, ct)
    (slot,) = fn.graphs._slots.values()
    assert len(slot.graphs) == 1
    out = {}

    def other():
        out["res"] = fn(q, ct)
        torch.cuda.synchronize()
        out["rec"] = trace.calls()[-1]      # the engine's own record

    slot.lock.acquire()
    try:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        slot.lock.release()
    _assert_same(out["res"], first)
    assert out["rec"].graph_iters == 0 and out["rec"].iters > 0
    again = fn(q, ct)
    rec = trace.calls()[-1]
    _assert_same(again, first)
    assert rec.graph_iters == rec.iters > 0


@pytest.mark.gpu
def test_a_replay_counts_the_launches_the_device_ran(index):
    idx, queries = index
    q = torch.as_tensor(queries, device=idx.device)
    ct = idx.profile.cos_theta_star
    for kw in (dict(), dict(engine="unfused"), dict(estimate="both")):
        cfg = _cfg(idx, efs=44, **kw)
        arrays = _arrays(idx, cfg)
        graphs = HopGraphs()
        counts = []
        for g in (None, graphs, graphs):
            before = ops.thread_launch_counts()
            glob = dict(ops.LAUNCHES)
            res, _ = _run(arrays, q, ct, cfg, g)
            after = ops.thread_launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            assert {k: ops.LAUNCHES[k] - glob[k] for k in glob} == counts[-1]
        assert counts[0] == counts[1] == counts[2], kw
        assert counts[0]["pool_merge"] == res.iters


@pytest.mark.gpu
def test_first_uses_are_those_of_the_eager_loop(index, cuda):
    idx, queries = index
    TR.register_router(dataclasses.replace(
        TR.get_router("crouting"), name="_test_eager", graph_safe=False))
    try:
        specs = {r: _cfg(idx, router=r, efs=52)
                 for r in ("crouting", "_test_eager")}
        ct = idx.profile.cos_theta_star
        # the kernel libraries loaded before either engine's first call
        _run(_arrays(idx, specs["crouting"]),
             torch.as_tensor(queries, device=cuda), ct, specs["crouting"])
        fns = {r: build_search_fn(idx.graph, cfg, device=cuda)[1]
               for r, cfg in specs.items()}
        seen = {}
        for r, fn in fns.items():
            flags = []
            for rows in (48, 48, 16, 48, 16):
                fn(queries[:rows], ct)
                rec = trace.calls()[-1]             # the engine's record
                flags.append((rec.first_use, rec.graph_iters > 0))
            seen[r] = (fn.first_uses(), [f for f, _ in flags])
            replays = [g for _, g in flags]
            assert replays == ([False] * 5 if r == "_test_eager"
                               else [True] * 5)
        assert seen["crouting"] == seen["_test_eager"]
        assert seen["crouting"][1] == [True, False, True, False, False]
        assert len(fns["_test_eager"].graphs) == 0
        assert len(fns["crouting"].graphs) == 2
    finally:
        TR.unregister_router("_test_eager")
