"""The port's angle profile under every metric, and the hop loop's lane
counters.

Under ``ip`` and ``cosine`` the profile takes its angles' lengths from the
rows, so it samples what the benchmark's float64 reference samples (the
same count, the same threshold to 1e-5) and a search with the program's
own threshold equals the reference's in every id and counter; under
``l2`` the samples stay byte-equal to the JAX package's, which converts
the float32 ranks back under every metric.  ``pruned`` (the lanes the
router pruned) is the same on every engine and under a replayed CUDA
graph, 0 without a pruning router and never above ``est_calls``;
``first_stage`` counts the loop's exact or SQ8 stage-1 lanes; both reach
the totals ``search.pruned`` and ``search.first_stage``, and the profile
its ``profile.queries`` and ``profile.samples``.  The replayed graph's
counters are checked on the card in ``test_torch_prune_graph.py``.
"""
import math

import numpy as np
import pytest
import torch

from perfbench import data
from perfbench import reference as R
from perfbench.conftest import tiny
from repro.core.angles import sample_angle_profile as j_profile
from repro.core.index import AnnIndex as JIndex
from repro_torch import trace
from repro_torch.core.angles import sample_angle_profile
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import _search_batch, build_search_fn
from repro_torch.core.spec import SearchSpec, SearchStats

METRICS = ("l2", "ip", "cosine")
ENGINES = ("torch", "unfused", "fused")
COUNTERS = ("dist_calls", "est_calls", "rerank_calls", "sq8_calls", "hops",
            "pruned", "first_stage")


@pytest.fixture(autouse=True)
def clean_trace():
    trace.reset()
    yield
    trace.reset()


def _cell(metric, estimate="exact", beam_width=4):
    cfg = tiny("sift1m.offline", metric=metric).config
    cfg["search"].update(estimate=estimate, beam_width=beam_width)
    return cfg


@pytest.fixture(scope="module", params=METRICS)
def built(request):
    """A tiny K-NN index of the benchmark's stand-in under each metric,
    profiled on the benchmark's profile queries, and the reference's
    profile of the same queries on its graph."""
    metric = request.param
    cfg = _cell(metric)
    inputs = data.make_inputs(cfg, 17, torch.device("cpu"))
    idx = AnnIndex.build(inputs.base.numpy(), graph="knn",
                         k=cfg["graph"]["k"], metric=metric, profile=False,
                         device="cpu")
    rows = inputs.profile_rows.numpy()
    trace.reset()
    idx.profile = sample_angle_profile(
        idx.graph, efs=cfg["profile"]["efs"],
        percentile=cfg["profile"]["percentile"],
        queries=idx.graph.vectors[rows])
    totals = trace.totals()
    g = idx.graph
    x64 = R.rows_in(inputs.base, "fp64", metric)
    ref = R.profile_angles(x64.numpy(), g.neighbors, g.entry_point,
                           x64[inputs.profile_rows].numpy(),
                           cfg["profile"]["efs"], metric)
    return cfg, inputs, idx, ref, totals


def test_the_profile_samples_what_the_reference_samples(built):
    cfg, _, idx, ref, _ = built
    prof = idx.profile
    assert len(prof.samples) == len(ref)
    theta = float(np.percentile(ref, cfg["profile"]["percentile"]))
    assert abs(prof.theta_star - theta) < 1e-5
    assert np.abs(np.sort(prof.samples) - np.sort(ref)).max() < 1e-4


def test_the_profile_adds_its_queries_and_samples_to_the_totals(built):
    cfg, _, idx, _, totals = built
    assert totals["profile.queries"] == cfg["profile"]["queries"]
    assert totals["profile.samples"] == len(idx.profile.samples)


def test_the_samples_under_l2_are_the_jax_packages(built):
    """Byte-equal under ``l2``; under ``ip`` and ``cosine`` the JAX
    package's copy also samples the expansion of each profile query's own
    row, so it has more samples than the port and the reference."""
    cfg, inputs, idx, ref, _ = built
    jg = JIndex._from_payload(idx._payload()).graph
    queries = idx.graph.vectors[inputs.profile_rows.numpy()]
    kw = dict(efs=cfg["profile"]["efs"],
              percentile=cfg["profile"]["percentile"])
    j = j_profile(jg, queries=queries, **kw)
    t = sample_angle_profile(idx.graph, queries=queries, **kw)
    if idx.graph.metric == "l2":
        assert j.samples.tobytes() == t.samples.tobytes()
        assert j.theta_star == t.theta_star
    else:
        assert len(j.samples) > len(t.samples) == len(ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_a_search_at_the_programs_threshold_equals_the_reference(built,
                                                                 engine):
    cfg, inputs, idx, ref, _ = built
    metric, g, n = cfg["metric"], idx.graph, idx.graph.n
    theta = float(np.percentile(ref, cfg["profile"]["percentile"]))
    spec = SearchSpec(**{**cfg["search"], "engine": engine})
    assert spec.cos_theta is None       # the index's own threshold
    ids, dists, stats = idx.search(inputs.queries.numpy(), spec)
    x64 = R.rows_in(inputs.base, "fp64", metric)
    nb = torch.as_tensor(g.neighbors).long()
    xp, nbp, edp = R.with_pad(x64, nb, R.edge_lengths(x64, nb))
    found = R.search(xp, nbp, edp, g.entry_point,
                     R.rows_in(inputs.queries, "fp64", metric),
                     math.cos(theta), cfg["search"], metric)
    assert np.array_equal(torch.where(found.ids >= n, -1, found.ids).numpy(),
                          ids)
    for c in R.COUNTERS:
        assert np.array_equal(found.counters[c].numpy(), getattr(stats, c)), c
    # the loop's exact lanes: every exact distance but the entry's
    assert np.array_equal(stats.first_stage, stats.dist_calls - 1)
    assert int(stats.pruned.sum()) > 0
    assert (stats.pruned <= stats.est_calls).all()


def _results(idx, queries, **kw):
    spec = SearchSpec(**{"k": 10, "efs": 32, "router": "crouting", **kw})
    _, fn = build_search_fn(idx.graph, idx.engine_spec(spec), device="cpu")
    return idx.search_on(fn, queries, spec)[2]


@pytest.mark.parametrize("estimate,beam_width", [
    ("exact", 1), ("exact", 4), ("angle", 4), ("sq8", 4), ("both", 4)])
def test_the_lane_counters_are_equal_on_every_engine(built, estimate,
                                                     beam_width):
    _, inputs, idx, _, _ = built
    q = inputs.queries.numpy()
    got = {e: _results(idx, q, engine=e, estimate=estimate,
                       beam_width=beam_width) for e in ENGINES}
    for e in ENGINES[1:]:
        for c in COUNTERS:
            assert np.array_equal(getattr(got[e], c),
                                  getattr(got["torch"], c)), (e, c)
    st = got["torch"]
    assert (st.pruned <= st.est_calls).all() and st.pruned.sum() > 0
    if estimate in ("sq8", "both"):
        assert np.array_equal(st.first_stage, st.sq8_calls)
    else:
        assert np.array_equal(st.first_stage, st.dist_calls - 1)


@pytest.mark.parametrize("engine", ENGINES)
def test_no_lane_is_pruned_without_a_pruning_router(built, engine):
    _, inputs, idx, _, _ = built
    st = _results(idx, inputs.queries.numpy(), router="none", engine=engine,
                  beam_width=4)
    assert st.pruned.sum() == 0 and st.est_calls.sum() == 0
    assert np.array_equal(st.first_stage, st.dist_calls - 1)


def test_search_on_adds_the_lanes_to_the_totals(built):
    _, inputs, idx, _, _ = built
    q = inputs.queries.numpy()
    trace.reset()
    a = _results(idx, q, beam_width=4)
    b = _results(idx, q[:7], estimate="sq8", beam_width=4)
    totals = trace.totals()
    assert totals["search.pruned"] == a.pruned.sum() + b.pruned.sum()
    assert totals["search.first_stage"] == (a.first_stage.sum()
                                            + b.first_stage.sum())


def test_a_padded_batch_counts_no_lane_of_its_padding(built):
    cfg, inputs, idx, _, _ = built
    spec = idx.engine_spec(SearchSpec(**{**cfg["search"],
                                         "engine": "torch"}))
    arrays, _ = build_search_fn(idx.graph, spec, device="cpu")
    q = inputs.queries[:12]
    valid = torch.arange(12) < 5
    ct = idx.profile.cos_theta_star
    part = _search_batch(arrays, q, ct, spec, valid=valid)
    alone = _search_batch(arrays, q[:5], ct, spec)
    for c in ("pruned", "first_stage"):
        assert torch.equal(getattr(part, c)[:5], getattr(alone, c)), c
        assert int(getattr(part, c)[5:].sum()) == 0, c


def test_stats_carry_the_lanes_through_rows_and_merge():
    def stats(p, f):
        return SearchStats(dist_calls=np.array(f) + 1,
                           est_calls=np.array(p), rerank_calls=np.zeros(2),
                           sq8_calls=np.zeros(2), hops=np.ones(2), iters=3,
                           pruned=np.array(p), first_stage=np.array(f))
    a, b = stats([2, 5], [10, 20]), stats([1, 0], [7, 8])
    m = SearchStats.merge([a, b])
    assert m.pruned.tolist() == [2, 5, 1, 0]
    assert m.first_stage.tolist() == [10, 20, 7, 8]
    r = m.rows(1, 3)
    assert r.pruned.tolist() == [5, 1] and r.dist_calls.tolist() == [21, 8]
    assert "pruned" not in m.summary()
