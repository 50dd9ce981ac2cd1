"""The reference against the program on a tiny index, and the control."""
import math

import numpy as np
import pytest
import torch

from perfbench import check, control, data
from perfbench import reference as R
from perfbench.conftest import CELLS, metric_cases, tiny
from repro_torch.core.angles import sample_angle_profile
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec


SPECS = {"crouting": {}, "none": {"router": "none"},
         "crouting-all": {"beam_prune": "all"}}


def _program(cfg, seed):
    dev = torch.device("cpu")
    inputs = data.make_inputs(cfg, seed, dev)
    base = inputs.base.numpy()
    idx = AnnIndex.build(base, graph="knn", k=cfg["graph"]["k"],
                         metric=cfg["metric"], profile=False, device=dev)
    idx.profile = sample_angle_profile(
        idx.graph, efs=cfg["profile"]["efs"],
        percentile=cfg["profile"]["percentile"],
        queries=idx.graph.vectors[inputs.profile_rows.numpy()])
    return inputs, idx


def _profile_less_own_rows(idx, x64, rows, cfg):
    """The program's profile samples, query after query, each matched with
    the reference's: under ``ip`` and ``cosine`` the program also samples
    the expansion of the query's own row, where its float32 conversion of a
    rank of 0 gives d(c, q) about 1e-4 in place of 0 (PERF.md, section 7).
    Each reference sample must have its own program sample, their cosines
    equal to 1e-5 (a near tie of ranks may swap two expansions, so the
    order is not compared), and at most a degree of program samples a
    query may be left over; returns the samples less those."""
    g, metric, efs = idx.graph, cfg["metric"], cfg["profile"]["efs"]
    kept = []
    for r in rows:
        ref = np.sort(np.cos(R.profile_angles(
            x64.numpy(), g.neighbors, g.entry_point, x64[[r]].numpy(), efs,
            metric)))
        got = np.sort(np.cos(sample_angle_profile(
            g, efs=efs, queries=g.vectors[[r]]).samples))
        match, j = [], 0
        for i, v in enumerate(got):
            if j < len(ref) and abs(v - ref[j]) <= 1e-5:
                match.append(i)
                j += 1
        assert j == len(ref) and len(got) - j <= g.max_degree, (r, j)
        kept.append(np.arccos(got[match]))
    return np.concatenate(kept)


@pytest.mark.parametrize("variant", SPECS)
@pytest.mark.parametrize("engine", ["torch", "fused"])
@pytest.mark.parametrize("name,metric", metric_cases())
def test_reference_equals_the_program_on_a_tiny_index(name, metric, engine,
                                                      variant):
    cfg = tiny(name, metric=metric).config
    cfg["search"].update(SPECS[variant])
    if variant == "none" and cfg["search"]["estimate"] == "both":
        # "both" is SQ8 behind a pruning router; without one it is "sq8"
        cfg["search"]["estimate"] = "sq8"
    inputs, idx = _program(cfg, 17)
    g, n = idx.graph, idx.graph.n
    assert g.metric == metric
    # graph: the same neighbours, edge lengths to fp32 rounding
    ref, d2 = R.nearest(inputs.base, inputs.base, cfg["graph"]["k"], "fp64",
                        metric, self_rows=torch.arange(n))
    same = ref.numpy() == g.neighbors
    # fp32 products may swap two neighbours whose distances tie to
    # rounding (the cell's graph_ids_off allows for it)
    assert same.mean() > 0.999
    x64 = R.rows_in(inputs.base, "fp64", metric)
    edges = (np.sqrt(d2.numpy()) if metric == "l2"
             else R.edge_lengths(x64, ref).numpy())
    assert np.allclose(edges[same], g.edge_eu_dist[same], rtol=1e-5)
    assert R.medoid(inputs.base, "fp64", metric) == g.entry_point
    # profile: the same samples to rounding, the same threshold
    angles = R.profile_angles(x64.numpy(), g.neighbors, g.entry_point,
                              x64[inputs.profile_rows].numpy(),
                              cfg["profile"]["efs"], metric)
    theta = float(np.percentile(angles, cfg["profile"]["percentile"]))
    if metric == "l2":
        assert len(angles) == len(idx.profile.samples)
        assert abs(theta - idx.profile.theta_star) < 1e-5
        cos_theta = None    # the program's own threshold
    else:
        kept = _profile_less_own_rows(idx, x64, inputs.profile_rows.numpy(),
                                      cfg)
        assert len(kept) == len(angles)
        assert abs(theta - np.percentile(kept, cfg["profile"]["percentile"])
                   ) < 1e-5
        # the search is held to the reference with the reference's
        # threshold, which the program's extra samples move
        cos_theta = math.cos(theta)
    spec = SearchSpec(**{**cfg["search"], "engine": engine,
                         "cos_theta": cos_theta})
    ids, dists, stats = idx.search(inputs.queries.numpy(), spec)
    # search: every id and counter equal
    nb = torch.as_tensor(g.neighbors).long()
    xp, nbp, edp = R.with_pad(x64, nb, R.edge_lengths(x64, nb))
    sq8 = (R.sq8_tables(x64)
           if cfg["search"]["estimate"] in R.TWO_STAGE else None)
    q64 = R.rows_in(inputs.queries, "fp64", metric)
    found = R.search(xp, nbp, edp, g.entry_point, q64, math.cos(theta),
                     cfg["search"], metric, sq8)
    assert np.array_equal(torch.where(found.ids >= n, -1, found.ids).numpy(),
                          ids)
    if metric == "l2":
        assert np.allclose(found.dists.numpy(), dists, rtol=1e-5)
    else:
        # ranks reach zero and go negative: the gap against |q|·|x|
        scale = (torch.linalg.norm(q64, dim=1)[:, None]
                 * torch.linalg.norm(x64[found.ids.clamp_max(n - 1)], dim=-1))
        assert (np.abs(found.dists.numpy() - dists)
                <= 1e-5 * scale.numpy()).all()
    for c in R.COUNTERS:
        assert np.array_equal(found.counters[c].numpy(), getattr(stats, c)), c


def test_search_blocks_equal_one_block():
    cfg = tiny("gist500k.offline", dim=48).config
    inputs = data.make_inputs(cfg, 4, torch.device("cpu"))
    x = inputs.base.double()
    nb, _ = R.nearest(inputs.base, inputs.base, 8, "fp64", "l2",
                      self_rows=torch.arange(x.shape[0]))
    xp, nbp, edp = R.with_pad(x, nb, R.edge_lengths(x, nb))
    sq8 = R.sq8_tables(inputs.base)
    q = inputs.queries.double()
    one = R.search(xp, nbp, edp, 0, q, 0.2, cfg["search"], "l2", sq8)
    many = R.search_blocks(xp, nbp, edp, 0, q, 0.2, cfg["search"], "l2", sq8,
                           block=7)
    assert torch.equal(one.ids, many.ids)
    for c in R.COUNTERS:
        assert torch.equal(one.counters[c], many.counters[c])


def test_ks_distance():
    a = np.linspace(0, 1, 101)
    assert check.ks_distance(a, a) == 0.0
    assert check.ks_distance(a, a + 2) == 1.0
    assert 0.09 < check.ks_distance(a, a + 0.1) < 0.11


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    got = R._tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


@pytest.mark.parametrize("name,metric", metric_cases())
def test_control_comes_out_not_correct(name, metric):
    """The reference a step below float32 (TF32 products, bf16 vectors) in
    the program's place fails the cell's limits, under each metric."""
    cfg = tiny(name, metric=metric).config
    r = control.run_control(cfg, 3, torch.device("cpu"))
    assert r["correct"] is False
    checks = r["checks"]
    assert checks["dist_err"]["value"] > checks["dist_err"]["limit"]
    assert checks["query_mismatch"]["value"] > \
        checks["query_mismatch"]["limit"]
