"""The reference against the program on a tiny index, and the control."""
import math

import numpy as np
import pytest
import torch

from perfbench import check, control, data
from perfbench import reference as R
from perfbench.conftest import CELLS, tiny
from repro_torch.core.angles import sample_angle_profile
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec


SPECS = {"crouting": {}, "none": {"router": "none"},
         "crouting-all": {"beam_prune": "all"}}


def _program(cfg, seed, engine):
    dev = torch.device("cpu")
    inputs = data.make_inputs(cfg, seed, dev)
    base = inputs.base.numpy()
    idx = AnnIndex.build(base, graph="knn", k=cfg["graph"]["k"],
                         profile=False, device=dev)
    idx.profile = sample_angle_profile(
        idx.graph, efs=cfg["profile"]["efs"],
        percentile=cfg["profile"]["percentile"],
        queries=base[inputs.profile_rows.numpy()])
    spec = SearchSpec(**{**cfg["search"], "engine": engine})
    return inputs, idx, idx.search(inputs.queries.numpy(), spec)


@pytest.mark.parametrize("variant", SPECS)
@pytest.mark.parametrize("engine", ["torch", "fused"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program_on_a_tiny_index(name, engine, variant):
    cfg = tiny(name).config
    cfg["search"].update(SPECS[variant])
    if variant == "none" and cfg["search"]["estimate"] == "both":
        # "both" is SQ8 behind a pruning router; without one it is "sq8"
        cfg["search"]["estimate"] = "sq8"
    inputs, idx, (ids, dists, stats) = _program(cfg, 17, engine)
    g, n = idx.graph, idx.graph.n
    # graph: the same neighbours, edge lengths to fp32 rounding
    ref, d2 = R.nearest(inputs.base, inputs.base, cfg["graph"]["k"], "fp64",
                        self_rows=torch.arange(n))
    same = ref.numpy() == g.neighbors
    # fp32 products may swap two neighbours whose distances tie to
    # rounding (the cell's graph_ids_off allows for it)
    assert same.mean() > 0.999
    assert np.allclose(np.sqrt(d2.numpy())[same], g.edge_eu_dist[same],
                       rtol=1e-5)
    assert R.medoid(inputs.base, "fp64") == g.entry_point
    # profile: the same samples to rounding, the same threshold
    x64 = inputs.base.double()
    angles = R.profile_angles(x64.numpy(), g.neighbors, g.entry_point,
                              x64[inputs.profile_rows].numpy(),
                              cfg["profile"]["efs"])
    assert len(angles) == len(idx.profile.samples)
    theta = float(np.percentile(angles, cfg["profile"]["percentile"]))
    assert abs(theta - idx.profile.theta_star) < 1e-5
    # search: every id and counter equal
    nb = torch.as_tensor(g.neighbors).long()
    xp, nbp, edp = R.with_pad(x64, nb, R.edge_lengths(x64, nb))
    sq8 = (R.sq8_tables(inputs.base)
           if cfg["search"]["estimate"] in R.TWO_STAGE else None)
    found = R.search(xp, nbp, edp, g.entry_point, inputs.queries.double(),
                     math.cos(theta), cfg["search"], sq8)
    assert np.array_equal(torch.where(found.ids >= n, -1, found.ids).numpy(),
                          ids)
    assert np.allclose(found.dists.numpy(), dists, rtol=1e-5)
    for c in R.COUNTERS:
        assert np.array_equal(found.counters[c].numpy(), getattr(stats, c)), c


def test_search_blocks_equal_one_block():
    cfg = tiny("gist500k.offline", dim=48).config
    inputs = data.make_inputs(cfg, 4, torch.device("cpu"))
    x = inputs.base.double()
    nb, _ = R.nearest(inputs.base, inputs.base, 8, "fp64",
                      self_rows=torch.arange(x.shape[0]))
    xp, nbp, edp = R.with_pad(x, nb, R.edge_lengths(x, nb))
    sq8 = R.sq8_tables(inputs.base)
    q = inputs.queries.double()
    one = R.search(xp, nbp, edp, 0, q, 0.2, cfg["search"], sq8)
    many = R.search_blocks(xp, nbp, edp, 0, q, 0.2, cfg["search"], sq8,
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


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    """The reference a step below float32 (TF32 products, bf16 vectors) in
    the program's place fails the cell's limits."""
    cfg = tiny(name).config
    r = control.run_control(cfg, 3, torch.device("cpu"))
    assert r["correct"] is False
    checks = r["checks"]
    assert checks["dist_err"]["value"] > checks["dist_err"]["limit"]
    assert checks["query_mismatch"]["value"] > \
        checks["query_mismatch"]["limit"]
