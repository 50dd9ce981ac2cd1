import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.conftest import CELLS, tiny


@pytest.mark.parametrize("name", CELLS)
def test_inputs_repeat_bit_for_bit_for_a_seed(name, cpu):
    cfg = tiny(name).config
    a = data.make_inputs(cfg, 2 ** 31 + 11, cpu)
    b = data.make_inputs(cfg, 2 ** 31 + 11, cpu)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # another seed: the same data set and work, the queries in another order
    c = data.make_inputs(cfg, 2 ** 31 + 12, cpu)
    assert torch.equal(a.base, c.base)
    assert torch.equal(a.profile_rows, c.profile_rows)
    assert not torch.equal(a.queries, c.queries)
    assert torch.equal(torch.sort(a.queries, dim=0).values,
                       torch.sort(c.queries, dim=0).values)
    # another data seed: another data set
    d = data.make_inputs({**cfg, "data": {**cfg["data"], "seed": 7}},
                         2 ** 31 + 11, cpu)
    assert not torch.equal(a.base, d.base)


def test_inputs_have_the_configured_shapes_and_profile_rows(cpu):
    cfg = tiny("sift1m.offline").config
    x = data.make_inputs(cfg, -5, cpu)
    assert x.base.shape == (cfg["n_base"], cfg["dim"])
    assert x.queries.shape == (cfg["n_query"], cfg["dim"])
    assert x.base.dtype == x.queries.dtype == torch.float32
    rows = x.profile_rows.numpy()
    assert len(np.unique(rows)) == cfg["profile"]["queries"]
    assert rows.min() >= 0 and rows.max() < cfg["n_base"]


def test_inputs_lie_near_a_low_dimensional_subspace(cpu):
    """The stand-in's point: a latent Gaussian plus small noise, so the
    K-NN graph stays connected and recall is realistic."""
    cfg = tiny("sift1m.offline").config
    x = data.make_inputs(cfg, 3, cpu).base.double()
    s = torch.linalg.svdvals(x - x.mean(0))
    lat = cfg["data"]["latent_dim"]
    assert s[lat - 1] > 5 * s[lat]
