"""Build-side parity of the PyTorch port with the JAX package.

The port's dataset generator, HNSW builder and angle profile are NumPy
copies and must be byte-equal to the JAX package's on the same seed; its
K-NN graph (torch matmul + topk) must pick the same neighbour ids and entry
point, with edge distances within rtol 1e-5 (torch's and XLA's matmuls sum
in different orders).  Inputs come from numpy with a fixed seed.
"""
import numpy as np
import pytest

from repro.core.angles import sample_angle_profile as j_profile
from repro.core.graph import validate_graph as j_validate  # noqa: F401
from repro.core.hnsw import build_hnsw as j_hnsw
from repro.core.knn_graph import build_knn_graph as j_knn
from repro.data import vectors as JV

from repro_torch.core.angles import sample_angle_profile as t_profile
from repro_torch.core.angles import theoretical_angle_pdf
from repro_torch.core.graph import validate_graph
from repro_torch.core.hnsw import build_hnsw as t_hnsw
from repro_torch.core.knn_graph import build_knn_graph as t_knn
from repro_torch.data import vectors as TV


@pytest.mark.parametrize("kw", [
    dict(n_base=600, n_query=8, dim=24, n_clusters=12, seed=3),
    dict(n_base=500, n_query=5, dim=17, n_clusters=1, seed=0),
    dict(n_base=300, n_query=4, dim=16, n_clusters=9, seed=7,
         heavy_tail=True),
    dict(n_base=200, n_query=4, dim=8, n_clusters=4, seed=1,
         metric="cosine"),
])
def test_make_dataset_is_byte_equal(kw):
    a, b = JV.make_dataset(**kw), TV.make_dataset(**kw)
    assert a.base.tobytes() == b.base.tobytes()
    assert a.queries.tobytes() == b.queries.tobytes()
    assert a.base.dtype == b.base.dtype == np.float32


def test_paper_dataset_and_ground_truth_match():
    a = JV.paper_dataset("sift-synth", n_base=400, n_query=6)
    b = TV.paper_dataset("sift-synth", n_base=400, n_query=6)
    assert a.base.tobytes() == b.base.tobytes()
    ga = JV.exact_ground_truth(a, k=10)
    gb = TV.exact_ground_truth(b, k=10, device="cpu")
    np.testing.assert_array_equal(ga, gb)
    assert TV.recall_at_k(gb, ga, 10) == JV.recall_at_k(gb, ga, 10) == 1.0


@pytest.fixture(scope="module")
def tiny():
    """The tiny_graph of tests/test_engine_equivalence.py, built by both."""
    ds = JV.make_dataset(n_base=600, n_query=8, dim=24, n_clusters=12, seed=3)
    return ds, j_hnsw(ds.base, m=8, efc=48, seed=0), \
        t_hnsw(ds.base, m=8, efc=48, seed=0)


def test_build_hnsw_is_byte_equal(tiny):
    _, a, b = tiny
    assert a.neighbors.tobytes() == b.neighbors.tobytes()
    assert a.edge_eu_dist.tobytes() == b.edge_eu_dist.tobytes()
    assert a.vectors.tobytes() == b.vectors.tobytes()
    assert a.norms.tobytes() == b.norms.tobytes()
    assert a.entry_point == b.entry_point and a.kind == b.kind == "hnsw"
    assert len(a.upper_ids) == len(b.upper_ids)
    for x, y in zip(a.upper_ids + a.upper_neighbors,
                    b.upper_ids + b.upper_neighbors):
        assert x.tobytes() == y.tobytes()
    assert a.build_stats["dist_calls"] == b.build_stats["dist_calls"]
    validate_graph(b)


def test_sample_angle_profile_is_equal(tiny):
    _, a, b = tiny
    pa = j_profile(a, n_sample=6, efs=32, seed=1)
    pb = t_profile(b, n_sample=6, efs=32, seed=1)
    assert pa.samples.tobytes() == pb.samples.tobytes()
    assert pa.theta_star == pb.theta_star
    assert pa.cos_theta_star == pb.cos_theta_star
    assert pa.n_sample_queries == pb.n_sample_queries == 6


def test_theoretical_angle_pdf_integrates_to_one():
    eta = np.linspace(0, np.pi, 20001)
    for d in (8, 128, 960):
        assert abs(np.trapezoid(theoretical_angle_pdf(eta, d), eta) - 1) < 1e-3


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_build_knn_graph_matches(metric):
    ds = JV.make_dataset(n_base=500, n_query=4, dim=16, n_clusters=8,
                         seed=2, metric=metric)
    a = j_knn(ds.base, k=8, metric=metric)
    b = t_knn(ds.base, k=8, metric=metric, block=128, device="cpu")
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    assert a.entry_point == b.entry_point
    np.testing.assert_allclose(a.edge_eu_dist, b.edge_eu_dist, rtol=1e-5,
                               atol=1e-6)
    assert b.neighbors.dtype == np.int32 and b.kind == "knn"
    # no self loops
    assert not (b.neighbors == np.arange(500)[:, None]).any()
    validate_graph(b)


def test_knn_graph_keeps_lower_id_on_ties():
    """Duplicated vectors tie exactly; like lax.top_k the lower id wins."""
    base = np.repeat(np.arange(10, dtype=np.float32)[:, None], 4, axis=1)
    base = np.concatenate([base, base, base])           # 3 copies of each
    b = t_knn(base, k=3, device="cpu")
    a = j_knn(base, k=3)
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    # node 0's exact duplicates are 10 and 20, then a neighbour at distance 1
    assert list(b.neighbors[0][:2]) == [10, 20]
