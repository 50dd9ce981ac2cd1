"""NSG construction in the port against the JAX package's ``build_nsg``.

The same numpy base goes through ``repro.core.nsg.build_nsg`` (the
``nsg_index`` fixture: r=24, c=120, l=32, knn_k=24) and the port's
``build_nsg(device="cpu")``, whose candidate acquisition runs on the
``fused`` engine (the kernels' plain versions on the CPU) or on ``torch``.
Adjacency, entry point and orphans must be equal; the MRNG edges'
``edge_eu_dist`` within 1e-6 (l2), the spanning tree's orphan edges'
within 1e-5 (their lengths come from one fp32 product over a block of
orphans against every row; the reference's from one orphan's product
against the rows reachable so far, which rounds differently).  The tensor MRNG selection is held against its NumPy
copy and against the reference's ``_mrng_select`` on the fixture's
candidate pools (equal kept sets), and searches on the port's NSG against
``engine="jnp"`` on the same graph (ids and every counter equal, distances
within 1e-5).

The ip case: the port's K-NN graph on this ip data differs from the
reference's on one row, at a near-tie of a few float32 ulps (the two
packages' fp32 matmuls round differently), and NSG construction starts
from the K-NN graph.  So the ip check feeds the reference ``build_nsg``
the port's K-NN graph and holds everything the NSG steps add (acquisition,
union, MRNG, spanning tree) equal, with ``edge_eu_dist`` within 1e-5 (the
port's engine ranks ip candidates in the kernels' ``|q - x|^2`` form, the
JAX ``jnp`` engine as ``1 - <q, x>``); the K-NN graphs themselves may
differ only at such near-ties.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.nsg as JN
from repro.core.graph import GraphIndex as JGraph
from repro.core.index import AnnIndex as JIndex
from repro.core.knn_graph import build_knn_graph as j_knn
from repro.core.search import build_search_fn as j_build
from repro.core.spec import SearchSpec as JSpec
from repro.data.vectors import make_dataset as j_make_dataset

from repro_torch.core import nsg as TN
from repro_torch.core.angles import sample_angle_profile
from repro_torch.core.graph import validate_graph
from repro_torch.core.index import AnnIndex
from repro_torch.core.knn_graph import build_knn_graph as t_knn
from repro_torch.core.search import build_search_fn as t_build
from repro_torch.core.spec import SearchSpec
from repro_torch.data.vectors import exact_ground_truth, recall_at_k

NSG_KW = dict(r=24, c=120, l=32, knn_k=24)
COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")


@pytest.fixture(scope="module")
def port_nsgs(small_ds):
    """The fixture's NSG, acquisition on the ``fused`` and ``torch``
    engines."""
    return {engine: TN.build_nsg(
        small_ds.base, device="cpu", search_spec=SearchSpec(
            router="none", beam_width=4, engine=engine), **NSG_KW)
        for engine in ("fused", "torch")}


@pytest.fixture(scope="module")
def port_nsg(port_nsgs):
    return port_nsgs["fused"]


def _mrng_pools(base, metric):
    """Steps 1-4 of the port's build through its pieces: the candidate
    pools of every node (acquisition on the fused engine, union with the
    K-NN list), packed, and the tensor MRNG's kept mask."""
    n = base.shape[0]
    knn = t_knn(base, k=NSG_KW["knn_k"], metric=metric, device="cpu")
    pool = max(NSG_KW["l"], min(NSG_KW["c"], n - 1))
    cand_ids, cand_rank = TN.acquire_candidates(
        knn, base, TN.acquisition_spec(SearchSpec(router="none",
                                                  beam_width=4), pool,
                                       metric), 512, "cpu")
    pools = [TN.candidate_pool(p, cand_ids[p], cand_rank[p],
                               knn.neighbors[p], base, metric)
             for p in range(n)]
    ids, rank = TN.pack_pools(pools, n)
    vecs = np.concatenate([base, np.zeros((1, base.shape[1]), np.float32)])
    kept = TN.mrng_select(torch.as_tensor(ids), torch.as_tensor(rank),
                          torch.as_tensor(vecs), metric, NSG_KW["r"]).numpy()
    return pools, ids, rank, kept


def _orphan_edges(g, kept):
    """Mask of the edges step 5 appended: in each row, the valid slots past
    the MRNG-kept ones."""
    slot = np.arange(g.max_degree)[None, :]
    return (g.neighbors < g.n) & (slot >= kept.sum(1)[:, None])


def _assert_same_graph(a, b, kept, eu_tol, orphan_tol):
    """Adjacency, entry and orphans equal; the MRNG edges' lengths within
    ``eu_tol``, the orphan edges' within ``orphan_tol`` (their fp32 product
    covers a block of orphans against every row, the reference's one
    orphan against the reachable rows, and the two round differently)."""
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    assert a.entry_point == b.entry_point
    assert a.build_stats["orphans"] == b.build_stats["orphans"]
    assert b.kind == "nsg" and b.neighbors.dtype == np.int32
    pad = a.neighbors == a.n
    assert np.isinf(b.edge_eu_dist[pad]).all()
    tree = _orphan_edges(b, kept)
    assert tree.sum() == b.build_stats["orphans"]
    mrng = ~pad & ~tree
    np.testing.assert_allclose(a.edge_eu_dist[mrng], b.edge_eu_dist[mrng],
                               rtol=0, atol=eu_tol)
    np.testing.assert_allclose(a.edge_eu_dist[tree], b.edge_eu_dist[tree],
                               rtol=0, atol=orphan_tol)


@pytest.fixture(scope="module")
def l2_pools(small_ds):
    return _mrng_pools(small_ds.base, "l2")


@pytest.mark.parametrize("engine", ["fused", "torch"])
def test_nsg_matches_jax_build(nsg_index, port_nsgs, l2_pools, engine):
    g = port_nsgs[engine]
    _assert_same_graph(nsg_index, g, l2_pools[3], 1e-6, 1e-5)
    for key in ("r", "c", "l", "knn_k", "orphans", "knn_secs",
                "acquire_secs", "mrng_secs", "tree_secs", "build_secs"):
        assert key in g.build_stats


def test_nsg_structure_and_recall_floor(small_ds, port_nsg):
    """``test_hnsw_nsg.py``'s nsg properties on the port's graph: every node
    reachable from the medoid, stored edge lengths Euclidean, and recall
    above the reference's NSG floor at efs=48."""
    g = port_nsg
    validate_graph(g)
    seen = np.zeros(g.n, bool)
    stack = [g.entry_point]
    seen[g.entry_point] = True
    while stack:
        u = stack.pop()
        for v in g.neighbors[u]:
            if v < g.n and not seen[v]:
                seen[v] = True
                stack.append(int(v))
    assert seen.all(), f"{(~seen).sum()} unreachable nodes"
    idx = AnnIndex(graph=g, profile=None, device="cpu")
    ids, _, _ = idx.search(small_ds.queries, spec=SearchSpec(
        k=10, efs=48, router="none"))
    gt = exact_ground_truth(small_ds, k=10, device="cpu")
    assert recall_at_k(ids, gt, 10) > 0.75


def test_tensor_mrng_matches_numpy_and_reference(small_ds, l2_pools):
    """On the fixture's candidate pools (acquisition on the fused engine,
    union with the K-NN lists), all three selectors keep the same ids."""
    base = small_ds.base
    pools, ids, rank, kept = l2_pools
    r = NSG_KW["r"]
    assert kept.sum(1).max() <= r and (kept.sum(1) > 0).all()
    for p in range(base.shape[0]):
        a, a_rank = TN._mrng_select(p, *pools[p], base, "l2", r)
        b, b_rank = JN._mrng_select(p, *pools[p], base, "l2", r)
        np.testing.assert_array_equal(ids[p, kept[p]], a, err_msg=str(p))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rank[p, kept[p]], a_rank)
        np.testing.assert_array_equal(a_rank, b_rank)


@pytest.fixture(scope="module")
def nsg_pair(port_nsg):
    """The port's NSG in both packages (carried over as the v3 payload)
    with its angle profile."""
    prof = sample_angle_profile(port_nsg, n_sample=12, efs=48, seed=1)
    t = AnnIndex(graph=port_nsg, profile=prof, device="cpu")
    return JIndex._from_payload(t._payload()), t, prof.cos_theta_star


SPECS = {"crouting": dict(efs=32, router="crouting"),
         "W4_both": dict(efs=32, router="crouting", beam_width=4,
                         estimate="both"),
         "finger": dict(efs=32, router="finger")}


@pytest.mark.parametrize("engine", ["fused", "unfused", "torch"])
@pytest.mark.parametrize("name", list(SPECS))
def test_search_on_nsg_matches_jnp(small_ds, nsg_pair, name, engine):
    j, t, ct = nsg_pair
    spec = dict(SPECS[name], use_hierarchy=False)
    _, jf = j_build(j.graph, JSpec(engine="jnp", **spec))
    a = jf(jnp.asarray(small_ds.queries), jnp.asarray(ct, jnp.float32))
    _, tf = t_build(t.graph, SearchSpec(engine=engine, **spec), device="cpu")
    b = tf(small_ds.queries, ct)
    np.testing.assert_array_equal(np.asarray(a.ids), b.ids.numpy())
    np.testing.assert_allclose(np.asarray(a.dists), b.dists.numpy(),
                               rtol=1e-5, atol=1e-5)
    for c in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a, c)),
                                      getattr(b, c).numpy(), err_msg=c)
    assert int(a.iters) == b.iters
    assert set(a.extra) == set(b.extra)
    for k in a.extra:
        np.testing.assert_array_equal(np.asarray(a.extra[k]),
                                      b.extra[k].numpy(), err_msg=k)
    assert int(np.asarray(a.dist_calls).sum()) > 0


@pytest.fixture(scope="module")
def ip_ds():
    return j_make_dataset(n_base=1200, n_query=30, dim=48, n_clusters=16,
                          metric="ip", seed=2)


def test_ip_knn_graphs_differ_only_at_near_ties(ip_ds):
    """Where the two packages' ip K-NN lists differ, the swapped ids' exact
    (float64) ranks lie within 1e-5 of each other: a rounding tie of the
    fp32 matmuls, not a different selection rule."""
    a = j_knn(ip_ds.base, k=NSG_KW["knn_k"], metric="ip")
    b = t_knn(ip_ds.base, k=NSG_KW["knn_k"], metric="ip", device="cpu")
    x = ip_ds.base.astype(np.float64)
    rows = np.nonzero((a.neighbors != b.neighbors).any(1))[0]
    assert len(rows) <= 2, rows
    for p in rows:
        swapped = sorted(set(a.neighbors[p]) ^ set(b.neighbors[p]))
        exact = 1.0 - x[swapped] @ x[p]
        assert exact.max() - exact.min() < 1e-5, (p, swapped, exact)


def test_ip_nsg_matches_jax_build_on_the_same_knn_graph(ip_ds, monkeypatch):
    def port_knn(base, k, metric):
        g = t_knn(base, k=k, metric=metric, device="cpu")
        return JGraph(**{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(JGraph)})

    monkeypatch.setattr(JN, "build_knn_graph", port_knn)
    a = JN.build_nsg(ip_ds.base, metric="ip", **NSG_KW)
    b = TN.build_nsg(ip_ds.base, metric="ip", device="cpu", **NSG_KW)
    kept = _mrng_pools(ip_ds.base, "ip")[3]
    _assert_same_graph(a, b, kept, 1e-5, 1e-5)
    assert b.norms is not None and b.metric == "ip"


def test_annindex_builds_nsg_on_the_cpu(small_ds):
    idx = AnnIndex.build(small_ds.base[:400], graph="nsg", r=12, c=40, l=16,
                         knn_k=12, device="cpu")
    assert idx.graph.kind == "nsg" and idx.profile is not None
    assert idx.graph.max_degree >= 12
    ids, _, stats = idx.search(small_ds.queries, spec=SearchSpec(
        k=5, efs=24, router="crouting", engine="fused"))
    assert ids.shape == (40, 5) and (ids >= 0).all()
    assert stats.est_calls.sum() > 0


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.mark.gpu
def test_tensor_mrng_on_gpu_matches_numpy(small_ds, l2_pools, cuda):
    """The MRNG selection on the card (a cuBLAS product, TF32 off) against
    the NumPy loop on the fixture's pools: at least 0.999 of the rows keep
    the same ids (a pw within rounding of a rank can flip one)."""
    base = small_ds.base
    pools, ids, rank, _ = l2_pools
    vecs = np.concatenate([base, np.zeros((1, base.shape[1]), np.float32)])
    kept = TN.mrng_select(torch.as_tensor(ids, device=cuda),
                          torch.as_tensor(rank, device=cuda),
                          torch.as_tensor(vecs, device=cuda), "l2",
                          NSG_KW["r"]).cpu().numpy()
    same = [np.array_equal(ids[p, kept[p]],
                           TN._mrng_select(p, *pools[p], base, "l2",
                                           NSG_KW["r"])[0])
            for p in range(base.shape[0])]
    assert np.mean(same) >= 0.999


@pytest.mark.gpu
def test_nsg_builds_and_searches_on_gpu(small_ds, cuda):
    """Built on the card: the reference's NSG recall floor (router none,
    efs=48), and FINGER on the kernel engine counts its estimates."""
    idx = AnnIndex.build(small_ds.base, graph="nsg", device=cuda, **NSG_KW)
    g = idx.graph
    assert g.kind == "nsg" and g.max_degree >= NSG_KW["r"]
    ids, _, _ = idx.search(small_ds.queries, spec=SearchSpec(
        k=10, efs=48, router="none", engine="fused"))
    gt = exact_ground_truth(small_ds, k=10, device="cpu")
    assert recall_at_k(ids, gt, 10) > 0.75
    _, _, stats = idx.search(small_ds.queries, spec=SearchSpec(
        k=10, efs=48, router="finger", engine="fused"))
    assert stats.extra["finger_est_calls"].sum() > 0
