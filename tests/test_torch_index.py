"""The port's public API: AnnIndex end to end against the JAX package,
its error contract, the engine cache, and the import boundary (the port
imports neither JAX nor the JAX package)."""
import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.index import AnnIndex as JIndex
from repro.core.spec import SearchSpec as JSpec

from repro_torch.core import search as S
from repro_torch.core.index import DEFAULT_SEARCH, AnnIndex
from repro_torch.core.spec import SearchSpec, SearchStats
from repro_torch.data.vectors import (exact_ground_truth, make_dataset,
                                      recall_at_k)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ds():
    return make_dataset(n_base=800, n_query=16, dim=24, n_clusters=12, seed=5)


@pytest.fixture(scope="module")
def both(ds):
    """The same build through both packages' entry points (builds are
    byte-equal on the same seed, see test_torch_build.py)."""
    j = JIndex.build(ds.base, graph="hnsw", m=8, efc=48)
    t = AnnIndex.build(ds.base, graph="hnsw", m=8, efc=48, device="cpu")
    return j, t


@pytest.mark.parametrize("engine", ["fused", "torch"])
@pytest.mark.parametrize("beam_width", [1, 4])
def test_slice_end_to_end_matches_jax_package(ds, both, engine, beam_width):
    """Build -> profile -> AnnIndex.search through both packages."""
    j, t = both
    assert t.profile.theta_star == j.profile.theta_star
    ji, jd, js = j.search(ds.queries, spec=JSpec(
        k=10, efs=40, router="crouting", beam_width=beam_width))
    ti, td, ts = t.search(ds.queries, spec=SearchSpec(
        k=10, efs=40, router="crouting", beam_width=beam_width,
        engine=engine))
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(jd, td, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(js.dist_calls, ts.dist_calls)
    np.testing.assert_array_equal(js.est_calls, ts.est_calls)
    np.testing.assert_array_equal(js.hops, ts.hops)
    assert js.iters == ts.iters
    gt = exact_ground_truth(ds, k=10, device="cpu")
    assert recall_at_k(ti, gt, 10) > 0.8


def test_default_search_is_crouting_on_the_kernel_engine(ds, both):
    _, t = both
    assert DEFAULT_SEARCH.engine == "fused" and DEFAULT_SEARCH.router == "crouting"
    assert SearchSpec().engine == "fused"
    ids, dists, stats = t.search(ds.queries)
    assert ids.shape == dists.shape == (16, 10)
    assert stats.router == "crouting" and stats.est_calls.sum() > 0


def test_pad_slots_resolve_to_minus_one_and_inf():
    base = make_dataset(n_base=6, n_query=2, dim=8, n_clusters=2, seed=0)
    idx = AnnIndex.build(base.base, graph="hnsw", m=4, efc=8, device="cpu")
    ids, dists, _ = idx.search(base.queries, spec=SearchSpec(
        k=10, efs=10, router="none"))
    assert (ids[:, 6:] == -1).all() and np.isinf(dists[:, 6:]).all()
    assert (ids[:, :6] >= 0).all() and np.isfinite(dists[:, :6]).all()


def test_pruning_router_without_profile_raises(ds):
    idx = AnnIndex.build(ds.base[:200], graph="hnsw", m=6, efc=16,
                         profile=False, device="cpu")
    with pytest.raises(ValueError, match="profile=False"):
        idx.search(ds.queries, spec=SearchSpec(router="crouting"))
    # an explicit threshold, or a router that never reads it, is fine
    idx.search(ds.queries, spec=SearchSpec(router="crouting", cos_theta=0.2))
    idx.search(ds.queries, spec=SearchSpec(router="none"))


def test_non_spec_search_arguments_raise_type_error(ds, both):
    _, t = both
    with pytest.raises(TypeError):
        t.search(ds.queries, k=10)
    with pytest.raises(TypeError, match="SearchSpec"):
        t.search(ds.queries, spec={"k": 10})


def test_both_needs_a_pruning_router_and_nsg_builds(ds, both):
    _, t = both
    for est in ("sq8", "both"):
        SearchSpec(router="crouting", estimate=est)
    with pytest.raises(ValueError, match="pruning router"):
        t.search(ds.queries, spec=SearchSpec(router="none", estimate="both"))
    nsg = AnnIndex.build(ds.base[:50], graph="nsg", r=8, c=20, l=10,
                         knn_k=8, device="cpu")
    assert nsg.graph.kind == "nsg" and nsg.graph.n == 50
    with pytest.raises(ValueError, match="engine"):
        SearchSpec(engine="pallas")


def test_build_search_fn_caches_and_purges_dead_graphs(ds):
    idx = AnnIndex.build(ds.base[:300], graph="knn", k=6, profile=False,
                         device="cpu")
    cfg = SearchSpec(router="none", use_hierarchy=False)
    a1, f1 = S.build_search_fn(idx.graph, cfg, device="cpu")
    a2, f2 = S.build_search_fn(idx.graph, cfg.replace(k=3, cos_theta=0.5),
                               device="cpu")
    assert f1 is f2 and a1 is a2
    _, f3 = S.build_search_fn(idx.graph, cfg.replace(efs=50), device="cpu")
    assert f3 is not f1
    gid = id(idx.graph)
    del idx, a1, a2, f1, f2, f3
    gc.collect()
    other = AnnIndex.build(ds.base[:100], graph="knn", k=4, profile=False,
                           device="cpu")
    S.build_search_fn(other.graph, cfg, device="cpu")
    assert all(k[0] != gid for k in S._ENGINE_CACHE)
    assert all(k[0] != gid for k in S._ARRAYS_CACHE)


def test_search_stats_merge_and_summary():
    def stats(dc, ec, rr, sq, hops, iters, router="crouting"):
        return SearchStats(dist_calls=np.array(dc), est_calls=np.array(ec),
                           rerank_calls=np.array(rr), sq8_calls=np.array(sq),
                           hops=np.array(hops), iters=iters, router=router)

    a = stats([1, 2], [0, 1], [1, 0], [6, 8], [3, 3], 4)
    b = stats([5], [2], [2], [9], [1], 7)
    m = SearchStats.merge([a, b])
    assert m.iters == 7 and list(m.dist_calls) == [1, 2, 5]
    assert list(m.rerank_calls) == [1, 0, 2] and list(m.sq8_calls) == [6, 8, 9]
    assert m.summary() == {"router": "crouting", "iters": 7,
                           "dist_calls": 2.7, "est_calls": 1.0,
                           "rerank_calls": 1.0, "sq8_calls": 7.7, "hops": 2.3,
                           "shards_failed": 0, "degraded": False}
    with pytest.raises(ValueError):
        SearchStats.merge([a, stats([1], [0], [0], [0], [1], 1, "none")])


def test_default_device_raises_without_a_gpu(ds):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised when no GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        AnnIndex.build(ds.base)
    with pytest.raises(RuntimeError, match="cuda"):
        AnnIndex.from_payload({})


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib, os, pkgutil, sys
sys.path.insert(0, {repo!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
new = ["repro_torch.quant.sq8", "repro_torch.kernels.sq8_distance",
       "repro_torch.kernels.gather_distance",
       "repro_torch.kernels.crouting_prune", "repro_torch.kernels.l2_distance",
       "repro_torch.models.dlrm", "repro_torch.configs",
       "repro_torch.configs.dlrm_mlperf", "repro_torch.configs.shapes",
       "repro_torch.configs.crouting_paper", "repro_torch.core.nsg",
       "repro_torch.core.finger", "repro_torch.core.togg",
       "repro_torch.core.kdtree", "repro_torch.durable.atomic",
       "repro_torch.fault.errors", "repro_torch.fault.failpoints",
       "repro_torch.fault.retry", "repro_torch.durable.wal",
       "repro_torch.durable.manifest", "repro_torch.durable.store",
       "repro_torch.mutate", "repro_torch.mutate.delta",
       "repro_torch.mutate.index", "repro_torch.serve",
       "repro_torch.serve.bucketing", "repro_torch.serve.telemetry",
       "repro_torch.serve.backends", "repro_torch.serve.frontend",
       "repro_torch.core.sharded_index", "repro_torch.mutate.sharded",
       "repro_torch.launch", "repro_torch.launch.mesh",
       "repro_torch.launch.serve", "repro_torch.autotune",
       "repro_torch.autotune.space", "repro_torch.autotune.controller",
       "repro_torch.autotune.proxy", "repro_torch.autotune.driver",
       "repro_torch.tree", "repro_torch.models.layers",
       "repro_torch.models.transformer", "repro_torch.data.synthetic",
       "repro_torch.train", "repro_torch.train.optimizer",
       "repro_torch.train.checkpoint", "repro_torch.train.elastic",
       "repro_torch.train.trainer", "repro_torch.launch.train",
       "repro_torch.configs.granite_8b", "repro_torch.configs.phi4_mini_3_8b",
       "repro_torch.configs.qwen1_5_4b",
       "repro_torch.configs.granite_moe_1b_a400m",
       "repro_torch.configs.arctic_480b", "repro_torch.models.gnn",
       "repro_torch.configs.schnet", "repro_torch.configs.gat_cora",
       "repro_torch.configs.egnn", "repro_torch.configs.gin_tu",
       "repro_torch.train.compress"]
assert all(m in mods for m in new), (new, mods)
import chip_smoke
import importlib.util
for name in ("dlrm_retrieval_torch", "serve_anns_torch", "train_lm_torch",
             "quickstart_torch"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join({examples!r}, name + ".py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "repro"
       or m.startswith("repro.")]
assert not bad, bad
assert len(mods) >= 20, mods
print("ok", len(mods))
""".format(repo=REPO, examples=os.path.join(REPO, "examples"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
