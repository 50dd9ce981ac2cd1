"""Engine parity of the PyTorch port with the JAX package's ``jnp`` engine.

One graph is built by the JAX package and carried to the port with
``AnnIndex.from_payload``; the same numpy queries go through
``repro``'s ``engine="jnp"`` and through all three port engines on the CPU
(``"torch"``; ``"fused"`` and ``"unfused"``, whose kernel wrappers run their
plain versions on CPU tensors — which exercises the in-kernel prune path,
the ``crouting_prune`` + masked-gather pipeline and the ``id*4+flags``
pool encoding), on the exact path and on the two-stage SQ8 path
(``estimate="sq8"|"both"``).  Ids, every counter (``dist_calls``,
``est_calls``, ``hops``, ``rerank_calls``, ``sq8_calls``) and ``iters`` must
be equal; distances within rtol/atol 1e-5 (the port sums squared
differences in the CUDA kernels' order, XLA in its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.angles import sample_angle_profile
from repro.core.hnsw import build_hnsw
from repro.core.index import AnnIndex as JIndex
from repro.core.search import _search_batch as j_search_batch
from repro.core.search import build_search_fn as j_build
from repro.core.search import graph_device_arrays as j_arrays
from repro.core.spec import SearchSpec as JSpec
from repro.data.vectors import make_dataset

from repro_torch.core.index import AnnIndex as TIndex
from repro_torch.core.search import _search_batch as t_search_batch
from repro_torch.core.search import build_search_fn as t_build
from repro_torch.core.search import ensure_sq8_arrays
from repro_torch.core.search import graph_device_arrays as t_arrays
from repro_torch.core.spec import SearchSpec as TSpec

ENGINES = ["torch", "fused", "unfused"]
COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")


@pytest.fixture(scope="module")
def tiny():
    """The tiny_graph of tests/test_engine_equivalence.py, as both indexes."""
    ds = make_dataset(n_base=600, n_query=8, dim=24, n_clusters=12, seed=3)
    g = build_hnsw(ds.base, m=8, efc=48, seed=0)
    prof = sample_angle_profile(g, n_sample=6, efs=32, seed=1)
    j = JIndex(graph=g, profile=prof)
    t = TIndex.from_payload(j._payload(), device="cpu")
    return ds, j, t, prof.cos_theta_star


def _assert_same(a, b, n_valid=None):
    sl = slice(None) if n_valid is None else slice(0, n_valid)
    np.testing.assert_array_equal(np.asarray(a.ids)[sl], b.ids.numpy()[sl])
    np.testing.assert_allclose(np.asarray(a.dists)[sl], b.dists.numpy()[sl],
                               rtol=1e-5, atol=1e-5)
    for c in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a, c)),
                                      getattr(b, c).numpy(), err_msg=c)
    assert int(a.iters) == b.iters


def _run_both(j, t, queries, ct, engine, **spec):
    _, jf = j_build(j.graph, JSpec(engine="jnp", **spec))
    a = jf(jnp.asarray(queries), jnp.asarray(ct, jnp.float32))
    _, tf = t_build(t.graph, TSpec(engine=engine, **spec), device="cpu")
    return a, tf(queries, ct)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("router", ["none", "crouting", "crouting_o",
                                    "triangle"])
def test_routers_at_w1_match_jnp(tiny, router, engine):
    ds, j, t, ct = tiny
    a, b = _run_both(j, t, ds.queries, ct, engine, efs=24, router=router)
    _assert_same(a, b)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("beam_prune", ["best", "all"])
def test_crouting_beam_matches_jnp(tiny, beam_prune, engine):
    ds, j, t, ct = tiny
    a, b = _run_both(j, t, ds.queries, ct, engine, efs=24, router="crouting",
                     beam_width=4, beam_prune=beam_prune)
    _assert_same(a, b)
    assert int(np.asarray(a.est_calls).sum()) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_plain_beam_matches_jnp(tiny, engine):
    ds, j, t, ct = tiny
    a, b = _run_both(j, t, ds.queries, ct, engine, efs=24, router="none",
                     beam_width=4)
    _assert_same(a, b)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("estimate", ["exact", "both"])
def test_valid_masked_padded_batch_matches_jnp(tiny, engine, estimate):
    """A ragged batch padded to 8 lanes: padded lanes count 0 everywhere."""
    ds, j, t, ct = tiny
    q = ds.queries.copy()
    q[5:] = 0.0
    valid = np.arange(8) < 5
    jcfg = JSpec(efs=24, router="crouting", beam_width=4, engine="jnp",
                 estimate=estimate)
    arrays = j_arrays(j.graph, with_sq8=estimate != "exact")
    a = jax.jit(lambda qq, cc, vv: j_search_batch(arrays, qq, cc, jcfg,
                                                  valid=vv))(
        jnp.asarray(q), jnp.asarray(ct, jnp.float32), jnp.asarray(valid))
    b = t_search_batch(ensure_sq8_arrays(t.graph, t_arrays(t.graph, "cpu")),
                       torch.as_tensor(q), ct,
                       TSpec(efs=24, router="crouting", beam_width=4,
                             engine=engine, estimate=estimate),
                       valid=torch.as_tensor(valid))
    _assert_same(a, b, n_valid=5)
    for c in COUNTERS:
        assert (getattr(b, c).numpy()[5:] == 0).all(), c


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("estimate", ["exact", "sq8"])
def test_tombstoned_search_matches_jnp(tiny, engine, estimate):
    """Dead ids are masked before the sq8 path's final rerank: they cost
    no rerank and never come back."""
    ds, j, t, ct = tiny
    n = j.graph.n
    rng = np.random.default_rng(0)
    dead = np.zeros(n + 1, bool)
    dead[rng.choice(n, size=n // 8, replace=False)] = True
    spec = dict(efs=24, router="crouting", beam_width=2, estimate=estimate)
    _, jf = j_build(j.graph, JSpec(engine="jnp", **spec), tombstones=True)
    a = jf(jnp.asarray(ds.queries), jnp.asarray(ct, jnp.float32),
           jnp.asarray(dead))
    _, tf = t_build(t.graph, TSpec(engine=engine, **spec), tombstones=True,
                    device="cpu")
    b = tf(ds.queries, ct, dead)
    _assert_same(a, b)
    ids = b.ids.numpy()
    assert not dead[ids[ids < n]].any()


@pytest.mark.parametrize("engine", ENGINES)
def test_flat_knn_graph_matches_jnp(engine):
    """No hierarchy: the entry point is the medoid for every query."""
    ds = make_dataset(n_base=500, n_query=8, dim=16, n_clusters=1, seed=4)
    j = JIndex.build(ds.base, graph="knn", k=12)
    t = TIndex.from_payload(j._payload(), device="cpu")
    ct = j.profile.cos_theta_star
    assert t.graph.upper_neighbors is None
    a, b = _run_both(j, t, ds.queries, ct, engine, efs=32, router="crouting",
                     beam_width=4, use_hierarchy=False)
    _assert_same(a, b)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("router,estimate,W,efs", [
    ("none", "sq8", 1, 24), ("crouting", "sq8", 4, 24),
    ("crouting", "both", 4, 24), ("crouting", "both", 2, 16)])
def test_two_stage_sq8_matches_jnp(tiny, router, estimate, W, efs, engine):
    """The SQ8 estimate, the lower-bound skip, the approx pool flag and both
    reranks reproduce the jnp engine's pools and counters."""
    ds, j, t, ct = tiny
    a, b = _run_both(j, t, ds.queries, ct, engine, efs=efs, router=router,
                     estimate=estimate, beam_width=W)
    _assert_same(a, b)
    rr, sq = b.rerank_calls.numpy(), b.sq8_calls.numpy()
    assert (rr > 0).all() and (sq > rr).all()
    # a rerank is an exact distance call
    assert (b.dist_calls.numpy() >= rr).all()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("W", [1, 2])
def test_exact_crouting_at_efs16_matches_jnp(tiny, engine, W):
    """The unfused engine's own case in the JAX suite (four queries, efs
    16): crouting_prune decides every prune, also under the W=2 rescue."""
    ds, j, t, ct = tiny
    a, b = _run_both(j, t, ds.queries[:4], ct, engine, efs=16,
                     router="crouting", beam_width=W)
    _assert_same(a, b)
    assert int(b.est_calls.sum()) > 0 and int(b.sq8_calls.sum()) == 0


# --- the inner-product index (the dlrm-mlperf retrieval path) ----------------
@pytest.fixture(scope="module", params=["ip", "cosine"])
def unit_index(request):
    """An HNSW over 700 unit vectors built by the JAX package under a
    non-L2 metric, as both indexes: the prune bound moves into rank space
    (``repro_torch.core.search``, ``bound2`` under ``metric != "l2"``)."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(700, 16)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    j = JIndex.build(base, graph="hnsw", metric=request.param, m=8, efc=32)
    t = TIndex.from_payload(j._payload(), device="cpu")
    assert t.graph.metric == request.param
    return q, j, t, j.profile.cos_theta_star, {}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("W,estimate", [(1, "exact"), (4, "exact"),
                                        (4, "both")])
def test_inner_product_index_matches_jnp(unit_index, engine, W, estimate):
    """k=100, efs=200 (the retrieval example's spec) at W=1, W=4 and W=4
    with the two stages: ids, every counter and iters equal on all three
    engines."""
    q, j, t, ct, cache = unit_index
    spec = dict(k=100, efs=200, router="crouting", beam_width=W,
                estimate=estimate, metric=t.graph.metric)
    if (W, estimate) not in cache:       # one jnp run per spec
        _, jf = j_build(j.graph, JSpec(engine="jnp", **spec))
        cache[W, estimate] = jf(jnp.asarray(q), jnp.asarray(ct, jnp.float32))
    _, tf = t_build(t.graph, TSpec(engine=engine, **spec), device="cpu")
    b = tf(q, ct)
    _assert_same(cache[W, estimate], b)
    assert int(b.est_calls.sum()) > 0
    assert (b.dist_calls.numpy() < t.graph.n).all()


def test_dlrm_retrieval_example_runs_on_the_cpu():
    """examples/dlrm_retrieval_torch.py end to end at a small n_cand."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "dlrm_retrieval_torch.py")
    spec = importlib.util.spec_from_file_location("dlrm_retrieval_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--n-cand", "1500", "--n-query", "8"])
    assert out["recall"] >= 0.9
    assert 0 < out["dist_call_share"] < 1
    assert out["block_shape"] == (8, 1500)


@pytest.mark.parametrize("W,estimate", [(1, "exact"), (4, "exact"),
                                        (4, "both")])
def test_inner_product_engines_are_bit_equal(unit_index, W, estimate):
    """Under ip/cosine every engine ranks the hop loop's exact distances in
    one arithmetic (the kernels' squared L2 moved to rank space), so the
    plain engine's distances equal the kernel engines' bit for bit: a
    different formula (``1 - <q, x>``) reorders near-tied results."""
    q, _, t, ct, _ = unit_index
    spec = dict(k=100, efs=200, router="crouting", beam_width=W,
                estimate=estimate, metric=t.graph.metric)
    out = {e: t_build(t.graph, TSpec(engine=e, **spec), device="cpu")[1](
        q, ct) for e in ENGINES}
    for e in ("fused", "unfused"):
        assert torch.equal(out[e].ids, out["torch"].ids)
        assert torch.equal(out[e].dists, out["torch"].dists)
        for c in COUNTERS:
            assert torch.equal(getattr(out[e], c), getattr(out["torch"], c))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("router,estimate", [("crouting", "exact"),
                                             ("crouting", "both"),
                                             ("finger", "exact")])
def test_each_hop_step_writes_its_state_in_place(tiny, monkeypatch, engine,
                                                 router, estimate):
    """A CUDA graph of one hop iteration replays on fixed addresses, so
    ``_Hop.step`` must write every new value into the state's own tensors:
    on the CPU, where the same step runs eagerly, no state tensor is
    replaced, and the result still equals the reference's."""
    from repro_torch.core import search as S
    ds, j, t, ct = tiny
    orig = S._Hop.step
    steps = []

    def tensors(s):
        return {k: (v.data_ptr(), tuple(v.shape), v.dtype)
                for k, v in list(vars(s).items()) + list(s.extras.items())
                if isinstance(v, torch.Tensor)}

    def step(self, s, ph):
        before = tensors(s)
        orig(self, s, ph)
        steps.append(tensors(s) == before)

    monkeypatch.setattr(S._Hop, "step", step)
    spec = dict(k=10, efs=32, router=router, beam_width=4, estimate=estimate)
    a, b = _run_both(j, t, ds.queries, ct, engine, **spec)
    _assert_same(a, b)
    assert len(steps) == b.iters > 0 and all(steps)
