"""The port's router plumbing, the FINGER router and the two host baselines
of paper §5.7 (FINGER's ``finger_search`` and TOGG-KDT) against the JAX
package.

FINGER on the ``fused``, ``unfused`` and ``torch`` engines (the kernels'
plain versions on the CPU) against the JAX ``jnp`` engine on the same
graph: ids, every counter and ``finger_est_calls`` equal, distances within
rtol/atol 1e-5 (as ``test_torch_search.py``).  The companion tables equal
the reference's bit for bit (one NumPy construction, copied), the registry
carries the same names and flags, and the host baselines give the same
ids and counters as the reference's on ``hnsw_index``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routers as JR
from repro.core.finger import build_finger as j_build_finger
from repro.core.finger import finger_search as j_finger_search
from repro.core.hnsw import build_hnsw
from repro.core.ref_search import descend_hierarchy_ref as j_descend
from repro.core.search import build_search_fn as j_build
from repro.core.search import graph_device_arrays as j_arrays
from repro.core.spec import SearchSpec as JSpec
from repro.core.togg import build_togg as j_build_togg
from repro.core.togg import togg_search as j_togg_search
from repro.data.vectors import make_dataset

from repro_torch.core import routers as TR
from repro_torch.core.finger import build_finger, finger_search
from repro_torch.core.graph import GraphIndex
from repro_torch.core.ref_search import descend_hierarchy_ref
from repro_torch.core.search import build_search_fn as t_build
from repro_torch.core.search import graph_device_arrays as t_arrays
from repro_torch.core.spec import SearchSpec, SearchStats
from repro_torch.core.togg import build_togg, togg_search

COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")


def _port_graph(g):
    return GraphIndex(**{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(GraphIndex)})


@pytest.fixture(scope="module")
def tiny(small_ds, hnsw_index, hnsw_profile):
    return small_ds, hnsw_index, _port_graph(hnsw_index), \
        hnsw_profile.cos_theta_star


def _jnp_and_port(jg, tg, queries, ct, engine, **spec):
    _, jf = j_build(jg, JSpec(engine="jnp", **spec))
    a = jf(jnp.asarray(queries), jnp.asarray(ct, jnp.float32))
    _, tf = t_build(tg, SearchSpec(engine=engine, **spec), device="cpu")
    return a, tf(queries, ct)


@pytest.mark.parametrize("engine", ["fused", "unfused", "torch"])
@pytest.mark.parametrize("beam_width", [1, 4])
def test_finger_router_matches_jnp(tiny, engine, beam_width):
    ds, jg, tg, ct = tiny
    a, b = _jnp_and_port(jg, tg, ds.queries, ct, engine, efs=20,
                         router="finger", beam_width=beam_width)
    np.testing.assert_array_equal(np.asarray(a.ids), b.ids.numpy())
    np.testing.assert_allclose(np.asarray(a.dists), b.dists.numpy(),
                               rtol=1e-5, atol=1e-5)
    for c in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a, c)),
                                      getattr(b, c).numpy(), err_msg=c)
    assert int(a.iters) == b.iters
    assert set(b.extra) == {"finger_est_calls"}
    np.testing.assert_array_equal(np.asarray(a.extra["finger_est_calls"]),
                                  b.extra["finger_est_calls"].numpy())
    np.testing.assert_array_equal(b.extra["finger_est_calls"].numpy(),
                                  b.est_calls.numpy())
    assert int(b.est_calls.sum()) > 0


def test_finger_prunes_and_stats_carry_its_counter(tiny):
    ds, _, tg, ct = tiny
    _, plain = t_build(tg, SearchSpec(efs=48, router="none"), device="cpu")
    _, fing = t_build(tg, SearchSpec(efs=48, router="finger"), device="cpu")
    p, f = plain(ds.queries, ct), fing(ds.queries, ct)
    assert float(f.dist_calls.float().mean()) < float(
        p.dist_calls.float().mean())
    st = SearchStats.from_result(f, router="finger")
    assert list(st.extra) == ["finger_est_calls"]
    merged = SearchStats.merge([st, st])
    assert merged.extra["finger_est_calls"].shape == (2 * len(ds.queries),)
    summary = merged.summary()
    assert summary["finger_est_calls"] == summary["est_calls"] > 0
    assert SearchStats.from_result(p).extra == {}


def test_finger_tables_equal_the_reference_and_arrive_lazily():
    ds = make_dataset(n_base=400, n_query=2, dim=16, n_clusters=8, seed=2)
    jg = build_hnsw(ds.base, m=6, efc=24, seed=0)
    tg = _port_graph(jg)
    arrays, _ = t_build(tg, SearchSpec(efs=12, router="none"), device="cpu")
    assert "finger_edge_sig" not in arrays
    arrays2, _ = t_build(tg, SearchSpec(efs=12, router="finger"),
                         device="cpu")
    assert arrays2 is arrays
    assert set(TR.get_router("finger").companion_tables) <= set(arrays)
    ref = JR.ensure_finger_arrays(jg, j_arrays(jg))
    for key in TR.get_router("finger").companion_tables:
        want = np.asarray(ref[key])
        got = arrays[key].numpy()
        if key == "finger_edge_sig":
            assert got.dtype == np.int32 and want.dtype == np.uint32
            got = got.view(np.uint32)
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert arrays["finger_edge_sig"].shape == (tg.n + 1, tg.max_degree, 2)
    assert not arrays["finger_edge_sig"][-1].any()   # pad row: empty sigs
    # a second prepare is a no-op on the same tables
    sig = arrays["finger_edge_sig"]
    TR.ensure_finger_arrays(tg, arrays)
    assert arrays["finger_edge_sig"] is sig


def test_registry_names_and_flags_match_the_reference():
    assert TR.available_routers() == JR.available_routers()
    fields = ("prunes", "permanent", "revisit_pruned", "counts_est",
              "kernel_estimate", "extra_counters", "companion_tables")
    for name in TR.available_routers():
        a, b = JR.get_router(name), TR.get_router(name)
        assert type(a).__name__ == type(b).__name__, name
        for f in fields:
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert a.cos_theta_eff(0.25) == b.cos_theta_eff(0.25)
    assert TR.get_router("finger").r_bits == JR.get_router("finger").r_bits
    with pytest.raises(ValueError, match="already registered"):
        TR.register_router(TR.Router(name="none"))
    with pytest.raises(ValueError, match="crouting"):
        TR.get_router("bogus")


def test_unregister_and_a_custom_router_with_its_own_counter(tiny):
    ds, _, tg, ct = tiny

    @dataclasses.dataclass(frozen=True)
    class CountingRouter(TR.EdgeAngleRouter):
        def estimate_rank(self, ctx):
            est_rank, _ = super().estimate_rank(ctx)
            return est_rank, {"my_tests": ctx.try_prune.sum(
                1, dtype=torch.int32)}

    TR.register_router(CountingRouter(name="_test_counting", prunes=True,
                                      extra_counters=("my_tests",)))
    try:
        _, twin = t_build(tg, SearchSpec(efs=32, router="crouting",
                                         engine="torch"), device="cpu")
        _, mine = t_build(tg, SearchSpec(efs=32, router="_test_counting",
                                         engine="torch"), device="cpu")
        a, b = twin(ds.queries, ct), mine(ds.queries, ct)
        np.testing.assert_array_equal(a.ids.numpy(), b.ids.numpy())
        np.testing.assert_array_equal(a.dist_calls.numpy(),
                                      b.dist_calls.numpy())
        np.testing.assert_array_equal(b.extra["my_tests"].numpy(),
                                      a.est_calls.numpy())
    finally:
        TR.unregister_router("_test_counting")
    assert "_test_counting" not in TR.available_routers()
    TR.unregister_router("_test_counting")        # absent: a no-op


def test_extra_counters_are_zero_on_padded_lanes(tiny):
    from repro_torch.core.search import _search_batch
    ds, _, tg, ct = tiny
    arrays = TR.ensure_finger_arrays(tg, t_arrays(tg, "cpu"))
    q = ds.queries[:8].copy()
    q[5:] = 0.0
    res = _search_batch(arrays, torch.as_tensor(q), ct,
                        SearchSpec(efs=24, router="finger", beam_width=4,
                                   use_hierarchy=False),
                        valid=torch.as_tensor(np.arange(8) < 5))
    assert (res.extra["finger_est_calls"][5:] == 0).all()
    assert int(res.extra["finger_est_calls"][:5].sum()) > 0


def test_swar_popcount_matches_bin_count():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64),
        np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1, 0x55555555, 0xAAAAAAAA,
                    0x0F0F0F0F, 0x80000001], np.uint64)])
    got = TR.popcount32(torch.as_tensor(vals.astype(np.int64))).numpy()
    want = np.asarray([bin(int(v)).count("1") for v in vals])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("baseline", ["finger", "togg"])
def test_host_baselines_match_the_reference(small_ds, hnsw_index, baseline):
    """``finger_search`` and ``togg_search`` as ``test_strategies.py`` runs
    them: ids, dist_calls, est_calls, hops and the pruned set equal."""
    tg = _port_graph(hnsw_index)
    if baseline == "finger":
        ji, ti = j_build_finger(hnsw_index), build_finger(tg)
        np.testing.assert_array_equal(ji.edge_sig, ti.edge_sig)
        assert ji.extra_bytes() == ti.extra_bytes()
        jrun, trun = j_finger_search, finger_search
        queries = small_ds.queries
    else:
        ji, ti = j_build_togg(hnsw_index), build_togg(tg)
        assert ji.extra_bytes() == ti.extra_bytes()
        jrun, trun = j_togg_search, togg_search
        queries = small_ds.queries[:20]
    for q in queries:
        e = j_descend(hnsw_index, q)
        assert e == descend_hierarchy_ref(tg, q)
        a_ids, a_d, a_st = jrun(ji, q, e[0], efs=48)
        b_ids, b_d, b_st = trun(ti, q, e[0], efs=48)
        np.testing.assert_array_equal(a_ids, b_ids)
        np.testing.assert_array_equal(a_d, b_d)
        for c in ("dist_calls", "est_calls", "hops"):
            assert getattr(a_st, c) == getattr(b_st, c), c
        assert a_st.pruned_ids == b_st.pruned_ids


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["fused", "unfused"])
@pytest.mark.parametrize("beam_width", [1, 4])
def test_finger_on_the_kernel_engines_matches_torch_on_gpu(tiny, cuda, engine,
                                                           beam_width):
    """On the card the FINGER hook is the same PyTorch code under every
    engine, so the kernel engines must equal the torch engine exactly."""
    ds, _, tg, ct = tiny
    spec = dict(efs=20, router="finger", beam_width=beam_width)
    _, tf = t_build(tg, SearchSpec(engine="torch", **spec), device=cuda)
    _, kf = t_build(tg, SearchSpec(engine=engine, **spec), device=cuda)
    a, b = tf(ds.queries, ct), kf(ds.queries, ct)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    for c in COUNTERS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c
    assert torch.equal(a.extra["finger_est_calls"],
                       b.extra["finger_est_calls"])
    assert a.iters == b.iters and int(b.est_calls.sum()) > 0
