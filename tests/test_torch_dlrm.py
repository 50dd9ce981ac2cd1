"""The port's DLRM inference against the JAX package's, with the JAX
parameters carried over by ``params_from_jax``.

Smoke config (``vocab_cap=1000``): the same numpy batches go through
``repro.models.dlrm`` and ``repro_torch.models.dlrm`` on the CPU.  Logits
and scores agree within rtol/atol 1e-5 (fp32 throughout; the two matrix
libraries sum in different orders), retrieval ids exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import dlrm as J

from repro_torch.configs import get_arch, list_archs
from repro_torch.models import dlrm as T


@pytest.fixture(scope="module")
def carried():
    jcfg = J.DlrmConfig(name="dlrm-smoke", vocab_cap=1000)
    jp = J.init_dlrm(jcfg, jax.random.PRNGKey(0))
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, T.DlrmConfig(name="dlrm-smoke", vocab_cap=1000), tp


def _batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    vocab = [min(v, cfg.vocab_cap) for v in cfg.vocab_sizes]
    sparse = np.stack([rng.integers(0, v, size=B) for v in vocab],
                      axis=1).astype(np.int32)
    return ({"dense": jnp.asarray(dense), "sparse_ids": jnp.asarray(sparse)},
            {"dense": torch.as_tensor(dense),
             "sparse_ids": torch.as_tensor(sparse)})


def test_params_carry_over_in_the_jax_layout(carried):
    jcfg, jp, cfg, tp = carried
    assert len(tp["tables"]) == 26
    for jt, tt in zip(jp["tables"], tp["tables"]):
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    for k in ("bot", "top"):
        assert [tuple(layer["w"].shape) for layer in tp[k]] == \
            [tuple(layer["w"].shape) for layer in jp[k]]
    assert tuple(tp["top"][0]["w"].shape) == (cfg.interaction_dim(), 1024)
    n = sum(t.numel() for t in tp["tables"]) + sum(
        layer["w"].numel() + layer["b"].numel() for k in ("bot", "top")
        for layer in tp[k])
    assert n == cfg.param_count()


@pytest.mark.parametrize("B,seed", [(16, 0), (5, 1)])
def test_forward_and_serve_step_match_jax(carried, B, seed):
    jcfg, jp, cfg, tp = carried
    jb, tb = _batch(cfg, B, seed)
    np.testing.assert_allclose(T.dlrm_forward(tp, tb, cfg).numpy(),
                               np.asarray(J.dlrm_forward(jp, jb, jcfg)),
                               rtol=1e-5, atol=1e-5)
    ts = T.make_dlrm_serve_step(cfg)(tp, tb)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (B,)
    assert ((ts > 0) & (ts < 1)).all()
    np.testing.assert_allclose(
        ts.numpy(), np.asarray(J.make_dlrm_serve_step(jcfg)(jp, jb)),
        rtol=1e-5, atol=1e-5)


def test_retrieval_step_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(4, 128)).astype(np.float32)
    c = rng.normal(size=(5000, 128)).astype(np.float32)
    js, ji = J.make_retrieval_step(J.DlrmConfig(), k=100)(jnp.asarray(q),
                                                          jnp.asarray(c))
    ts, ti = T.make_retrieval_step(T.DlrmConfig(), k=100)(
        torch.as_tensor(q), torch.as_tensor(c))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("n_ids,vocab,seed", [(1, 2, 0), (17, 9, 1),
                                              (40, 20, 2)])
def test_embedding_bag_matches_jax(combiner, n_ids, vocab, seed):
    """Multi-hot bags (as in tests/test_property.py), empty bags too."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, 8)).astype(np.float32)
    ids = rng.integers(0, vocab, size=n_ids).astype(np.int32)
    bags = np.sort(rng.integers(0, 4, size=n_ids)).astype(np.int32)
    exp = J.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                          jnp.asarray(bags), 5, combiner=combiner)
    got = T.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                          torch.as_tensor(bags), 5, combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-6)
    assert not got[4].any()                 # bag 4 is always empty


def test_dot_interaction_matches_jax():
    v = np.random.default_rng(3).normal(size=(6, 27, 16)).astype(np.float32)
    got = T.dot_interaction(torch.as_tensor(v))
    assert tuple(got.shape) == (6, 27 * 26 // 2)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(J.dot_interaction(jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [0, 1000, 4_000_000])
def test_table_rows_and_param_count_match_jax(cap):
    jc, tc = J.DlrmConfig(vocab_cap=cap), T.DlrmConfig(vocab_cap=cap)
    assert tc.table_rows() == jc.table_rows()
    assert tc.param_count() == jc.param_count()
    assert list(T.CRITEO_VOCAB_SIZES) == list(J.CRITEO_VOCAB_SIZES)


def test_configs_name_the_retrieval_shapes():
    spec = get_arch("dlrm-mlperf")
    assert spec.model_cfg == T.DlrmConfig()
    assert spec.smoke_cfg.vocab_cap == 1000
    assert spec.shape("retrieval_cand").dims == dict(batch=1,
                                                     n_candidates=1_000_000)
    assert spec.shape("serve_p99").dims == dict(batch=512)
    assert list_archs() == ["granite-8b", "phi4-mini-3.8b", "qwen1.5-4b",
                            "granite-moe-1b-a400m", "arctic-480b",
                            "dlrm-mlperf"]
    assert get_arch("crouting-anns").model_cfg.m == 32
    with pytest.raises(KeyError):
        spec.shape("decode_32k")


def test_init_dlrm_runs_on_the_gpu_unless_asked_for_the_cpu():
    cfg = T.DlrmConfig(name="dlrm-smoke", vocab_cap=1000)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.init_dlrm(cfg, torch.Generator())
    p = T.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [t.shape[0] for t in p["tables"]] == cfg.table_rows()
    _, tb = _batch(cfg, 8, 4)
    s = T.make_dlrm_serve_step(cfg)(p, tb)
    assert torch.isfinite(s).all() and ((s > 0) & (s < 1)).all()
    q = T.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p["tables"], q["tables"]))
