"""The port's DLRM inference against the JAX package's, with the JAX
parameters carried over by ``params_from_jax``.

Smoke config (``vocab_cap=1000``): the same numpy batches go through
``repro.models.dlrm`` and ``repro_torch.models.dlrm`` on the CPU.  Logits
and scores agree within rtol/atol 1e-5 (fp32 throughout; the two matrix
libraries sum in different orders), retrieval ids exactly.  Training
(``dlrm_loss``, its gradients and one ``make_dlrm_train_step`` with AdamW
at lr 1e-3 from step 1: new parameters and both moments): rtol 1e-4, atol
1e-6 elementwise, except the new parameters' atol, which is widened by
twice the reference's own spread on them: their largest absolute change
when the reference's parameters are perturbed by 2^-23 relative noise
(about one fp32 rounding), over three noise seeds, capped at
STEP_SPREAD_CAP = 5e-5 (a twentieth of the step's lr), so no atol passes
1.01e-4.  The first Adam step moves a weight by lr * g / (|g| + 1e-8);
thousands of this model's gradients lie near 1e-8 (dead ReLUs, lognormal
inputs), where a rounding-level change of g moves that by percents of lr.
Measured on an x86 CPU with jax 0.9.0 (the reference jitted): the
gradients agree within 7.8e-8 absolute; the spread on the new parameters
is 3.1e-5 (B=64) and 4.5e-5 (B=7), and the port's largest error there
3.3e-5 and 2.4e-5.  The donated step equals the functional one bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import dlrm_batch as j_dlrm_batch
from repro.models import dlrm as J
from repro.train import optimizer as jopt

from repro_torch.configs import get_arch, list_archs
from repro_torch.data.synthetic import dlrm_batch
from repro_torch.models import dlrm as T
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_flatten_with_path, value_and_grad

TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_SPREAD_CAP = 5e-5
OCFG = dict(lr=1e-3, warmup_steps=1)


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
                            "schnet", "gat-cora", "egnn", "gin-tu",
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


def _train_batch(cfg, B, seed):
    b = dlrm_batch(cfg.n_dense, cfg.table_rows(), B, seed)
    ref = j_dlrm_batch(cfg.n_dense, cfg.table_rows(), B, seed)
    assert all(np.array_equal(b[k], ref[k]) for k in ref)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got_tree, want_tree, atol=TRAIN_TOL["atol"]):
    got = tree_flatten_with_path(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=path, rtol=TRAIN_TOL["rtol"],
                                   atol=atol)


@pytest.mark.parametrize("B,seed", [(64, 0), (7, 1)])
def test_loss_gradients_and_train_step_match_jax(carried, B, seed):
    jcfg, jp, cfg, tp = carried
    jb, tb = _train_batch(cfg, B, seed)
    jo, to = jopt.AdamWConfig(**OCFG), topt.AdamWConfig(**OCFG)

    @jax.jit
    def run(params):
        loss, grads = jax.value_and_grad(J.dlrm_loss)(params, jb, jcfg)
        new, state, metrics = J.make_dlrm_train_step(jcfg, jo)(
            params, jopt.adamw_init(params, jo), jb)
        return loss, grads, new, state, metrics

    jl, jg, jnew, js, jm = run(jp)
    spread = 0.0
    for s in range(3):
        rng = np.random.default_rng(100 + s)
        moved = run(jax.tree_util.tree_map(
            lambda a: a * (1 + jnp.asarray(rng.normal(size=a.shape),
                                           jnp.float32) * 2.0 ** -23), jp))[2]
        spread = max(spread, max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(jax.tree_util.tree_leaves(moved),
                            jax.tree_util.tree_leaves(jnew))))
    tl, tg = value_and_grad(T.dlrm_loss, tp, tb, cfg)
    _close(tl, jl)
    _close(tg, jg)
    tnew, ts, tm = T.make_dlrm_train_step(cfg, to)(
        tp, topt.adamw_init(tp, to), tb)
    _close(tm["loss"], jm["loss"])
    _close(tm["grad_norm"], jm["grad_norm"])
    _close(tnew, jnew,
           atol=TRAIN_TOL["atol"] + 2 * min(spread, STEP_SPREAD_CAP))
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


def test_donated_train_step_equals_the_functional_one(carried):
    """Two steps each way from the same start: the donated form writes
    into the tensors it was given and returns them, bit for bit the
    functional form's values."""
    _, _, cfg, tp = carried
    to = topt.AdamWConfig(**OCFG)
    fn = T.make_dlrm_train_step(cfg, to)
    dn = T.make_dlrm_train_step(cfg, to, donate=True)
    p_f, s_f = tp, topt.adamw_init(tp, to)
    p_d = jax.tree_util.tree_map(torch.clone, tp)
    s_d = topt.adamw_init(p_d, to)
    first = p_d["tables"][0]
    for seed in (2, 3):
        _, tb = _train_batch(cfg, 32, seed)
        p_f, s_f, m_f = fn(p_f, s_f, tb)
        p_d, s_d, m_d = dn(p_d, s_d, tb)
        assert torch.equal(m_f["loss"], m_d["loss"])
    assert p_d["tables"][0] is first
    for a, b in zip(*(jax.tree_util.tree_leaves(t)
                      for t in ((p_f, s_f.mu, s_f.nu), (p_d, s_d.mu,
                                                        s_d.nu)))):
        assert torch.equal(a, b)
    assert int(s_d.step) == 2


# --- the row-sharded lookup ---------------------------------------------------
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_row_sharded_lookup_is_bit_equal_to_the_unsharded(carried, slots):
    """``shard_tables`` over S slots (the smoke tables' padded rows all
    divide 4, so each splits into S row blocks; an added 5-row table stays
    whole at S = 2 and 4) and ``table_parallel_lookup``: the embeddings
    and every table's gradient bit-equal to the lookup of the whole
    tables, with ids repeated many times a batch."""
    from repro_torch.launch.mesh import make_local_mesh
    _, _, cfg, tp = carried
    tables = [t.clone() for t in tp["tables"]] + [torch.randn(5, 128)]
    rng = np.random.default_rng(slots)
    ids = torch.as_tensor(np.stack(
        [rng.integers(0, t.shape[0], 300) for t in tables], 1))
    g = torch.as_tensor(rng.standard_normal((len(tables), 300, 128))
                        .astype(np.float32))
    whole = [t.clone().requires_grad_() for t in tables]
    want = T.table_parallel_lookup(whole, ids)
    torch.autograd.backward(want, list(g))
    placed = T.shard_tables([t.clone() for t in tables],
                            make_local_mesh(slots, device="cpu"))
    leaves = [tuple(b.detach().requires_grad_() for b in t)
              if isinstance(t, tuple) else t.detach().requires_grad_()
              for t in placed]
    assert isinstance(leaves[0], tuple) and len(leaves[0]) == slots
    assert isinstance(leaves[-1], tuple) == (slots == 1)
    got = T.table_parallel_lookup(leaves, ids)
    torch.autograd.backward(got, list(g))
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    for i, (leaf, ref) in enumerate(zip(leaves, whole)):
        grad = (torch.cat([b.grad for b in leaf]) if isinstance(leaf, tuple)
                else leaf.grad)
        assert torch.equal(grad, ref.grad), i


def test_row_sharded_train_step_equals_the_unsharded(carried):
    """One AdamW step on row-sharded parameters: the loss and every
    updated row bit-equal to the step on whole tables."""
    from repro_torch.launch.mesh import make_local_mesh
    _, _, cfg, tp = carried
    to = topt.AdamWConfig(**OCFG)
    step = T.make_dlrm_train_step(cfg, to)
    _, tb = _train_batch(cfg, 64, 5)
    p1, _, m1 = step(tp, topt.adamw_init(tp, to), tb)
    sharded = {**tp, "tables": T.shard_tables(
        tp["tables"], make_local_mesh(4, device="cpu"))}
    p4, _, m4 = step(sharded, topt.adamw_init(sharded, to), tb)
    assert torch.equal(m1["loss"], m4["loss"])
    for a, b in zip(p1["tables"], p4["tables"]):
        assert torch.equal(a, torch.cat(b) if isinstance(b, tuple) else b)
