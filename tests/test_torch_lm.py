"""The port's LM family (``repro_torch.models.layers`` / ``transformer`` and
``repro_torch.configs``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both; weights are made by the JAX
package's ``init_params`` and carried over with ``params_from_numpy``.
Tolerances (fp32 throughout):
  * layer functions and their gradients: rtol = atol = 1e-4 elementwise
    (the reference's own decode test's tolerance);
  * a whole smoke model's hidden states, loss, logits and KV caches: rtol =
    atol = 1e-4, and its loss gradients: each leaf within 1e-4 in relative
    Frobenius norm; each widened by twice the reference's own spread on
    that output, measured here: its change when the reference's embedding
    table is perturbed by 2^-23 relative noise (about one fp32 rounding).
    These random-init models are ill-conditioned (the reference's init
    draws stacked layer weights with fan_in = n_layers: std 0.71 at two
    layers); a 1e-6 perturbation moves granite-moe-smoke's reference
    gradients by 7e-4, so the two packages' fp32 rounding alone moves them
    past 1e-4 there.  The spread is capped, so that a more chaotic
    reference fails instead of loosening the limit: SPREAD_CAP (5e-4 abs on
    an array, 5e-4 relative on a gradient leaf), so no limit passes 1.1e-3.
    Measured on x86 CPUs with jax 0.9.0: the largest array spread is 1.8e-4
    (granite-moe's prefill v; hidden states 2.6e-5 to 8.2e-5, logits
    3e-6 to 3.2e-5, the loss 0 or 4.8e-7), the largest gradient spread
    6.3e-5 (phi4's embed); the port's largest gradient error is 1.6e-4
    (granite-moe's wk) and hidden-state error 1.6e-4.  The port's decode
    against its own forward: 1e-4;
  * ``moe_dispatch_indices``: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.configs import get_arch, list_archs
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_flatten_with_path, value_and_grad

LM_ARCHS = ["granite-8b", "phi4-mini-3.8b", "qwen1.5-4b",
            "granite-moe-1b-a400m", "arctic-480b"]
TOL = dict(rtol=1e-4, atol=1e-4)
SPREAD_CAP = 5e-4    # the most a reference spread may widen a limit by, /2
S_TEST = 48          # pads to 64 under the smoke blocks (16, 32)
T_CACHE = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().numpy()



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are small: one intra-op thread each, so that a
    worker sharing the machine with others is not slowed by thread
    oversubscription (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def test_registry_lists_the_lm_archs_in_the_reference_order():
    assert list_archs() == LM_ARCHS + ["schnet", "gat-cora", "egnn",
                                       "gin-tu", "dlrm-mlperf"]
    assert list_archs() == j_list_archs()
    assert list_archs(include_anns=True)[-1] == "crouting-anns"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_equals_the_reference(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family, j.source)
    assert [dataclasses.astuple(s) for s in t.shapes] == \
        [dataclasses.astuple(s) for s in j.shapes]
    for jc, tc in ((j.model_cfg, t.model_cfg), (j.smoke_cfg, t.smoke_cfg)):
        # the reference's `unroll_layers` only unrolls its layer scan for
        # XLA's cost analysis; the port has no scan, so it has no such field
        ref = dataclasses.asdict(jc)
        ref.pop("unroll_layers")
        assert dataclasses.asdict(tc) == ref
        assert (tc.dh, tc.padded_vocab, tc.param_count(),
                tc.active_param_count()) == \
            (jc.dh, jc.padded_vocab, jc.param_count(),
             jc.active_param_count())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_has_the_reference_layout(arch):
    jc, tc = j_get_arch(arch).smoke_cfg, get_arch(arch).smoke_cfg
    shapes = jax.eval_shape(lambda k: JT.init_params(jc, k),
                            jax.random.PRNGKey(0))
    tp = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    j_flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    t_flat = tree_flatten_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in j_flat] == \
        [p for p, _ in t_flat]
    assert [(tuple(s.shape), str(s.dtype)) for _, s in j_flat] == \
        [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
         for _, x in t_flat]
    # the reference's distributions: norms 1, biases 0, N(0, 1/fan_in)
    assert torch.all(tp["final_norm"] == 1)
    w = tp["layers"]["wq"]
    assert abs(float(w.std()) - 1 / np.sqrt(w.shape[0])) < 0.05


def test_init_params_runs_on_the_gpu_unless_asked_for_the_cpu():
    cfg = get_arch("granite-8b").smoke_cfg
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TT.init_params(cfg, torch.Generator())
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for _, t in tree_flatten_with_path(p))


def test_params_carry_over_both_ways():
    jc = j_get_arch("qwen1.5-4b").smoke_cfg
    jp = jax.tree_util.tree_map(np.asarray,
                                JT.init_params(jc, jax.random.PRNGKey(3)))
    back = TT.params_to_numpy(TT.params_from_numpy(jp, "cpu"))
    for (pj, a), (pt, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                tree_flatten_with_path(back)):
        assert jax.tree_util.keystr(pj) == pt
        np.testing.assert_array_equal(a, b)
    bf = {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))}
    t = TT.params_from_numpy(bf, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(TT.params_to_numpy({"w": t})["w"], bf["w"])


# --------------------------------------------------------------------------
# layer functions
# --------------------------------------------------------------------------
def test_rms_norm_rope_swiglu_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32) * 3
    g = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(_n(TL.rms_norm(_t(x), _t(g))),
                               np.asarray(JL.rms_norm(x, g)), **TOL)
    pos = np.broadcast_to(np.arange(100, 109), (2, 9))
    for theta in (10000.0, 1e6):
        np.testing.assert_allclose(
            _n(TL.apply_rope(_t(x), _t(pos), theta)),
            np.asarray(JL.apply_rope(x, pos, theta)), **TOL)
    np.testing.assert_allclose(_n(TL.rope_freqs(16)),
                               np.asarray(JL.rope_freqs(16)), rtol=1e-6)
    h = rng.normal(size=(5, 16)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(_n(TL.swiglu(_t(h), *map(_t, ws))),
                               np.asarray(JL.swiglu(h, *ws)), **TOL)


def test_shard_hint_is_the_identity_without_a_mesh():
    x = torch.ones(2, 3, 4)
    assert TL.shard_hint(x, TL.BATCH_AXES, None, "model") is x
    with pytest.raises(AssertionError):
        TL.shard_hint(x, None)


ATTN_CASES = [  # (B, S, H, Hkv, dh, block_q, block_k)
    (2, 64, 4, 2, 16, 16, 32),    # G = 2, no pad
    (2, 40, 4, 1, 8, 16, 32),     # G = 4, pads 40 -> 64
    (1, 37, 3, 3, 16, 8, 16),     # G = 1, pads 37 -> 48
    (2, 20, 2, 2, 8, 256, 1024),  # blocks larger than S: one tile
]


def _attn_inputs(B, S, H, Hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32) * 2
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32) * 2
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    do = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", ATTN_CASES)
def test_blockwise_attention_and_its_backward_match_the_custom_vjp(case):
    B, S, H, Hkv, dh, bq, bk = case
    q, k, v, do = _attn_inputs(B, S, H, Hkv, dh)
    jo, vjp = jax.vjp(lambda a, b, c: JL.blockwise_causal_attention(
        a, b, c, block_q=bq, block_k=bk), q, k, v)
    jg = vjp(jnp.asarray(do))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    to = TL.blockwise_causal_attention(*ts, block_q=bq, block_k=bk)
    tg = torch.autograd.grad(to, ts, _t(do))
    np.testing.assert_allclose(_n(to), np.asarray(jo), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)


def test_flash_forward_core_returns_the_reference_lse():
    q, k, v, _ = _attn_inputs(2, 64, 4, 4, 16, seed=3)
    jo, jlse = JL._fa_fwd_core(q, k, v, 16, 32)
    to, tlse = TL._fa_fwd_core(_t(q), _t(k), _t(v), 16, 32)
    np.testing.assert_allclose(_n(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(_n(tlse), np.asarray(jlse), **TOL)


def test_blockwise_attention_equals_a_naive_masked_softmax():
    q, k, v, do = _attn_inputs(2, 40, 4, 2, 8, seed=4)
    ts = [_t(a).double().requires_grad_(True) for a in (q, k, v)]
    kk, vv = (x.repeat_interleave(2, dim=2) for x in ts[1:])
    s = torch.einsum("bshd,bthd->bhst", ts[0], kk) / np.sqrt(8)
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      -np.inf)
    ref = torch.einsum("bhst,bthd->bshd", s.softmax(-1), vv)
    ref_g = torch.autograd.grad(ref, ts, _t(do).double())
    fs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = TL.blockwise_causal_attention(*fs, block_q=16, block_k=32)
    got_g = torch.autograd.grad(out, fs, _t(do))
    np.testing.assert_allclose(_n(out), _n(ref), **TOL)
    for a, b in zip(got_g, ref_g):
        np.testing.assert_allclose(_n(a), _n(b), **TOL)


def test_decode_attention_matches_the_reference():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 1, 6, 8)).astype(np.float32)
    kc = rng.normal(size=(2, 12, 3, 8)).astype(np.float32)
    vc = rng.normal(size=(2, 12, 3, 8)).astype(np.float32)
    mask = np.arange(12)[None, :] <= np.array([[4], [11]])
    np.testing.assert_allclose(
        _n(TL.decode_attention(_t(q), _t(kc), _t(vc), _t(mask))),
        np.asarray(JL.decode_attention(q, kc, vc, mask)), **TOL)


@pytest.mark.parametrize("T,E,k,cap", [(64, 8, 2, 20), (96, 4, 2, 8),
                                       (1024, 32, 8, 320)])
def test_moe_dispatch_indices_equal_the_reference_exactly(T, E, k, cap):
    rng = np.random.default_rng(T)
    top_idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]
                       ).astype(np.int32)
    j = JL.moe_dispatch_indices(jnp.asarray(top_idx), E, cap)
    t = TL.moe_dispatch_indices(_t(top_idx), E, cap)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    dest, keep, src = (_n(x) for x in t)
    assert keep.mean() < 1 or cap * E >= T * k
    for tok, slot in zip(*np.nonzero(keep)):
        assert src[dest[tok, slot]] == tok


@pytest.mark.parametrize("dense_residual", [False, True])
def test_moe_ffn_and_its_gradients_match_the_reference(dense_residual):
    D, F, E, k = 32, 48, 8, 2
    moe = dict(n_experts=E, top_k=k, dense_residual=dense_residual)
    base = dict(name="m", n_layers=1, d_model=D, n_heads=2, n_kv_heads=2,
                d_ff=F, vocab=64, dtype="float32")
    jc = JT.LMConfig(**base, moe=JT.MoeSpec(**moe))
    tc = TT.LMConfig(**base, moe=TT.MoeSpec(**moe))
    rng = np.random.default_rng(7)
    lp = {"gate": rng.normal(size=(D, E)) * 0.5,
          "we_gate": rng.normal(size=(E, D, F)) * 0.2,
          "we_up": rng.normal(size=(E, D, F)) * 0.2,
          "we_down": rng.normal(size=(E, F, D)) * 0.2}
    if dense_residual:
        lp.update(wr_gate=rng.normal(size=(D, F)) * 0.2,
                  wr_up=rng.normal(size=(D, F)) * 0.2,
                  wr_down=rng.normal(size=(F, D)) * 0.2)
    lp = {n: a.astype(np.float32) for n, a in sorted(lp.items())}
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    cot = rng.normal(size=(2, 24, D)).astype(np.float32)
    jy, vjp = jax.vjp(lambda xx, p: JT._ffn(xx, p, jc), x, lp)
    jgx, jgp = vjp(jnp.asarray(cot))
    tx = _t(x).requires_grad_(True)
    tp = {n: _t(a).requires_grad_(True) for n, a in lp.items()}
    ty = TT._ffn(tx, tp, tc)
    grads = torch.autograd.grad(ty, [tx, *tp.values()], _t(cot))
    np.testing.assert_allclose(_n(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_n(grads[0]), np.asarray(jgx), **TOL)
    for n, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(_n(g), np.asarray(jgp[n]), **TOL,
                                   err_msg=n)


def test_moe_combine_equals_a_loop_over_token_choices():
    """``moe_layer``'s combine against a plain loop over (token, choice)
    on the layer's own expert outputs, every row bit for bit; a capacity
    of 8 for 64 x 2 choices over 4 experts drops some, and a dropped
    choice adds nothing.  Against a per-token SwiGLU of the kept choices
    within rtol = atol = 1e-5 (another summation order)."""
    T, D, Fd, E, k = 64, 16, 24, 4, 2
    rng = np.random.default_rng(11)
    x, gate = (_t(rng.normal(size=s).astype(np.float32))
               for s in ((T, D), (D, E)))
    wg, wu = (_t(rng.normal(size=(E, D, Fd)).astype(np.float32) * 0.3)
              for _ in range(2))
    wd = _t(rng.normal(size=(E, Fd, D)).astype(np.float32) * 0.3)
    cfg = TL.MoeConfig(n_experts=E, top_k=k, capacity_factor=0.25)
    y = TL.moe_layer(x, gate, wg, wu, wd, cfg)

    cap = max(8, int(cfg.capacity_factor * k * T / E))
    top_val, top_idx = torch.topk(x @ gate, k, dim=-1)
    probs = torch.softmax(top_val, dim=-1)
    dest, keep, src = TL.moe_dispatch_indices(top_idx, E, cap)
    assert 0 < int(keep.sum()) < T * k
    xe = torch.cat([x, x.new_zeros(1, D)])[src].reshape(E, cap, D)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe, wg)) \
        * torch.einsum("ecd,edf->ecf", xe, wu)
    ye = torch.einsum("ecf,efd->ecd", h, wd).reshape(E * cap, D)
    loop = torch.zeros(T, D)
    for t in range(T):
        acc = None
        for j in range(k):
            row = (ye[dest[t, j]] * probs[t, j] if keep[t, j]
                   else torch.zeros(D))
            acc = row if acc is None else acc + row
        loop[t] = acc
    assert torch.equal(y, loop)

    want = torch.zeros(T, D)
    for t in range(T):
        for j in range(k):
            if keep[t, j]:
                e = int(top_idx[t, j])
                hh = torch.nn.functional.silu(x[t] @ wg[e]) * (x[t] @ wu[e])
                want[t] += probs[t, j] * (hh @ wd[e])
    np.testing.assert_allclose(_n(y), _n(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# whole models: the five smoke configs
# --------------------------------------------------------------------------
class _Reference:
    """The JAX package's outputs for one smoke config, computed once, and
    their spread: the same outputs with the embedding table perturbed by
    2^-23 relative noise (max abs change of each array; relative Frobenius
    change of each gradient leaf)."""

    def __init__(self, arch):
        jc = self.jc = j_get_arch(arch).smoke_cfg
        self.tc = get_arch(arch).smoke_cfg
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        self.np_params = jax.tree_util.tree_map(np.asarray, jp)
        rng = np.random.default_rng(11)
        self.tokens = rng.integers(0, jc.vocab, size=(2, S_TEST + 2)
                                   ).astype(np.int32)
        self.batch = {"tokens": self.tokens[:, :S_TEST],
                      "labels": self.tokens[:, 1:S_TEST + 1]}
        self.fns = (jax.jit(JT.forward, static_argnums=2),
                    jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=2),
                    jax.jit(JT.make_prefill_step(jc)),
                    jax.jit(JT.make_serve_step(jc)))
        self.out = self._run(jp)
        e = self.np_params["embed"]
        noise = np.random.default_rng(12).normal(size=e.shape)
        moved = self._run(dict(jp, embed=jnp.asarray(
            (e * (1 + 2.0 ** -23 * noise)).astype(np.float32))))
        self.spread = {n: float(np.abs(self.out[n] - moved[n]).max())
                       for n in self.out if n != "grads"}
        self.spread["grads"] = {
            p: float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))
            for (p, a), (_, b) in zip(
                tree_flatten_with_path(self.out["grads"]),
                tree_flatten_with_path(moved["grads"]))}

    def _run(self, jp):
        forward, grad_fn, prefill, serve = self.fns
        toks, S = self.tokens, S_TEST
        loss, grads = grad_fn(jp, self.batch, self.jc)
        logits, cache = prefill(jp, toks[:, :S])
        padded = {n: jnp.pad(c, ((0, 0), (0, 0), (0, T_CACHE - S), (0, 0),
                                 (0, 0))) for n, c in cache.items()}
        d_logits, d_cache = serve(jp, padded, toks[:, S:S + 1],
                                  jnp.asarray(S, jnp.int32))
        out = {"hidden": forward(jp, toks[:, :S], self.jc), "loss": loss,
               "prefill_logits": logits, "prefill_k": cache["k"],
               "prefill_v": cache["v"], "decode_logits": d_logits,
               "decode_k": d_cache["k"], "decode_v": d_cache["v"]}
        out = {n: np.asarray(a) for n, a in out.items()}
        out["grads"] = jax.tree_util.tree_map(np.asarray, grads)
        return out

    def check(self, name, got):
        """rtol = atol = 1e-4, atol widened by twice the reference's own
        spread on this output (at most SPREAD_CAP)."""
        assert self.spread[name] <= SPREAD_CAP, (name, self.spread[name])
        np.testing.assert_allclose(
            _n(got) if isinstance(got, torch.Tensor) else got,
            self.out[name], rtol=1e-4, atol=1e-4 + 2 * self.spread[name],
            err_msg=name)


_REFS = {}


@pytest.fixture(scope="module")
def reference():
    def get(arch):
        if arch not in _REFS:
            _REFS[arch] = _Reference(arch)
        return _REFS[arch]
    return get


PARTS = ["forward", "loss_and_grads", "prefill", "decode"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reference_spread_stays_under_its_cap(reference, arch):
    """Every spread that widens a whole-model limit is at most SPREAD_CAP,
    and the spreads are shown (``-rA``) so a reader sees each limit."""
    r = reference(arch)
    spreads = dict(r.spread, grads=max(r.spread["grads"].values()))
    print(arch, {n: f"{v:.3g}" for n, v in spreads.items()})
    assert spreads["loss"] <= 1e-5, spreads
    assert max(spreads.values()) <= SPREAD_CAP, spreads


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_model_matches_the_reference(reference, arch, part):
    r = reference(arch)
    tp = TT.params_from_numpy(r.np_params, "cpu")
    toks = _t(r.tokens)
    if part == "forward":
        with torch.no_grad():
            r.check("hidden", TT.forward(tp, toks[:, :S_TEST], r.tc))
    elif part == "loss_and_grads":
        batch = {n: _t(a) for n, a in r.batch.items()}
        loss, grads = value_and_grad(TT.loss_fn, tp, batch, r.tc)
        r.check("loss", float(loss))
        ref = dict(tree_flatten_with_path(r.out["grads"]))
        for path, g in tree_flatten_with_path(grads):
            err = np.linalg.norm(_n(g) - ref[path]) / np.linalg.norm(ref[path])
            spread = r.spread["grads"][path]
            assert spread <= SPREAD_CAP, (path, spread)
            assert err <= 1e-4 + 2 * spread, (path, err, spread)
    elif part == "prefill":
        logits, cache = TT.make_prefill_step(r.tc)(tp, toks[:, :S_TEST])
        assert logits.shape == (2, r.tc.vocab)
        r.check("prefill_logits", logits)
        r.check("prefill_k", cache["k"])
        r.check("prefill_v", cache["v"])
    else:
        cache = {n: _t(np.pad(r.out[f"prefill_{n}"],
                              ((0, 0), (0, 0), (0, T_CACHE - S_TEST),
                               (0, 0), (0, 0)))) for n in ("k", "v")}
        logits, out = TT.make_serve_step(r.tc)(
            tp, cache, toks[:, S_TEST:S_TEST + 1], S_TEST)
        assert out["k"] is cache["k"]          # written in place
        r.check("decode_logits", logits)
        r.check("decode_k", out["k"])
        r.check("decode_v", out["v"])
        # and the port's own decode equals its forward at that position
        with torch.no_grad():
            h = TT.forward(tp, toks[:, :S_TEST + 1], r.tc)
        ref = (h[:, S_TEST] @ tp["lm_head"]).float()[:, :r.tc.vocab]
        np.testing.assert_allclose(_n(logits), _n(ref), **TOL)


def _batch_row_cosines(a, b):
    """Cosine of each batch row of a and b (axis 0), in float64."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) \
        / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_model_in_bf16_matches_the_reference(arch):
    """The smoke configs in bf16, the dtype the full configs run in: the
    hidden states, prefill logits and KV cache and the decode logits and
    cache have the reference's dtypes (bf16 activations and caches, fp32
    logits), and each row is within cosine 0.995 of the reference's
    (measured: 0.9983 at the least, arctic's hidden states; the logits
    0.9986 and the caches 0.99997 at the least).  bf16 rounding in two
    packages' products differs, so values are held by cosine, not
    elementwise."""
    jc = dataclasses.replace(j_get_arch(arch).smoke_cfg, dtype="bfloat16")
    tc = dataclasses.replace(get_arch(arch).smoke_cfg, dtype="bfloat16")
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(11).integers(
        0, jc.vocab, size=(2, S_TEST + 1)).astype(np.int32)
    j_hidden = jax.jit(JT.forward, static_argnums=2)(jp, toks[:, :S_TEST], jc)
    j_logits, j_cache = jax.jit(JT.make_prefill_step(jc))(jp, toks[:, :S_TEST])
    j_cache = {n: jnp.pad(c, ((0, 0), (0, 0), (0, T_CACHE - S_TEST), (0, 0),
                              (0, 0))) for n, c in j_cache.items()}
    j_dec, j_cache = jax.jit(JT.make_serve_step(jc))(
        jp, j_cache, toks[:, S_TEST:], jnp.asarray(S_TEST, jnp.int32))
    with torch.no_grad():
        t_hidden = TT.forward(tp, _t(toks[:, :S_TEST]), tc)
        t_logits, t_cache = TT.make_prefill_step(tc)(tp, _t(toks[:, :S_TEST]))
        t_cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0,
                                                  T_CACHE - S_TEST))
                   for n, c in t_cache.items()}
        t_dec, t_cache = TT.make_serve_step(tc)(tp, t_cache,
                                               _t(toks[:, S_TEST:]), S_TEST)
    pairs = {"hidden": (t_hidden, j_hidden), "prefill": (t_logits, j_logits),
             "decode": (t_dec, j_dec), "k": (t_cache["k"], j_cache["k"]),
             "v": (t_cache["v"], j_cache["v"])}
    for name, (t, j) in pairs.items():
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (name, t.dtype,
                                                            j.dtype)
        a, b = _n(t.float()), np.asarray(j, np.float32)
        if name in ("k", "v"):       # [L, B, T, Hkv, dh]: the filled slots
            a = np.moveaxis(a[:, :, :S_TEST + 1], 1, 0)
            b = np.moveaxis(b[:, :, :S_TEST + 1], 1, 0)
        cos = _batch_row_cosines(a, b)
        assert cos.min() >= 0.995, (name, cos)


def test_vocab_padding_is_masked():
    """granite-moe's 49155 vocab pads to /128; pad columns never win."""
    cfg = TT.LMConfig(name="t", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=64, vocab=100, dtype="float32",
                      block_q=8, block_k=8, loss_chunk=8)
    assert cfg.padded_vocab == 128
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["lm_head"].shape[1] == 128
    toks = torch.randint(0, 100, (2, 16), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        loss = TT.loss_fn(p, {"tokens": toks, "labels": toks}, cfg)
        logits, _ = TT.make_prefill_step(cfg)(p, toks)
    assert float(loss) < np.log(100) + 1.0
    assert logits.shape == (2, 100)


def test_chunked_loss_takes_whole_chunks_only():
    """The reference's reshape into [B, S // chunk, chunk] rejects a ragged
    last chunk; the port raises instead of dropping its tokens."""
    h = torch.ones(1, 24, 8)
    with pytest.raises(ValueError, match="loss chunk"):
        TT.chunked_ce_loss(h, torch.ones(8, 128), torch.zeros(1, 24,
                                                              dtype=torch.long),
                           16, 128)
    assert torch.isfinite(TT.chunked_ce_loss(
        h, torch.ones(8, 128), torch.zeros(1, 24, dtype=torch.long), 8, 100))


def test_remat_changes_no_gradient():
    cfg = get_arch("granite-moe-1b-a400m").smoke_cfg
    p = TT.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator()
                         .manual_seed(3))
    batch = {"tokens": toks[:, :32], "labels": toks[:, 1:]}
    l1, g1 = value_and_grad(TT.loss_fn, p, batch, cfg)
    l2, g2 = value_and_grad(TT.loss_fn, p, batch,
                            dataclasses.replace(cfg, remat=False))
    assert float(l1) == float(l2)
    for (path, a), (_, b) in zip(tree_flatten_with_path(g1),
                                 tree_flatten_with_path(g2)):
        assert torch.equal(a, b), path
