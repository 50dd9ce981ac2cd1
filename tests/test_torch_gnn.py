"""The port's GNN family (``repro_torch.models.gnn`` and its four configs)
against the JAX package's, on the CPU.

The same seeded numpy batch (``random_graph_batch``, bit-equal in both
packages) goes through ``repro.models.gnn`` and ``repro_torch.models.gnn``
for each arch's smoke config and each task it runs: ``gin`` and ``gat`` in
``node_class`` and (as on ``molecule``) ``graph_class``, ``schnet`` and
``egnn`` in ``graph_reg``.  The batch carries padding as the reference's
cells pad (zero edge and node masks; padded edges still index real nodes),
a node whose in-edges are all masked and, for GAT, exact score ties.
Weights come from the reference's ``init_gnn`` through ``params_from_jax``.

Tolerances (fp32 throughout; the two packages sum in different orders):
  * ``gnn_forward``: rtol 1e-5, atol 1e-6 elementwise;
  * ``gnn_loss`` and its gradients against ``jax.value_and_grad``, and one
    ``make_gnn_train_step`` (AdamW, lr 1e-3 from step 1: the new
    parameters and both moments): atol 1e-6 and rtol 1e-4 elementwise,
    the rtol widened by twice the reference's own spread on that output:
    the largest relative change (beyond atol) of its elements when the
    reference's parameters are perturbed by 2^-23 relative noise (about
    one fp32 rounding), over three noise seeds.  The spread is capped at
    SPREAD_CAP = 5e-4, so no rtol passes 1.1e-3.  Measured on an x86 CPU
    with jax 0.9.0 (the reference jitted): egnn's gradient spread is
    5.3e-4 (its random positions of std 3 make d^2 ~ 50 and the loss
    ~3e5), so its limit is the capped 1.1e-3, and the port's largest
    egnn gradient error is 1.8e-4.  The other spreads are at most 8.4e-6
    (gin graph_class's gradients), and the port's errors there at most
    8.6e-7 (schnet's gradients); every step output is within atol;
  * ``segment_softmax`` and its gradient: rtol 1e-5, atol 1e-7, with an
    empty segment, an all-masked (``-inf``) segment and exact ties.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data.synthetic import random_graph_batch as j_graph_batch
from repro.models import gnn as JG
from repro.train import optimizer as jopt

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import random_graph_batch
from repro_torch.models import gnn as TG
from repro_torch.train import optimizer as topt
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              treedef_str, value_and_grad)

GNN_ARCHS = ["schnet", "gat-cora", "egnn", "gin-tu"]
CASES = [("gin-tu", "node_class"), ("gin-tu", "graph_class"),
         ("gat-cora", "node_class"), ("gat-cora", "graph_class"),
         ("schnet", "graph_reg"), ("egnn", "graph_reg")]
FWD = dict(rtol=1e-5, atol=1e-6)
RTOL, ATOL = 1e-4, 1e-6
SPREAD_CAP = 5e-4    # the most a reference spread may widen rtol by, /2
OCFG = dict(lr=1e-3, warmup_steps=1)
N, E, F_IN, G = 64, 256, 8, 4
MASKED_NODE = 5          # every edge into this node is masked


def _np_batch(cfg, seed=0):
    b = random_graph_batch(N, E, F_IN, cfg.n_classes, n_graphs=G, seed=seed,
                           task=cfg.task)
    ref = j_graph_batch(N, E, F_IN, cfg.n_classes, n_graphs=G, seed=seed,
                        task=cfg.task)
    assert all(np.array_equal(b[k], ref[k]) for k in ref)
    b["edge_mask"][-16:] = 0.0                    # padded edges
    b["edge_mask"][b["edge_dst"] == MASKED_NODE] = 0.0
    b["node_mask"][-3:] = 0.0                     # padded nodes
    b["label_mask"][-3:] = 0.0
    assert (b["edge_dst"] == MASKED_NODE).any()
    assert len(set(range(N)) - set(b["edge_dst"].tolist())) >= 1   # empty
    return b


def _cfg(arch, task):
    return dataclasses.replace(get_arch(arch).smoke_cfg, task=task)


def _jcfg(arch, task):
    return dataclasses.replace(j_get_arch(arch).smoke_cfg, task=task)


def _setup(arch, task, seed=0):
    cfg, jcfg = _cfg(arch, task), _jcfg(arch, task)
    b = _np_batch(cfg, seed)
    jp = JG.init_gnn(jcfg, F_IN, jax.random.PRNGKey(seed))
    tp = TG.params_from_jax(jp, device="cpu")
    return (cfg, jcfg, {k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()}, jp, tp)


def _worst(got, want):
    """Largest relative error beyond ATOL over the leaves of two trees."""
    w = 0.0
    for g, r in zip(got, want):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        w = max(w, float(((np.abs(g - r) - ATOL)
                          / np.maximum(np.abs(r), 1e-30)).max()))
    return w


_REFERENCE = {}


def _reference(arch, task):
    """The reference's loss, gradients and one train step on ``_setup``'s
    inputs, and the spread of each (see the module docstring)."""
    if (arch, task) not in _REFERENCE:
        cfg, jcfg, tb, jb, jp, tp = _setup(arch, task)
        jo = jopt.AdamWConfig(**OCFG)

        @jax.jit
        def run(params):
            (loss, grads) = jax.value_and_grad(JG.gnn_loss)(params, jb, jcfg)
            newp, news, _ = jopt.adamw_update(
                grads, jopt.adamw_init(params, jo), params, jo)
            return {"loss": loss, "grads": grads, "params": newp,
                    "mu": news.mu, "nu": news.nu}

        base = run(jp)
        spread = {k: 0.0 for k in base}
        for seed in range(3):
            rng = np.random.default_rng(100 + seed)
            moved = run(jax.tree_util.tree_map(
                lambda a: a * (1 + jnp.asarray(rng.normal(size=a.shape),
                                               jnp.float32) * 2.0 ** -23),
                jp))
            for k in base:
                spread[k] = max(spread[k], _worst(
                    jax.tree_util.tree_leaves(moved[k]),
                    jax.tree_util.tree_leaves(base[k])))
        _REFERENCE[arch, task] = (base, spread)
    return _REFERENCE[arch, task]


def _close(got_tree, want_tree, spread):
    rtol = RTOL + 2 * min(spread, SPREAD_CAP)
    got = tree_flatten_with_path(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=path, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("arch,task", CASES)
def test_forward_and_serve_step_match_the_reference(arch, task):
    cfg, jcfg, tb, jb, jp, tp = _setup(arch, task)
    want = np.asarray(JG.gnn_forward(jp, jb, jcfg))
    got = TG.gnn_forward(tp, tb, cfg)
    assert tuple(got.shape) == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    served = TG.make_gnn_serve_step(cfg)(tp, tb)
    assert not served.requires_grad and torch.equal(served, got.detach())


@pytest.mark.parametrize("arch,task", CASES)
def test_loss_and_gradients_match_the_reference(arch, task):
    cfg, jcfg, tb, jb, jp, tp = _setup(arch, task)
    ref, spread = _reference(arch, task)
    tl, tg = value_and_grad(TG.gnn_loss, tp, tb, cfg)
    _close(tl, ref["loss"], spread["loss"])
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(tg))
    _close(tg, ref["grads"], spread["grads"])


@pytest.mark.parametrize("arch,task", CASES)
def test_one_train_step_matches_the_reference(arch, task):
    cfg, jcfg, tb, jb, jp, tp = _setup(arch, task)
    ref, spread = _reference(arch, task)
    to = topt.AdamWConfig(**OCFG)
    tnp, ts, tm = TG.make_gnn_train_step(cfg, to)(
        tp, topt.adamw_init(tp, to), tb)
    _close(tm["loss"], ref["loss"], spread["loss"])
    assert int(ts.step) == 1
    _close(tnp, ref["params"], spread["params"])
    _close(ts.mu, ref["mu"], spread["mu"])
    _close(ts.nu, ref["nu"], spread["nu"])


def _softmax_inputs():
    """8 segments: 0 has ties at its max, 1 is all -inf (masked), 2 gets
    no score (empty), 3 a single score, 4-7 random."""
    rng = np.random.default_rng(3)
    seg = np.array([0, 0, 0, 1, 1, 3] + list(rng.integers(4, 8, size=20)),
                   np.int32)
    s = rng.normal(size=seg.size).astype(np.float32)
    s[:3] = [1.5, 1.5, -0.25]                      # a tie at the max
    s[3:5] = -np.inf
    s[6:9] = 0.75                                  # ties across segments
    return s, seg


def test_segment_softmax_matches_the_reference():
    s, seg = _softmax_inputs()
    w = np.random.default_rng(4).normal(size=s.size).astype(np.float32)
    jf = lambda x: JG.segment_softmax(x, jnp.asarray(seg), 8)   # noqa: E731
    jout = np.asarray(jf(jnp.asarray(s)))
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(
        jnp.where(jnp.isfinite(x), jf(x) * w, 0.0)))(jnp.asarray(s)))
    x = torch.from_numpy(s).requires_grad_(True)
    out = TG.segment_softmax(x, torch.from_numpy(seg), 8)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(grad).all())
    out = out.detach()
    assert out[3] == 0 and out[4] == 0             # the all-masked segment
    assert float(out[0]) == float(out[1])          # tied scores, tied weights
    smax = TG.segment_max(torch.from_numpy(s), torch.from_numpy(seg).long(),
                          8)
    assert smax[2] == -np.inf and smax[1] == -np.inf


def test_params_carry_over_in_the_reference_tree():
    for arch in GNN_ARCHS:
        jcfg = j_get_arch(arch).smoke_cfg
        jp = JG.init_gnn(jcfg, F_IN, jax.random.PRNGKey(0))
        tp = TG.params_from_jax(jp, device="cpu")
        assert treedef_str(tp) == str(jax.tree_util.tree_structure(jp))
        for g, w in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        back = TG.params_to_numpy(tp)
        for g, w in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(g, np.asarray(w))
        mine = TG.init_gnn(get_arch(arch).smoke_cfg, F_IN,
                           torch.Generator().manual_seed(0), device="cpu")
        assert treedef_str(mine) == treedef_str(tp)
        assert [tuple(a.shape) for a in tree_leaves(mine)] == \
            [tuple(a.shape) for a in tree_leaves(tp)]


def test_init_gnn_runs_on_the_gpu_unless_asked_for_the_cpu():
    cfg = get_arch("gin-tu").smoke_cfg
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TG.init_gnn(cfg, F_IN, torch.Generator())
    a = TG.init_gnn(cfg, F_IN, torch.Generator().manual_seed(0), device="cpu")
    b = TG.init_gnn(cfg, F_IN, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                tree_leaves(b)))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_specs_equal_the_reference(arch):
    mine, ref = get_arch(arch), j_get_arch(arch)
    assert (mine.arch_id, mine.family, mine.source) == \
        (ref.arch_id, ref.family, ref.source) and mine.family == "gnn"
    assert dataclasses.asdict(mine.model_cfg) == \
        dataclasses.asdict(ref.model_cfg)
    assert dataclasses.asdict(mine.smoke_cfg) == \
        dataclasses.asdict(ref.smoke_cfg)
    assert [dataclasses.asdict(s) for s in mine.shapes] == \
        [dataclasses.asdict(s) for s in ref.shapes]
