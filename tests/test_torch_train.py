"""The port's training stack against the JAX package's, on the CPU:
``data/synthetic`` (bit for bit), AdamW (``lr_schedule``, one
``adamw_update``), ``make_train_step`` and ``make_accum_train_step``,
checkpoints (round trip, corruption, GC, crash-resume, fp32 cross-loading
both ways), ``remesh_plan``, the trainer's learning check and
``python -m repro_torch.launch.train``.

Tolerances: one optimizer step's parameters and moments 1e-5 (rtol =
atol), from the same gradients and after one ``make_train_step``; the train
step's loss and gradient norm 1e-4; checkpoints and resumes bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as JS
from repro.models import transformer as JT
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro.train.elastic import remesh_plan as j_remesh_plan
from repro.train.trainer import make_accum_train_step as j_accum_step

from repro_torch.configs import get_arch
from repro_torch.data import synthetic as TS
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as opt
from repro_torch.train.elastic import remesh_plan, reshard_tree
from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                       make_accum_train_step)
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_ARGS = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                d_ff=64, vocab=128, dtype="float32", block_q=8, block_k=16,
                loss_chunk=8)
CFG = TT.LMConfig(**CFG_ARGS)
JCFG = JT.LMConfig(**CFG_ARGS)
OCFG = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
JOCFG = JO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def _fresh(seed=0):
    params = TT.init_params(CFG, torch.Generator().manual_seed(seed),
                            device="cpu")
    state = opt.adamw_init(params, OCFG)
    stream = TS.LMStream(CFG.vocab, 2, 16, seed=0)
    return params, state, stream


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _assert_trees_equal(a, b):
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p



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
# data/synthetic
# --------------------------------------------------------------------------
def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lm_batch_and_stream_equal_the_reference():
    _equal_batches(TS.lm_batch(512, 4, 33, seed=7),
                   JS.lm_batch(512, 4, 33, seed=7))
    t, j = TS.LMStream(100, 2, 16, seed=3), JS.LMStream(100, 2, 16, seed=3)
    for _ in range(3):
        _equal_batches(t.next(), j.next())
    assert t.state() == j.state() == {"step": 3, "seed": 3}
    t2 = TS.LMStream(100, 2, 16)
    t2.restore(j.state())
    _equal_batches(t2.next(), j.next())


@pytest.mark.parametrize("task,n_graphs", [("node_class", 1),
                                           ("graph_class", 4),
                                           ("regress", 3)])
def test_random_graph_batch_equals_the_reference(task, n_graphs):
    _equal_batches(
        TS.random_graph_batch(60, 200, 8, 5, n_graphs=n_graphs, seed=2,
                              task=task),
        JS.random_graph_batch(60, 200, 8, 5, n_graphs=n_graphs, seed=2,
                              task=task))


def test_neighbor_sample_and_dlrm_batch_equal_the_reference():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 300, 2000).astype(np.int32)
    dst = rng.integers(0, 300, 2000).astype(np.int32)
    seeds = rng.choice(300, 12, replace=False)
    _equal_batches(TS.neighbor_sample(src, dst, 300, seeds, (5, 3), seed=4),
                   JS.neighbor_sample(src, dst, 300, seeds, (5, 3), seed=4))
    _equal_batches(TS.dlrm_batch(13, [1000, 5, 40], 64, seed=9),
                   JS.dlrm_batch(13, [1000, 5, 40], 64, seed=9))


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
def test_lr_schedule_matches_the_reference():
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    jcfg = JO.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    steps = np.array([0, 1, 5, 19, 20, 21, 100, 199, 200, 500], np.int32)
    np.testing.assert_allclose(
        opt.lr_schedule(cfg, torch.as_tensor(steps)).numpy(),
        np.asarray(JO.lr_schedule(jcfg, jnp.asarray(steps))), rtol=1e-6,
        atol=1e-12)


def _tree(rng, scale=1.0):
    return {"b": (rng.normal(size=(7,)) * scale).astype(np.float32),
            "a": {"w": (rng.normal(size=(5, 3)) * scale).astype(np.float32),
                  "v": (rng.normal(size=(2, 4, 3)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("state_dtype,grad_clip,steps", [
    ("float32", 1.0, 1), ("float32", 0.0, 3), ("bfloat16", 1.0, 2)])
def test_adamw_update_matches_the_reference(state_dtype, grad_clip, steps):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip,
              state_dtype=state_dtype)
    cfg, jcfg = opt.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    tp = tree_map(torch.as_tensor, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ts, js = opt.adamw_init(tp, cfg), JO.adamw_init(jp, jcfg)
    for _ in range(steps):
        grads = _tree(rng, scale=3.0)
        tp, ts, tm = opt.adamw_update(tree_map(torch.as_tensor, grads), ts,
                                      tp, cfg)
        jp, js, jm = JO.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), js, jp, jcfg)
    assert int(ts.step) == int(js.step) == steps
    for t, j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(tree_leaves(t), jax.tree_util.tree_leaves(j)):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-5, atol=1e-5)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)


def _carried(seed=0):
    jp = JT.init_params(JCFG, jax.random.PRNGKey(seed))
    return jp, TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")


def test_train_step_matches_the_reference():
    jp, tp = _carried()
    batch = JS.lm_batch(CFG.vocab, 2, 16, seed=5)
    js = JO.adamw_init(jp, JOCFG)
    jp1, _, jm = jax.jit(JT.make_train_step(JCFG, JOCFG))(jp, js, batch)
    tp1, ts1, tm = TT.make_train_step(CFG, OCFG)(
        tp, opt.adamw_init(tp, OCFG), tree_map(torch.as_tensor, batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    assert int(ts1.step) == 1
    # the step's parameters: 1e-5, as one optimizer step's (the first Adam
    # step moves each weight by about lr = 5e-4 in the sign of its gradient)
    for a, b in zip(tree_leaves(tp1), jax.tree_util.tree_leaves(jp1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert max(np.abs(a.numpy() - b).max() for a, b in zip(
        tree_leaves(tp1), tree_leaves(_np(tp)))) > 1e-4


def test_accum_train_step_matches_the_reference():
    jp, tp = _carried(1)
    b = [JS.lm_batch(CFG.vocab, 2, 16, seed=s) for s in (1, 2)]
    batch = {k: np.stack([x[k] for x in b]) for k in b[0]}
    jstep = j_accum_step(lambda p, mb: JT.loss_fn(p, mb, JCFG), JOCFG, 2)
    _, _, jm = jax.jit(jstep)(jp, JO.adamw_init(jp, JOCFG), batch)
    tstep = make_accum_train_step(lambda p, mb: TT.loss_fn(p, mb, CFG),
                                  OCFG, 2)
    tp1, _, tm = tstep(tp, opt.adamw_init(tp, OCFG),
                       tree_map(torch.as_tensor, batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    # the mean of the two microbatches' gradients: one step of their sum
    _, g1 = _value_grad(tp, b[0])
    _, g2 = _value_grad(tp, b[1])
    norm = opt.global_norm(tree_map(lambda x, y: (x + y) / 2, g1, g2))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(norm),
                               rtol=1e-6)


def _value_grad(tp, batch):
    from repro_torch.tree import value_and_grad
    return value_and_grad(TT.loss_fn, tp, tree_map(torch.as_tensor, batch),
                          CFG)


# --------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint.py's contracts on the port)
# --------------------------------------------------------------------------
def test_roundtrip_bitexact(tmp_path):
    params, state, stream = _fresh()
    C.save_checkpoint(str(tmp_path), 7, {"params": params, "opt": state},
                      data_cursor=stream.state())
    restored, cursor, step = C.restore_checkpoint(
        str(tmp_path), {"params": params, "opt": state})
    assert step == 7 and cursor == stream.state()
    _assert_trees_equal(restored, {"params": params, "opt": state})


def test_bf16_roundtrip_bitexact(tmp_path):
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    ocfg = dataclasses.replace(OCFG, state_dtype="bfloat16")
    params = TT.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    state = opt.adamw_init(params, ocfg)
    state = state._replace(mu=tree_map(lambda p: p.float().to(torch.bfloat16)
                                       * 0.5, params))
    C.save_checkpoint(str(tmp_path), 3, {"params": params, "opt": state})
    restored, _, _ = C.restore_checkpoint(str(tmp_path),
                                          {"params": params, "opt": state})
    _assert_trees_equal(restored, {"params": params, "opt": state})


def test_corruption_detected(tmp_path):
    params, state, _ = _fresh()
    d = C.save_checkpoint(str(tmp_path), 1, {"params": params, "opt": state})
    with open(os.path.join(d, "shard_0.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        C.restore_checkpoint(str(tmp_path), {"params": params, "opt": state})


def test_crash_resume_bitexact(tmp_path):
    """Kill at step 7, resume, run to 12: losses and the final state equal
    the uninterrupted run's, bit for bit."""
    def make_trainer(ckdir):
        params, state, stream = _fresh()
        return Trainer(TrainerConfig(total_steps=12, ckpt_every=5,
                                     ckpt_dir=ckdir, log_every=100),
                       TT.make_train_step(CFG, OCFG), params, state, stream)

    t_ref = make_trainer(str(tmp_path / "ref"))
    ref = t_ref.run()
    t1 = make_trainer(str(tmp_path / "a"))
    with pytest.raises(RuntimeError):
        t1.run(crash_at=7)
    t2 = make_trainer(str(tmp_path / "a"))
    assert t2.maybe_resume()
    assert t2.step == 5                    # last checkpoint before the crash
    out = t2.run()
    assert out["history"][-3:] == ref["history"][-3:]
    _assert_trees_equal({"p": t2.params, "o": t2.opt_state},
                        {"p": t_ref.params, "o": t_ref.opt_state})
    # a resume of the finished run has no step left to run
    t3 = make_trainer(str(tmp_path / "a"))
    assert t3.maybe_resume() and t3.step == 12
    assert t3.run()["final_loss"] is None


def test_gc_keeps_latest(tmp_path):
    params, state, _ = _fresh()
    for s in (1, 2, 3, 4, 5):
        C.save_checkpoint(str(tmp_path), s, {"params": params, "opt": state})
    C.gc_checkpoints(str(tmp_path), keep=2)
    assert C.latest_step(str(tmp_path)) == 5
    kept = [d for d in os.listdir(str(tmp_path)) if d.startswith("step_")]
    assert len(kept) == 2


def test_restore_places_leaves_on_the_devices_given(tmp_path):
    params, state, _ = _fresh()
    C.save_checkpoint(str(tmp_path), 3, {"params": params, "opt": state})
    like = {"params": params, "opt": state}
    devs = tree_map(lambda _: torch.device("cpu"), like)
    restored, _, _ = C.restore_checkpoint(str(tmp_path), like,
                                          shardings=devs)
    _assert_trees_equal(restored, like)
    _assert_trees_equal(reshard_tree(like, devs), like)


def test_fp32_checkpoints_cross_load_both_ways(tmp_path):
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    jstate = {"params": jp, "opt": JO.adamw_init(jp, JOCFG)}
    jstate["opt"] = jstate["opt"]._replace(step=jnp.asarray(4, jnp.int32))
    tstate = {"params": TT.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")}
    tstate["opt"] = opt.adamw_init(tstate["params"], OCFG)._replace(
        step=torch.tensor(4, dtype=torch.int32))
    # JAX package writes, the port restores
    JC.save_checkpoint(str(tmp_path / "j"), 9, jstate,
                       data_cursor={"step": 9, "seed": 0})
    got, cursor, step = C.restore_checkpoint(str(tmp_path / "j"), tstate)
    assert (step, cursor) == (9, {"step": 9, "seed": 0})
    _assert_trees_equal(got, tstate)
    # the port writes, the JAX package restores
    C.save_checkpoint(str(tmp_path / "t"), 11, tstate,
                      data_cursor={"step": 11, "seed": 0})
    back, cursor, step = JC.restore_checkpoint(str(tmp_path / "t"), jstate)
    assert (step, cursor) == (11, {"step": 11, "seed": 0})
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the two manifests name the leaves alike
    manifests = [json.load(open(os.path.join(tmp_path, d, f"step_{s:08d}",
                                             "manifest.json")))
                 for d, s in (("j", 9), ("t", 11))]
    for key in ("paths", "shapes", "dtypes", "treedef", "n_leaves"):
        assert manifests[0][key] == manifests[1][key], key


@pytest.mark.parametrize("global_batch", [256, 96, 7])
def test_remesh_plan_equals_the_reference(global_batch):
    for ndev in (512, 256, 64, 12, 8, 1):
        plan = remesh_plan(global_batch=global_batch, new_devices=ndev,
                           old_devices=4)
        assert dataclasses.asdict(plan) == dataclasses.asdict(
            j_remesh_plan(global_batch=global_batch, new_devices=ndev,
                          old_devices=4))
        assert plan.tokens_per_step_preserved, (ndev, plan)


# --------------------------------------------------------------------------
# the trainer and the launcher
# --------------------------------------------------------------------------
def test_train_driver_learns(tmp_path):
    """examples/train_lm_torch pathway: loss decreases on structured
    synthetic data (test_system.py::test_train_driver_learns on the port)."""
    cfg = TT.LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab=64, dtype="float32",
                      block_q=8, block_k=16, loss_chunk=8)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tr = Trainer(TrainerConfig(total_steps=60, ckpt_every=1000,
                               ckpt_dir=str(tmp_path), log_every=1000,
                               step_deadline_s=1e-9),
                 TT.make_train_step(cfg, ocfg), params,
                 opt.adamw_init(params, ocfg),
                 TS.LMStream(cfg.vocab, 8, 32, seed=0))
    out = tr.run()
    start = np.mean(out["history"][:5])
    end = np.mean(out["history"][-5:])
    assert end < start - 0.3, f"no learning: {start:.3f} -> {end:.3f}"
    assert len(out["stragglers"]) == 60      # every step past 1 ns
    assert C.latest_step(str(tmp_path)) == 60


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")

    def launch(steps, *extra):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--arch", "granite-moe-1b-a400m", "--steps", str(steps),
             "--ckpt-every", "2", "--batch", "2", "--seq", "32",
             "--ckpt-dir", str(tmp_path), *extra],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    assert "done: final loss" in launch(4)
    out = launch(6, "--resume")
    assert "resumed from step 4" in out and "done: final loss" in out
    assert C.latest_step(str(tmp_path)) == 6
    out = launch(6, "--resume")
    assert "resumed from step 6" in out
    assert "done: at step 6, no step left to run" in out


def test_launch_train_rejects_other_families():
    from repro_torch.launch import train as launch_train
    assert get_arch("dlrm-mlperf").family == "recsys"
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "dlrm-mlperf", "--device", "cpu"])
