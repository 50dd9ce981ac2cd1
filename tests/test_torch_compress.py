"""The port's int8 quantizer and gradient compression
(``repro_torch.quant.sq8`` / ``repro_torch.train.compress``) against the
JAX package's, on the CPU.

Tolerances:
  * the deterministic int8 path (no key, no generator): q, the scale and
    the dequantized values bit for bit, half-way ties included (both round
    half to even);
  * the stochastic path cannot share the reference's draws (a JAX key does
    not seed a torch generator), so it is held by its law: every q lies in
    {floor(x/s), floor(x/s) + 1} clipped to [-127, 127], and the mean of
    4,000 dequantized draws lies within 4 sigma of x (sigma =
    s * sqrt(p (1 - p) / 4000), p = x/s - floor(x/s); 1e-7 where p is 0);
  * ``compress_tree`` -> ``decompress_tree`` and the one-member
    ``compressed_psum`` within one scale of the input (stochastic) or half a
    scale (round to nearest); two members within two scales of the sum;
  * ``with_error_feedback``'s residual bit for bit on the same trees.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import sq8 as JQ
from repro.train import compress as JC

from repro_torch.quant import sq8 as TQ
from repro_torch.train import compress as TC
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -126.5, 3.0, 0.0],
                    np.float32)                          # scale 1.0: ties
    return {"normal": rng.normal(size=(33, 17)).astype(np.float32),
            "wide": (rng.standard_cauchy(size=1000) * 1e3).astype(np.float32),
            "ties": ties,
            "tiny": (rng.normal(size=64) * 1e-30).astype(np.float32),
            "zeros": np.zeros(8, np.float32)}


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_deterministic_int8_is_bit_equal_to_the_reference(name):
    x = _inputs()[name]
    jq, js = JQ.quantize_int8(jnp.asarray(x))
    tq, ts = TQ.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.item()).tobytes() == np.float32(js).tobytes()
    np.testing.assert_array_equal(TQ.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JQ.dequantize_int8(jq, js)))
    # a scale smaller than amax/127 clips, in both
    s = np.float32(np.abs(x).max() / 300 + 1e-30)
    np.testing.assert_array_equal(
        TQ.quantize_int8_with_scale(torch.from_numpy(x), float(s)).numpy(),
        np.asarray(JQ.quantize_int8_with_scale(jnp.asarray(x), s)))


def test_ties_round_half_to_even():
    q, s = TQ.quantize_int8(torch.from_numpy(_inputs()["ties"]))
    assert s.item() == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -126, 3, 0]


def test_stochastic_rounding_by_its_law():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    x[0] = 0.0
    x[1] = x.abs().max()                                 # y = 127 exactly
    n = 4000
    _, scale = TQ.quantize_int8(x)
    gen = torch.Generator().manual_seed(3)
    q = TQ.quantize_int8_with_scale(x.expand(n, 64), scale, gen)
    y = x / scale
    lo = torch.floor(y)
    assert bool(((q == lo.clamp(-127, 127)) |
                 (q == (lo + 1).clamp(-127, 127))).all())
    assert bool((q.float().std(0) > 0).sum() > 50)       # it does draw
    p = (y - lo).double()
    sigma = (scale.double() * torch.sqrt(p * (1 - p) / n)).clamp_min(1e-7)
    mean = TQ.dequantize_int8(q, scale).double().mean(0)
    assert bool(((mean - x.double()).abs() <= 4 * sigma).all()), \
        float(((mean - x.double()).abs() / sigma).max())
    again = TQ.quantize_int8_with_scale(
        x.expand(n, 64), scale, torch.Generator().manual_seed(3))
    assert torch.equal(q, again)


def _grads():
    rng = np.random.default_rng(2)
    return {"w": torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32)),
            "layers": [torch.from_numpy(rng.normal(size=7).astype(np.float32)
                                        * 1e-3),
                       torch.from_numpy(rng.normal(size=(3, 3))
                                        .astype(np.float32) * 50)]}


@pytest.mark.parametrize("seed", [None, 5])
def test_compress_roundtrip_within_one_scale(seed):
    g = _grads()
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    qs, scales = TC.compress_tree(g, gen)
    back = TC.decompress_tree(qs, scales)
    lim = 0.5 if seed is None else 1.0
    for a, b, q, s in zip(tree_leaves(g), tree_leaves(back), tree_leaves(qs),
                          tree_leaves(scales)):
        assert q.dtype == torch.int8 and b.shape == a.shape
        assert float((a - b).abs().max()) <= lim * float(s) * (1 + 1e-6)
    summed = TC.compressed_psum(
        g, generator=None if seed is None else
        torch.Generator().manual_seed(seed))
    for a, b, s in zip(tree_leaves(g), tree_leaves(summed),
                       tree_leaves(scales)):
        assert float((a - b).abs().max()) <= lim * float(s) * (1 + 1e-6)
    if seed is None:        # the one-member psum is quantize -> dequantize
        for a, b in zip(tree_leaves(back), tree_leaves(summed)):
            assert torch.equal(a, b)


_TWO_MEMBERS = r"""
import os, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
sys.path.insert(0, os.path.join(REPO, "src"))
from repro_torch.train import compress as TC


def worker(rank, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    g = {"a": torch.linspace(-1, 1, 11) * (rank + 1),
         "b": torch.full((3,), 0.3 + rank)}
    out = TC.compressed_psum(g, group=dist.group.WORLD,
                             generator=torch.Generator().manual_seed(rank))
    q.put((rank, {k: v.tolist() for k, v in out.items()}))
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ps = [ctx.Process(target=worker, args=(r, port, q)) for r in range(2)]
    for p in ps:
        p.start()
    res = dict(q.get(timeout=90) for _ in ps)
    for p in ps:
        p.join(timeout=60)
    assert all(not p.is_alive() and p.exitcode == 0 for p in ps)
    assert res[0] == res[1], res
    exact = {"a": (torch.linspace(-1, 1, 11) * 3).tolist(),
             "b": [0.3 + 1.3] * 3}
    scale = {"a": 2 / 127, "b": 1.3 / 127}
    for k in exact:
        err = max(abs(u - v) for u, v in zip(res[0][k], exact[k]))
        assert err <= 2 * scale[k] * (1 + 1e-6), (k, err)
    print("ok")
"""


def test_compressed_psum_over_two_gloo_members(tmp_path):
    """Two spawned processes in a gloo group: each member's result is the
    same tensor, the members' int values summed at the shared
    (max-reduced) scale, within two scales of the true sum."""
    script = tmp_path / "two_members.py"
    script.write_text(_TWO_MEMBERS.replace("REPO", repr(REPO)))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_error_feedback_residual_equals_the_reference():
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 4), "b": (4,)}
    g, r, d = ({k: rng.normal(size=s).astype(np.float32)
                for k, s in shapes.items()} for _ in range(3))

    def tt(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    for residual in (None, r):
        jc, jfn = JC.with_error_feedback(
            {k: jnp.asarray(v) for k, v in g.items()},
            None if residual is None
            else {k: jnp.asarray(v) for k, v in residual.items()})
        tc, tfn = TC.with_error_feedback(
            tt(g), None if residual is None else tt(residual))
        jres = jfn({k: jnp.asarray(v) for k, v in d.items()})
        tres = tfn(tt(d))
        for k in shapes:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            np.testing.assert_array_equal(tres[k].numpy(),
                                          np.asarray(jres[k]))


def test_compress_reexports_are_the_same_functions():
    """train/compress.py must not grow a second int8 implementation."""
    assert TC.quantize_int8 is TQ.quantize_int8
    assert TC.dequantize_int8 is TQ.dequantize_int8
    assert TC.quantize_int8_with_scale is TQ.quantize_int8_with_scale


def test_split_generator_is_seeded_and_per_leaf():
    a = TC.split_generator(torch.Generator().manual_seed(9), ["cpu"] * 3)
    b = TC.split_generator(torch.Generator().manual_seed(9), ["cpu"] * 3)
    draws = [torch.rand(4, generator=x) for x in a]
    assert all(torch.equal(u, torch.rand(4, generator=v))
               for u, v in zip(draws, b))
    assert not torch.equal(draws[0], draws[1])
    assert TC.split_generator(None, ["cpu"] * 2) == [None, None]
