"""The port's ``l2_distance`` (wrapper and plain version) against the JAX
package's oracle and its Pallas kernel in interpret mode.

On the CPU ``repro_torch.kernels.ops.l2_distance`` runs the plain version
``ref.l2_distance_ref``; it is held against ``repro.kernels.ref`` and
``repro.kernels.ops.l2_distance`` (``l2_distance_pallas``, interpreted)
over the reference's own sweep with its tolerances (fp32 1e-4, bf16 5e-2,
atol scaled by d: ``tests/test_kernels.py``).  The CUDA kernel runs only on
the card: the ``gpu``-marked test skips without one (``chip_smoke.py`` runs
the same check at the retrieval path's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.l2_distance import STREAM_MAX_Q

SWEEP = [(8, 16, 32), (70, 130, 96), (128, 256, 128), (33, 257, 200)]


def _inputs(seed, q_n, c_n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q_n, d)).astype(np.float32),
            rng.normal(size=(c_n, d)).astype(np.float32))


@pytest.mark.parametrize("q_n,c_n,d", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["l2", "ip"])
def test_plain_matches_jax_oracle_and_pallas_kernel(q_n, c_n, d, dtype, mode):
    q, x = _inputs(q_n * c_n + d, q_n, c_n, d)
    jq, jx = jnp.asarray(q, dtype), jnp.asarray(x, dtype)
    tq = torch.as_tensor(q).to(getattr(torch, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    out = ops.l2_distance(tq, tx, mode=mode)
    assert out.dtype == torch.float32 and tuple(out.shape) == (q_n, c_n)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for exp in (jref.l2_distance_ref(jq, jx, mode=mode),
                jops.l2_distance(jq, jx, mode=mode, bq=32, bc=64, bd=64)):
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=tol,
                                   atol=tol * d)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    q, x = _inputs(1, 5, 40, 24)
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    before = dict(ops.LAUNCHES)
    for mode in ("l2", "ip"):
        out = ops.l2_distance(tq, tx, mode=mode)
        assert torch.equal(out, ref.l2_distance_ref(tq, tx, mode))
    assert ops.LAUNCHES == before
    # the l2 form clamps cancellation below zero, ip is 1 - <q, x>
    same = ops.l2_distance(tq, tq, mode="l2")
    assert (same >= 0).all() and float(same.diagonal().abs().max()) < 1e-3
    np.testing.assert_allclose(ops.l2_distance(tq, tx, mode="ip").numpy(),
                               1.0 - q @ x.T, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="mode"):
        ops.l2_distance(tq, tx, mode="cos")


@pytest.mark.parametrize("mode", ["l2", "ip"])
def test_odd_shapes_need_no_padding_by_the_caller(mode):
    """Q, C and d off every block multiple: the JAX wrapper pads and slices
    back, the port's takes the shapes as they are."""
    q, x = _inputs(7, 3, 1001, 37)
    out = ops.l2_distance(torch.as_tensor(q), torch.as_tensor(x), mode=mode)
    exp = np.asarray(jops.l2_distance(jnp.asarray(q), jnp.asarray(x),
                                      mode=mode))
    assert exp.shape == tuple(out.shape) == (3, 1001)
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-4, atol=1e-4 * 37)


def test_mixed_input_types_are_taken_as_fp32():
    q, x = _inputs(3, 4, 50, 16)
    tq = torch.as_tensor(q).to(torch.bfloat16)
    out = ops.l2_distance(tq, torch.as_tensor(x), mode="ip")
    assert torch.equal(out, ref.l2_distance_ref(tq.float(),
                                                torch.as_tensor(x), "ip"))


def test_l2_distance_is_a_built_kernel():
    assert "l2_distance" in build.KERNEL_SOURCES
    assert (build.CSRC / "l2_distance.cu").is_file()
    assert "l2_distance" in ops.LAUNCHES


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


QS = STREAM_MAX_Q


@pytest.mark.gpu
@pytest.mark.parametrize("q_n,c_n,d", SWEEP + [
    (1, 100_003, 128), (33, 257, 960),
    # both sides of the streaming/tiled split (Q, and C at Q = Qs), and
    # ragged d
    (2, 20_011, 128), (QS, 131_101, 128), (QS + 1, 131_101, 128),
    (QS, 20_011, 128), (1, 5_003, 33), (2, 5_003, 100), (4, 2_051, 960),
    (QS, 2_051, 960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["l2", "ip"])
@pytest.mark.parametrize("view", ["contiguous", "offset"])
def test_kernel_matches_plain_on_gpu(cuda, q_n, c_n, d, dtype, mode, view):
    """``offset`` hands the kernel ``x[3:]`` of a contiguous tensor: no
    copy, and a base that is 16-byte aligned only where 3 rows are (not at
    d = 33, which takes the tiled kernel either way)."""
    from repro_torch.kernels.l2_distance import l2_distance_cuda
    q, x = _inputs(q_n + d, q_n, c_n + 3, d)
    dt = getattr(torch, dtype)
    tq = torch.as_tensor(q, device=cuda).to(dt)
    full = torch.as_tensor(x, device=cuda).to(dt)
    tx = full[3:] if view == "offset" else full[:c_n]
    assert tx.is_contiguous() and tx.shape == (c_n, d)
    got = l2_distance_cuda(tq, tx, mode)
    exp = ref.l2_distance_ref(tq, tx, mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exp, rtol=1e-4, atol=1e-4 * d)


@pytest.mark.gpu
def test_stream_limits_match_the_kernel(cuda):
    """The chooser's copy of the streaming kernel's limits is the one its
    launcher enforces."""
    from repro_torch.kernels import l2_distance as L2K
    assert L2K.stream_limits() == (L2K.STREAM_MAX_Q, L2K.CHUNK_BYTES,
                                   L2K.STREAM_MAX_QUERY_BYTES)
