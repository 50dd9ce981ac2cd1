"""The kernels of the unfused engine and of the stage-2 rerank against the
JAX package: ``gather_distance`` (with and without a skip mask) and
``crouting_prune``.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run the plain
PyTorch versions.  ``gather_distance_ref`` is held against
``repro.kernels.ref.gather_distance_ref`` within rtol/atol 1e-5 (the JAX
``gather_distance_pallas`` uses ``pltpu.TPUMemorySpace``, which the
installed JAX no longer has).  ``crouting_prune_ref`` is held against
``crouting_prune_pallas`` in interpret mode, which does run here: the prune
mask must be bit-equal, and the estimate is bit-equal with the eager jnp
oracle but only within an ulp of the jitted kernel, because XLA's CPU
backend contracts the jitted estimate into two FMAs.  The
engine-level parity of ``engine="unfused"`` is in test_torch_search.py.
The CUDA kernels run only on the card: the ``gpu``-marked tests skip
without one (``chip_smoke.py`` runs the same checks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.crouting_prune import crouting_prune_pallas

from repro_torch.kernels import ops, ref


def _gather_inputs(seed, B, M, N, d):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, d)).astype(np.float32)
    table[-1] = 0.0                          # the pad row
    idx = rng.integers(0, N, size=(B, M)).astype(np.int32)
    idx[:, ::7] = N - 1
    q = rng.normal(size=(B, d)).astype(np.float32)
    skip = (rng.random((B, M)) < 0.4).astype(np.int8)
    return idx, q, table, skip


@pytest.mark.parametrize("B,M,N,d", [(3, 4, 50, 16), (4, 100, 300, 100),
                                     (2, 128, 200, 128), (2, 24, 60, 261)])
def test_gather_distance_matches_jax_oracle(B, M, N, d):
    idx, q, table, skip = _gather_inputs(B * M + d, B, M, N, d)
    jd = np.asarray(jref.gather_distance_ref(*map(jnp.asarray,
                                                  (idx, q, table))))
    td = ops.gather_distance(*map(torch.as_tensor, (idx, q, table)))
    assert td.dtype == torch.float32 and td.shape == (B, M)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)
    # the pruned form: skipped lanes +inf, the rest unchanged bit for bit
    tp = ops.gather_distance_pruned(*map(torch.as_tensor,
                                         (idx, skip, q, table)))
    assert np.isinf(tp.numpy()[skip != 0]).all()
    np.testing.assert_array_equal(tp.numpy()[skip == 0],
                                  td.numpy()[skip == 0])
    assert torch.equal(tp, ref.gather_distance_pruned_ref(
        *map(torch.as_tensor, (idx, skip, q, table))))
    # and the row sums follow the kernels' order exactly
    rows = torch.as_tensor(table)[torch.as_tensor(idx).long()]
    assert torch.equal(td, ref.l2sq_rows(torch.as_tensor(q), rows))


def test_gather_wrappers_mask_out_of_range_ids():
    idx, q, table, _ = _gather_inputs(1, 3, 20, 30, 8)
    idx[0, :3] = -1
    idx[2, ::4] = 30 + 2
    out = (idx < 0) | (idx >= 30)
    for d2 in (ops.gather_distance(*map(torch.as_tensor, (idx, q, table))),
               ops.gather_distance_pruned(*map(torch.as_tensor, (
                   idx, np.zeros_like(idx, np.int8), q, table)))):
        assert np.isinf(d2.numpy()[out]).all()
        assert np.isfinite(d2.numpy()[~out]).all()


def _prune_inputs(seed, B, M):
    rng = np.random.default_rng(seed)
    ed = rng.uniform(0, 5, size=(B, M)).astype(np.float32)
    ed[:, ::11] = np.inf                     # adjacency pad slots
    dcq = rng.uniform(0, 5, size=(B, M)).astype(np.float32)
    b2 = rng.uniform(0, 30, size=(B, M)).astype(np.float32)
    b2[0] = np.inf                           # never prunes
    b2[2] = 0.0                              # prunes every valid lane
    valid = (rng.random((B, M)) < 0.8).astype(np.int8)
    return ed, dcq, b2, valid


@pytest.mark.parametrize("B,M", [(8, 128), (16, 256)])
def test_crouting_prune_matches_pallas_interpret(B, M):
    ed, dcq, b2, valid = _prune_inputs(B + M, B, M)
    ct = 0.3127
    je, jm = crouting_prune_pallas(*map(jnp.asarray, (ed, dcq, b2, valid)),
                                   ct, interpret=True)
    te, tm = ops.crouting_prune(*map(torch.as_tensor, (ed, dcq, b2, valid)),
                                ct)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    # XLA contracts the jitted kernel's estimate into
    # fma(-(2*ed)*dcq, ct, fma(ed, ed, dcq*dcq)): within an ulp of the
    # port's (and the CUDA kernel's) uncontracted order ...
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-6)
    # ... which is bit for bit the eager jnp oracle's
    oe, om = jref.crouting_prune_ref(*map(jnp.asarray, (ed, dcq, b2, valid)),
                                     ct)
    np.testing.assert_array_equal(np.asarray(oe).view(np.int32),
                                  te.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(om), tm.numpy())
    tm, nan = tm.numpy(), np.isnan(te.numpy())
    # bound2 = +inf never prunes; bound2 = 0 prunes every valid lane but a
    # NaN estimate (an inf edge length), which never prunes
    assert not tm[0].any() and (tm[2] == (valid[2] & ~nan[2])).all()
    assert nan[:, ::11].all() and not tm[:, ::11].any()


def test_crouting_prune_broadcasts_per_query_inputs():
    """dcq/bound2 of shape [B] broadcast over the lanes, as in the JAX ops
    wrapper (which also pads ragged shapes)."""
    ed, dcq, b2, valid = _prune_inputs(4, 3, 40)
    je, jm = jops.crouting_prune(*map(jnp.asarray, (ed, dcq[:, 0], b2[:, 0],
                                                    valid)), 0.2,
                                 interpret=True)
    te, tm = ops.crouting_prune(*map(torch.as_tensor, (ed, dcq[:, 0],
                                                       b2[:, 0], valid)), 0.2)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-6)


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,d", [(4, 128), (100, 960), (128, 100)])
def test_gather_distance_kernel_is_bit_equal_on_gpu(cuda, M, d):
    from repro_torch.kernels.gather_distance import gather_distance_cuda
    raw = _gather_inputs(M + d, 128, M, 5000, d)
    t = [torch.as_tensor(a, device=cuda) for a in raw]
    args = ops.prepare_gather_distance(t[0], t[1], t[2], skip=t[3])
    assert torch.equal(gather_distance_cuda(*args),
                       ref.gather_distance_ref(args[0], args[2], args[3],
                                               args[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [128, 256])
def test_crouting_prune_kernel_is_bit_equal_on_gpu(cuda, M):
    from repro_torch.kernels.crouting_prune import crouting_prune_cuda
    t = [torch.as_tensor(a, device=cuda) for a in _prune_inputs(M, 128, M)]
    ke, kp = crouting_prune_cuda(*t, 0.31)
    pe, pp = ref.crouting_prune_ref(*t, 0.31)
    assert torch.equal(kp, pp)
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))
