"""The kernels of the unfused engine and of the stage-2 rerank against the
JAX package: ``gather_distance`` (no mask, a skip mask or a compute mask)
and ``crouting_prune``, on every operand form their wrappers take.

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


def _gather_inputs(seed, B, M, N, d, in_range=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, d)).astype(np.float32)
    table[-1] = 0.0                          # the pad row
    idx = rng.integers(0, N, size=(B, M)).astype(np.int32)
    idx[:, ::7] = N - 1
    if not in_range:                         # handed over unmasked
        idx[0, ::3] = N + 3
        idx[-1, 1::4] = -2
    q = rng.normal(size=(B, d)).astype(np.float32)
    skip = (rng.random((B, M)) < 0.4).astype(np.int8)
    return idx, q, table, skip


GATHER_FORMS = ("none", "compute_bool", "compute_int8", "compute_uint8",
                "skip_bool", "skip_int8", "skip_uint8", "unaligned")


def _gather_form(raw, form):
    """(idx, queries, table, mask, computes) from ``_gather_inputs``'
    tensors in one of the forms the gather wrappers take; the mask marks
    the same lanes in every polarity."""
    idx, q, table, skip = raw
    if form == "none":
        return idx, q, table, None, False
    if form == "unaligned":                  # a table one element off
        flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                           device=table.device)
        flat[1:] = table.reshape(-1)
        return idx, q, flat[1:].view(table.shape), skip == 0, True
    polarity, dt = form.split("_")
    mask = (skip == 0) if polarity == "compute" else (skip != 0)
    return idx, q, table, mask.to(getattr(torch, dt)), polarity == "compute"


def _gather_call(idx, q, table, mask, computes):
    """The public wrapper of the form: none, skip or compute mask."""
    if mask is None:
        return ops.gather_distance(idx, q, table)
    if computes:
        return ops.gather_distance_where(idx, mask, q, table)
    return ops.gather_distance_pruned(idx, mask, q, table)


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


@pytest.mark.parametrize("form", GATHER_FORMS)
@pytest.mark.parametrize("B,M,N,d", [(4, 100, 300, 100), (3, 24, 60, 261)])
def test_gather_distance_mask_forms_match_jax_oracle(form, B, M, N, d):
    """Every mask form and polarity, with out-of-range and negative ids
    handed over unmasked: the computed lanes agree with the JAX oracle
    within rtol/atol 1e-5, and every other lane is +inf."""
    raw = [torch.as_tensor(a) for a in _gather_inputs(B + M + d, B, M, N, d,
                                                      in_range=False)]
    idx, q, table, mask, computes = _gather_form(raw, form)
    got = _gather_call(idx, q, table, mask, computes)
    assert got.dtype == torch.float32 and got.shape == (B, M)
    ids = idx.numpy()
    fetch = (ids >= 0) & (ids < N)
    if mask is not None:
        fetch &= (mask.numpy() != 0) == computes
    jd = np.asarray(jref.gather_distance_ref(
        jnp.asarray(np.where(fetch, ids, 0)), jnp.asarray(q.numpy()),
        jnp.asarray(table.contiguous().numpy())))
    assert np.isinf(got.numpy()[~fetch]).all()
    np.testing.assert_allclose(got.numpy()[fetch], jd[fetch], rtol=1e-5,
                               atol=1e-5)
    # the plain version the kernel is held to on the card, bit for bit
    assert torch.equal(got, ref.gather_distance_ref(
        *ops.prepare_gather_distance(idx, q, table, mask, computes)))


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


PRUNE_FORMS = ("BL", "B", "BWM_view", "BL_expanded", "ed_BWM",
               "transposed", "valid_bool", "valid_uint8")


def _prune_form(raw, form, W=4):
    """(ed, dcq, bound2, valid) from ``_prune_inputs``' tensors in one of
    the forms ``crouting_prune`` takes: [B], [B, L], [B, W, M] (a zero-stride
    view, as the unfused engine hands dcq over), an expanded [B, L] bound2
    (the l2 engine's), a transposed [B, L], and bool or uint8 masks."""
    ed, dcq, b2, valid = raw
    B, L = valid.shape
    if form == "B":
        dcq, b2 = dcq[:, 0].contiguous(), b2[:, 0].contiguous()
    elif form == "BWM_view":
        dcq = dcq.reshape(B, W, L // W)[:, :, 0].contiguous()[:, :, None] \
            .expand(B, W, L // W)
        b2 = b2[:, 0].contiguous()[:, None].expand(B, L)
    elif form == "BL_expanded":
        b2 = b2[:, 0].contiguous()[:, None].expand(B, L)
    elif form == "ed_BWM":
        ed = ed.reshape(B, W, L // W)
    elif form == "transposed":
        ed, dcq = ed.t().contiguous().t(), dcq.t().contiguous().t()
    elif form == "valid_bool":
        valid = valid != 0
    elif form == "valid_uint8":
        valid = valid.to(torch.uint8)
    return ed, dcq, b2, valid


def _dense(x, B, L):
    """An operand of any form as the dense [B, L] numpy array it stands
    for."""
    x = x[:, None].expand(B, L) if x.ndim == 1 else x.reshape(B, L)
    return x.contiguous().numpy()


@pytest.mark.parametrize("form", PRUNE_FORMS)
def test_crouting_prune_operand_forms_match_pallas_interpret(form):
    """Every operand form against ``crouting_prune_pallas`` in interpret
    mode on the dense [B, L] inputs it stands for: the bool prune mask
    bit-equal, est2 within 1e-6 (and bit-equal with the eager jnp
    oracle)."""
    B, L = 8, 128
    raw = [torch.as_tensor(a) for a in _prune_inputs(7, B, L)]
    ed, dcq, b2, valid = _prune_form(raw, form)
    te, tm = ops.crouting_prune(ed, dcq, b2, valid, 0.3127)
    assert te.shape == tm.shape == (B, L) and tm.dtype == torch.bool
    dense = [jnp.asarray(_dense(x, B, L)) for x in (ed, dcq, b2)]
    dv = jnp.asarray((valid.numpy() != 0).astype(np.int8))
    je, jm = crouting_prune_pallas(*dense, dv, 0.3127, interpret=True)
    np.testing.assert_array_equal(np.asarray(jm) != 0, tm.numpy())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-6)
    oe, _ = jref.crouting_prune_ref(*dense, dv, 0.3127)
    np.testing.assert_array_equal(np.asarray(oe).view(np.int32),
                                  te.numpy().view(np.int32))


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
@pytest.mark.parametrize("form", GATHER_FORMS)
@pytest.mark.parametrize("M,d", [(M, d) for M in (4, 100, 128)
                                 for d in (128, 960, 100)]
                         + [(M, d) for M in (4, 128) for d in (1536, 2050)])
def test_gather_distance_kernel_is_bit_equal_on_gpu(cuda, M, d, form):
    """Every mask form and polarity, out-of-range and negative ids handed
    over unmasked, a table off alignment: bit-equal with the plain
    version.  d past 1024 sweeps the row 1024 elements at a time, the
    query reloaded each sweep (float4 at 1536, scalar at 2050)."""
    from repro_torch.kernels.gather_distance import gather_distance_cuda
    raw = [torch.as_tensor(a, device=cuda)
           for a in _gather_inputs(M + d, 128, M, 5000, d, in_range=False)]
    idx, q, table, mask, computes = _gather_form(raw, form)
    got = gather_distance_cuda(*ops.cuda_args_gather_distance(
        idx, q, table, mask, computes))
    exp = ref.gather_distance_ref(*ops.prepare_gather_distance(
        idx, q, table, mask, computes))
    assert torch.equal(got, exp)


@pytest.mark.gpu
@pytest.mark.parametrize("form", PRUNE_FORMS)
@pytest.mark.parametrize("M", [128, 256])
def test_crouting_prune_kernel_is_bit_equal_on_gpu(cuda, M, form):
    from repro_torch.kernels.crouting_prune import crouting_prune_cuda
    raw = [torch.as_tensor(a, device=cuda) for a in _prune_inputs(M, 128, M)]
    args = _prune_form(raw, form)
    ke, kp = crouting_prune_cuda(*ops.cuda_args_crouting_prune(*args, 0.31))
    pe, pp = ref.crouting_prune_ref(*ops.prepare_crouting_prune(*args, 0.31))
    assert kp.dtype == torch.bool and torch.equal(kp, pp)
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))
