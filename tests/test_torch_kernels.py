"""The port's kernel wrappers and plain versions against the JAX oracles.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run the plain
PyTorch versions, which are held here against ``repro.kernels.ref`` (and
``pool_merge`` also against the Pallas kernel in interpret mode).  The JAX
``fused_expand_pallas`` cannot run on the installed JAX (it uses
``pltpu.TPUMemorySpace``, removed in JAX 0.9; ROADMAP Queue 3), so its
oracle ``fused_expand_ref`` is the reference for ``fused_expand``.  The
CUDA kernels themselves run only on the card: the ``gpu``-marked tests at
the bottom skip without one (``chip_smoke.py`` runs the same checks).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.pool_merge import pool_merge_pallas

from repro_torch.kernels import build, ops, ref


def _expand_inputs(seed, B, L, N, d, in_range=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, d)).astype(np.float32)
    table[-1] = 0.0
    hi = N if in_range else N + 4
    nbrs = rng.integers(0, hi, size=(B, L)).astype(np.int32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    ed = rng.uniform(0, 6, size=(B, L)).astype(np.float32)
    ed[:, ::7] = np.inf
    dcq = rng.uniform(0.5, 6, size=(B, L)).astype(np.float32)
    b2 = rng.uniform(0, 40, size=(B, L)).astype(np.float32)
    b2[0] = np.inf
    ev = (rng.random((B, L)) < 0.7).astype(np.int8)
    el = (rng.random((B, L)) < 0.6).astype(np.int8)
    if in_range:
        ev &= (nbrs < N)
        el &= (nbrs < N)
    return nbrs, q, ed, dcq, b2, table, ev, el


@pytest.mark.parametrize("B,L,N,d", [(3, 8, 100, 16), (5, 16, 400, 64),
                                     (4, 64, 300, 100), (2, 128, 50, 130)])
def test_fused_expand_matches_jax_oracle(B, L, N, d):
    nbrs, q, ed, dcq, b2, table, ev, el = _expand_inputs(B * L, B, L, N, d)
    ct = 0.156
    jd, jp = jref.fused_expand_ref(
        jnp.asarray(nbrs), jnp.asarray(q), jnp.asarray(ed), jnp.asarray(dcq),
        jnp.asarray(b2), ct, jnp.asarray(table), eval_mask=jnp.asarray(ev),
        prune_eligible=jnp.asarray(el))
    td, tp = ops.fused_expand(*map(torch.as_tensor, (nbrs, q, ed, dcq, b2)),
                              ct, torch.as_tensor(table),
                              eval_mask=torch.as_tensor(ev),
                              prune_eligible=torch.as_tensor(el))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    jd = np.asarray(jd)
    np.testing.assert_array_equal(np.isinf(jd), np.isinf(td.numpy()))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=1e-6)
    assert tp.dtype == torch.bool and td.dtype == torch.float32


def test_fused_expand_masks_out_of_range_ids():
    """Unlike the JAX oracle, the wrapper intersects caller masks with the
    in-range ids (as repro.kernels.ops.fused_expand does)."""
    nbrs, q, ed, dcq, b2, table, ev, el = _expand_inputs(
        1, 4, 32, 60, 16, in_range=False)
    nbrs[1, :5] = -3
    ones = np.ones_like(ev)
    td, tp = ops.fused_expand(*map(torch.as_tensor, (nbrs, q, ed, dcq, b2)),
                              0.3, torch.as_tensor(table),
                              eval_mask=torch.as_tensor(ones),
                              prune_eligible=torch.as_tensor(ones))
    out = (nbrs < 0) | (nbrs >= 60)
    assert out.any()
    assert np.isinf(td.numpy()[out]).all() and not tp.numpy()[out].any()
    # in-range lanes agree with the oracle given in-range masks
    inr = (~out).astype(np.int8)
    jd, jp = jref.fused_expand_ref(
        jnp.asarray(np.where(out, 0, nbrs)), jnp.asarray(q), jnp.asarray(ed),
        jnp.asarray(dcq), jnp.asarray(b2), 0.3, jnp.asarray(table),
        eval_mask=jnp.asarray(inr), prune_eligible=jnp.asarray(inr))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin],
                               rtol=1e-6)


def test_fused_expand_default_masks_and_broadcast_lanes():
    nbrs, q, ed, dcq, b2, table, _, _ = _expand_inputs(2, 3, 16, 40, 8)
    dcq1, b21 = dcq[:, 0], b2[:, 0]
    jd, jp = jref.fused_expand_ref(
        jnp.asarray(nbrs), jnp.asarray(q), jnp.asarray(ed), jnp.asarray(dcq1),
        jnp.asarray(b21), 0.5, jnp.asarray(table))
    td, tp = ops.fused_expand(
        *map(torch.as_tensor, (nbrs, q, ed, dcq1, b21)), 0.5,
        torch.as_tensor(table))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(fin, np.isfinite(td.numpy()))
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin],
                               rtol=1e-6)


def _operand_form(raw, form, W=None):
    """The raw ``_expand_inputs`` tensors in one of the forms the search
    loop and other callers hand ``ops.fused_expand``: (args, kwargs)."""
    nbrs, q, ed, dcq, b2, table, ev, el = raw
    B, L = nbrs.shape
    kw = dict(eval_mask=ev, prune_eligible=el)
    if form == "bool":
        kw = dict(eval_mask=ev != 0, prune_eligible=el != 0)
    elif form == "no_prune":
        kw = dict(eval_mask=ev != 0, prune_eligible=None, prunes=False)
    elif form == "default_masks":
        kw = {}
    elif form == "per_query":                 # dcq, bound2 [B]
        dcq, b2 = dcq[:, 0].contiguous(), b2[:, 0].contiguous()
    elif form == "beam_view":                 # [B, W] over M, expanded bound2
        W = W or max(1, L // 32)
        dcq = dcq.reshape(B, W, L // W)[:, :, 0].contiguous()[:, :, None] \
            .expand(B, W, L // W)
        b2 = b2[:, 0].contiguous()[:, None].expand(B, L)
    elif form == "unaligned":                 # a table one element off
        flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                           device=table.device)
        flat[1:] = table.reshape(-1)
        table = flat[1:].view(table.shape)
    return (nbrs, q, ed, dcq, b2, 0.31, table), kw


OPERAND_FORMS = ("int8", "bool", "no_prune", "default_masks", "per_query",
                 "beam_view", "unaligned")


@pytest.mark.parametrize("form", OPERAND_FORMS)
def test_fused_expand_operand_forms_match_jax_oracle(form):
    """Every operand form the wrapper takes (bool masks, no prune mask,
    prunes=False, [B] and [B, W, M]-view side operands, an unaligned
    table) gives the JAX oracle's result on the equivalent dense inputs,
    with a bool prune mask."""
    raw = [torch.as_tensor(a) for a in _expand_inputs(11, 4, 64, 90, 20)]
    raw[0][1, :4] = -2                        # negative ids
    args, kw = _operand_form(raw, form)
    td, tp = ops.fused_expand(*args, **kw)
    nbrs, q, ed, dcq, b2, ct, table = args
    B, L = nbrs.shape
    inr = ((nbrs >= 0) & (nbrs < table.shape[0])).numpy()
    ev = kw.get("eval_mask", None)
    ev = inr if ev is None else (ev.numpy() != 0) & inr
    el = kw.get("prune_eligible", None)
    el = (np.zeros_like(inr) if not kw.get("prunes", True) else
          inr if el is None else (el.numpy() != 0) & inr)
    dense = [x.reshape(B, -1).expand(B, L).contiguous().numpy()
             if x.ndim == 3 else x.numpy() for x in (dcq, b2)]
    jd, jp = jref.fused_expand_ref(
        jnp.asarray(np.where(inr, nbrs.numpy(), 0)), jnp.asarray(q.numpy()),
        jnp.asarray(ed.numpy()), *map(jnp.asarray, dense), ct,
        jnp.asarray(table.contiguous().numpy()),
        eval_mask=jnp.asarray(ev.astype(np.int8)),
        prune_eligible=jnp.asarray(el.astype(np.int8)))
    assert tp.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(jp) != 0, tp.numpy())
    jd = np.asarray(jd)
    np.testing.assert_array_equal(np.isinf(jd), np.isinf(td.numpy()))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=1e-6)
    if form == "no_prune":
        assert not tp.any()


@pytest.mark.parametrize("shape", ["B", "BL", "BWM", "BL_expanded",
                                   "BL_transposed"])
def test_lane_strides_read_each_lane(shape):
    """``fused_expand.lane_strides`` gives the offsets the kernel reads lane
    (b, l) at: b*sb + (l // m)*sw + (l % m)*sm into the operand's storage."""
    from repro_torch.kernels.fused_expand import lane_strides
    B, W, M = 3, 4, 8
    L = W * M
    base = torch.arange(4 * B * L, dtype=torch.float32)
    x = {"B": base[:B], "BL": base[:B * L].view(B, L),
         "BWM": base[:B * W].view(B, W)[:, :, None].expand(B, W, M),
         "BL_expanded": base[:B][:, None].expand(B, L),
         "BL_transposed": base[:B * L].view(L, B).t()}[shape]
    dense = x[:, None].expand(B, L) if x.ndim == 1 else x.reshape(B, L)
    sb, sw, sm, m = lane_strides(x, B, L)
    for b in range(B):
        for lane in range(L):
            off = x.storage_offset() + b * sb + (lane // m) * sw \
                + (lane % m) * sm
            assert base[off] == dense[b, lane]
    with pytest.raises(ValueError):
        lane_strides(base[:B * L].view(B, L // 2, 2)[:, :-1], B, L)


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Every aten op dispatched inside the mode, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_wrappers_prepare_cuda_launch_without_tensor_ops():
    """On the search loop's own argument forms (int32 ids, f32 operands,
    a [B, W, M] zero-stride dcq, an expanded [B, L] bound2, bool masks,
    no prune mask), the CUDA side of ``ops.fused_expand``,
    ``ops.sq8_estimate``, the three gather wrappers (a bool compute mask,
    an int8 skip mask, none) and ``ops.crouting_prune`` (a [B, W, M]
    zero-stride dcq, an expanded or a [B] bound2, a bool valid mask) runs
    no tensor op before the launch but the output allocations.  Checked on
    CPU tensors routed through the same argument functions; the plain
    versions' preparation runs many."""
    from repro_torch.kernels import crouting_prune as CP
    from repro_torch.kernels import fused_expand as FE
    from repro_torch.kernels import gather_distance as GD
    from repro_torch.kernels import sq8_distance as SK
    B, W, M, d, n = 4, 4, 8, 16, 50
    L = W * M
    g = torch.Generator().manual_seed(0)
    nbrs = torch.randint(-1, n + 2, (B, L), generator=g, dtype=torch.int32)
    queries = torch.randn(B, d, generator=g)
    table = torch.randn(n, d, generator=g)
    ed = torch.rand(B, L, generator=g)
    dcq = torch.rand(B, W, generator=g)[:, :, None].expand(B, W, M)
    bound2 = torch.rand(B, generator=g)[:, None].expand(B, L)
    compute = torch.rand(B, L, generator=g) < 0.5
    try_prune = torch.rand(B, L, generator=g) < 0.5
    codes = torch.randint(0, 256, (n, d), generator=g, dtype=torch.uint8)
    lo, scale, eps = (torch.rand(d, generator=g) for _ in range(3))
    calls = {
        "fused_expand": lambda **kw: FE.launch_args(
            *ops.cuda_args_fused_expand(nbrs, queries, ed, dcq, bound2, 0.3,
                                        table, eval_mask=compute, **kw)),
        "sq8_estimate": lambda: SK.launch_args(*ops.cuda_args_sq8_estimate(
            nbrs, queries, compute, codes, lo, scale, eps)),
        "gather_distance": lambda **kw: GD.launch_args(
            *ops.cuda_args_gather_distance(nbrs, queries, table, **kw)),
        "crouting_prune": lambda b2: CP.launch_args(
            *ops.cuda_args_crouting_prune(ed, dcq, b2, try_prune, 0.3))}
    skip = (torch.rand(B, L, generator=g) < 0.5).to(torch.int8)
    for name, fn, kw, n_out in (
            ("fused_expand", calls["fused_expand"],
             dict(prune_eligible=None, prunes=False), 2),
            ("fused_expand", calls["fused_expand"],
             dict(prune_eligible=try_prune), 2),
            ("sq8_estimate", calls["sq8_estimate"], {}, 2),
            ("gather_distance_where", calls["gather_distance"],
             dict(mask=compute, computes=True), 1),
            ("gather_distance_pruned", calls["gather_distance"],
             dict(mask=skip, computes=False), 1),
            ("gather_distance", calls["gather_distance"], {}, 1),
            ("crouting_prune", calls["crouting_prune"],
             dict(b2=bound2), 2),
            ("crouting_prune", calls["crouting_prune"],
             dict(b2=bound2[:, 0].contiguous()), 2)):
        with _OpCount() as c:
            outs, _ = fn(**kw)
        assert c.ops == ["aten.empty.memory_format"] * n_out, (name, c.ops)
        outs = outs if n_out > 1 else (outs,)
        assert all(o.shape == (B, L) for o in outs)
    with _OpCount() as c:
        ops.prepare_fused_expand(nbrs, queries, ed, dcq, bound2, 0.3, table,
                                 eval_mask=compute, prunes=False)
        ops.prepare_sq8_estimate(nbrs, queries, compute, codes, lo, scale,
                                 eps)
    assert sum(o != "aten.empty.memory_format" for o in c.ops) >= 10
    with _OpCount() as c:
        ops.prepare_gather_distance(nbrs, queries, table, compute, True)
        ops.prepare_crouting_prune(ed, dcq, bound2, try_prune, 0.3)
    assert sum(o != "aten.empty.memory_format" for o in c.ops) >= 8


@pytest.mark.parametrize("B,M", [(8, 128), (3, 40)])
def test_crouting_prune_estimate_is_bit_equal(B, M):
    rng = np.random.default_rng(B + M)
    ed = rng.uniform(0, 5, size=(B, M)).astype(np.float32)
    dcq = rng.uniform(0, 5, size=(B, M)).astype(np.float32)
    b2 = rng.uniform(0, 30, size=(B, M)).astype(np.float32)
    valid = (rng.random((B, M)) < 0.8).astype(np.int8)
    je, jm = jref.crouting_prune_ref(*map(jnp.asarray, (ed, dcq, b2, valid)),
                                     0.2)
    te, tm = ref.crouting_prune_ref(*map(torch.as_tensor, (ed, dcq, b2, valid)),
                                    0.2)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def _merge_inputs(seed, B, P, L, n=1000):
    rng = np.random.default_rng(seed)
    pd = np.round(rng.uniform(0, 3, size=(B, P)), 1).astype(np.float32)
    pi = (rng.integers(0, n, size=(B, P)) * 4
          + rng.integers(0, 2, size=(B, P))).astype(np.int32)
    pd[:, P // 2:], pi[:, P // 2:] = np.inf, n * 4
    nd = np.round(rng.uniform(0, 3, size=(B, L)), 1).astype(np.float32)
    ni = (rng.integers(0, n, size=(B, L)) * 4 + 2).astype(np.int32)
    nd[:, ::3], ni[:, ::3] = np.inf, n * 4
    order = np.lexsort((pi, pd), axis=1)
    pd = np.take_along_axis(pd, order, axis=1)
    pi = np.take_along_axis(pi, order, axis=1)
    return pd, pi, nd, ni


@pytest.mark.parametrize("B,P,L", [(8, 16, 16), (8, 24, 64), (16, 100, 128),
                                   (3, 64, 256)])
def test_pool_merge_matches_jax_oracle_and_pallas(B, P, L):
    pd, pi, nd, ni = _merge_inputs(P + L, B, P, L)
    td, ti = ops.pool_merge(*map(torch.as_tensor, (pd, pi, nd, ni)))
    jd, ji = jref.pool_merge_ref(*map(jnp.asarray, (pd, pi, nd, ni)))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    if B % 8 == 0 and P + L <= 256:
        kd, ki = pool_merge_pallas(*map(jnp.asarray, (pd, pi, nd, ni)),
                                   interpret=True)
        np.testing.assert_array_equal(np.asarray(kd), td.numpy())
        np.testing.assert_array_equal(np.asarray(ki), ti.numpy())


def test_l2sq_rows_follows_the_kernel_order():
    """ref.l2sq_rows must sum exactly as the CUDA kernel does: lane t of a
    warp accumulates elements 128*j + 4*t + c in (j, c) order, then a
    shfl_xor butterfly.  Emulated here element by element in float32."""
    rng = np.random.default_rng(5)
    for d in (8, 100, 128, 261):
        q = rng.normal(size=(2, d)).astype(np.float32)
        x = rng.normal(size=(2, 3, d)).astype(np.float32)
        got = ref.l2sq_rows(torch.as_tensor(q), torch.as_tensor(x)).numpy()
        for b in range(2):
            for m in range(3):
                acc = np.zeros(32, np.float32)
                for t in range(32):
                    for base in range(0, d, 128):
                        for c in range(4):
                            e = base + 4 * t + c
                            if e < d:
                                df = np.float32(q[b, e] - x[b, m, e])
                                acc[t] = np.float32(acc[t] + df * df)
                for off in (16, 8, 4, 2, 1):
                    acc = (acc + acc[np.arange(32) ^ off]).astype(np.float32)
                assert got[b, m] == acc[0]
                np.testing.assert_allclose(
                    got[b, m], np.sum((q[b] - x[b, m]) ** 2), rtol=1e-5)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    nbrs, q, ed, dcq, b2, table, ev, el = _expand_inputs(3, 2, 8, 20, 8)
    ops.fused_expand(*map(torch.as_tensor, (nbrs, q, ed, dcq, b2)), 0.1,
                     torch.as_tensor(table))
    pd, pi, nd, ni = _merge_inputs(0, 2, 8, 8)
    ops.pool_merge(*map(torch.as_tensor, (pd, pi, nd, ni)))
    t = torch.as_tensor
    ops.sq8_estimate(t(nbrs), t(q), t(ev), t(table).to(torch.uint8),
                     t(table[0]), t(table[1]).abs(), t(table[2]).abs())
    ops.gather_distance(t(nbrs), t(q), t(table))
    ops.gather_distance_pruned(t(nbrs), t(ev), t(q), t(table))
    ops.crouting_prune(t(ed), t(dcq), t(b2), t(el), 0.1)
    ops.l2_distance(t(q), t(table), mode="ip")
    assert ops.LAUNCHES == {"fused_expand": 0, "pool_merge": 0,
                            "sq8_distance": 0, "gather_distance": 0,
                            "crouting_prune": 0, "l2_distance": 0}


def test_build_compiles_nothing_on_import_and_needs_nvcc(monkeypatch):
    """Importing the kernel modules built nothing; without nvcc a build
    raises instead of falling back to the plain version."""
    import repro_torch.kernels.fused_expand  # noqa: F401
    import repro_torch.kernels.pool_merge  # noqa: F401
    assert build.BUILD_LOG == {}
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    for name in build.KERNEL_SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build._lib_path(name).name.startswith(name + "-")


def test_library_name_hashes_every_included_header(tmp_path, monkeypatch):
    """An edited header must not be served from a stale library: the
    library name hashes the source and every csrc file it includes."""
    for name in ("fused_expand", "gather_distance", "sq8_distance"):
        assert "warp_rows.cuh" in build.source_files(name)
    for name in ("fused_expand", "crouting_prune"):
        assert "lanes.cuh" in build.source_files(name)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.source_files("k") == ["a.cuh", "b.cuh", "k.cu"]
    before = build._lib_path("k")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert build._lib_path("k") != before


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("form", OPERAND_FORMS)
@pytest.mark.parametrize("L,d", [(L, d) for L in (32, 128, 256)
                                 for d in (128, 960, 100)]
                         + [(128, 200), (128, 384), (128, 1536), (128, 2050)])
def test_fused_expand_kernel_matches_plain_on_gpu(cuda, L, d, form):
    """Bit-equal with the plain version on every operand form, with ids
    past the table and negative ids handed to the kernel unmasked."""
    from repro_torch.kernels.fused_expand import fused_expand_cuda
    raw = [torch.as_tensor(a, device=cuda)
           for a in _expand_inputs(L + d, 128, L, 5000, d, in_range=False)]
    raw[0][5, 1::3] = -7
    if form in ("int8", "bool"):
        raw[6][7], raw[7][7] = 1, 1           # every out-of-range id offered
    args, kw = _operand_form(raw, form)
    kd, kp = fused_expand_cuda(*args, **kw)
    pd, pp = ref.fused_expand_ref(*ops.prepare_fused_expand(*args, **kw))
    assert kp.dtype == torch.bool and torch.equal(kp, pp)
    assert torch.equal(kd, pd)       # same summation order: bit-equal


@pytest.mark.gpu
@pytest.mark.parametrize("P,L", [(P, L) for P in (64, 100, 200)
                                 for L in (32, 128, 256)]
                         + [(300, 400), (500, 256), (500, 284), (100, 728),
                            (2000, 2000)])
@pytest.mark.parametrize("pool", ["sorted", "shuffled"])
def test_pool_merge_kernel_is_bit_exact_on_gpu(cuda, P, L, pool):
    """Both variants (warp up to P + L = 512, block to 4096; the NSG
    build's acquisition merges [B, 500] pools with tiles of 4 x 64, and a
    search on an NSG merges its efs pool with tiles of 4 x the graph's
    degree, which need not be a multiple of 32), on sorted pools and on
    shuffled ones, as the stage-2 rerank leaves them."""
    from repro_torch.kernels.pool_merge import pool_merge_cuda
    pd, pi, nd, ni = _merge_inputs(P * L, 128, P, L)
    if pool == "shuffled":
        perm = np.argsort(np.random.default_rng(P + L).random(pd.shape), 1)
        pd = np.take_along_axis(pd, perm, axis=1)
        pi = np.take_along_axis(pi, perm, axis=1)
    t = [torch.as_tensor(a, device=cuda) for a in (pd, pi, nd, ni)]
    kd, ki = pool_merge_cuda(*t)
    pd, pi = ref.pool_merge_ref(*t)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(ki, pi)


def test_load_builds_once_across_threads(monkeypatch):
    """Threads reaching a kernel's first load together (a serving worker
    and a background merge) build and load it once; the load counts as
    one first load, on the thread that made it."""
    import ctypes.util
    import threading
    import time
    calls = []

    def fake_build_all(names):
        calls.append(tuple(names))
        time.sleep(0.05)               # the others arrive during the build
        return {n: ctypes.util.find_library("c") or "libc.so.6"
                for n in names}

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build, "_LIBS", {})
    got, firsts = [], []

    def one():
        before = build.first_loads_on_this_thread()
        got.append(build.load("fake"))
        firsts.append(build.first_loads_on_this_thread() - before)

    threads = [threading.Thread(target=one) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert calls == [("fake",)]
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert sorted(firsts) == [0] * 7 + [1]
    assert build.load("fake") is got[0] and calls == [("fake",)]


def test_launch_counts_per_thread():
    """Each launch counts in ``LAUNCHES`` and in its thread's own counts,
    so a merge thread's build launches read apart from the searches."""
    import threading
    base = dict(ops.LAUNCHES)
    mine = ops.thread_launch_counts()
    seen = {}

    def worker():
        for _ in range(3):
            ops._launched("pool_merge")
        seen.update(ops.thread_launch_counts())

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    try:
        assert seen["pool_merge"] == 3 and seen["fused_expand"] == 0
        assert ops.thread_launch_counts() == mine
        assert ops.LAUNCHES["pool_merge"] == base["pool_merge"] + 3
    finally:
        ops.LAUNCHES.update(base)


def test_launches_recorded_in_a_capture_count_at_each_replay():
    """Launches issued while a CUDA graph is captured run nothing then:
    ``recording_launches`` collects them apart, and ``add_launches``
    counts them at each replay, in ``LAUNCHES`` and the thread's counts."""
    base = dict(ops.LAUNCHES)
    mine = ops.thread_launch_counts()
    try:
        with ops.recording_launches() as rec:
            ops._launched("pool_merge")
            ops._launched("fused_expand")
            ops._launched("pool_merge")
        assert rec == {"pool_merge": 2, "fused_expand": 1}
        assert ops.LAUNCHES == base and ops.thread_launch_counts() == mine
        for _ in range(3):
            ops.add_launches(rec)
        ops._launched("pool_merge")
        assert ops.LAUNCHES["pool_merge"] == base["pool_merge"] + 7
        assert ops.LAUNCHES["fused_expand"] == base["fused_expand"] + 3
        now = ops.thread_launch_counts()
        assert now["pool_merge"] == mine["pool_merge"] + 7
        assert now["fused_expand"] == mine["fused_expand"] + 3
    finally:
        ops.LAUNCHES.update(base)
