"""The port's SQ8 quantization and two-stage search path against the JAX
package.

The NumPy side of ``repro_torch.quant.sq8`` must give the same bits as
``repro.quant.sq8`` (codes, lo, scale, eps); ``ref.sq8_estimate_ref`` must
agree with ``repro.kernels.ref.sq8_estimate_ref`` within rtol/atol 1e-5
(the port sums in the CUDA kernel's order, XLA in its own) and follow the
kernel's order exactly; the two-stage search keeps the JAX suite's recall
floor and returns exact distances.  Inputs come from numpy with a fixed
seed.  The CUDA kernel runs only on the card: the ``gpu``-marked test skips
without one (``chip_smoke.py`` runs the same check).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.quant import sq8 as JSQ

from repro_torch.core import search as S
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.data.vectors import (exact_ground_truth, make_dataset,
                                      recall_at_k)
from repro_torch.kernels import ops, ref
from repro_torch.quant import sq8 as SQ


def _table(seed, n, d, kind="unit"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "wide":
        x *= 50.0
    elif kind == "skewed":
        x *= np.geomspace(1e-3, 1e3, d).astype(np.float32)[None, :]
    elif kind == "constant":
        x[:, ::5] = 2.5
    return x


@pytest.mark.parametrize("n,d,kind", [(300, 16, "unit"), (200, 64, "wide"),
                                      (128, 128, "skewed"),
                                      (90, 100, "constant")])
def test_sq8_codes_and_grid_are_bit_equal(n, d, kind):
    x = _table(n + d, n, d, kind)
    p, jp = SQ.sq8_train(x), JSQ.sq8_train(x)
    for f in ("lo", "scale", "eps"):
        assert getattr(p, f).tobytes() == getattr(jp, f).tobytes(), f
        assert getattr(p, f).dtype == np.float32
    codes = SQ.sq8_encode(x, p)
    assert codes.dtype == np.uint8
    assert codes.tobytes() == JSQ.sq8_encode(x, jp).tobytes()
    xhat = SQ.sq8_decode(codes, p)
    assert xhat.tobytes() == JSQ.sq8_decode(codes, jp).tobytes()
    assert (np.abs(x - xhat) <= p.eps[None, :]).all()
    if kind == "constant":
        assert (p.scale[::5] == np.float32(1e-12)).all()


def _sq8_inputs(seed, B, L, N, d, kind="unit"):
    rng = np.random.default_rng(seed)
    x = _table(seed, N - 1, d, kind)
    p = SQ.sq8_train(x)
    codes = SQ.sq8_encode(np.concatenate([x, np.zeros((1, d), np.float32)]),
                          p)
    nbrs = rng.integers(0, N, size=(B, L)).astype(np.int32)
    nbrs[:, ::9] = N - 1                     # the pad row
    q = (rng.normal(size=(B, d)) * x.std()).astype(np.float32)
    ev = (rng.random((B, L)) < 0.7).astype(np.int8)
    ev[0] = 0                                # an all-masked row
    return nbrs, q, ev, codes, p.lo, p.scale, p.eps


@pytest.mark.parametrize("B,L,N,d,kind", [(3, 8, 100, 16, "unit"),
                                          (4, 32, 300, 100, "constant"),
                                          (2, 64, 200, 130, "wide"),
                                          (2, 16, 60, 128, "skewed")])
def test_sq8_estimate_ref_matches_jax_oracle(B, L, N, d, kind):
    args = _sq8_inputs(B * L + d, B, L, N, d, kind)
    ja, jl = jref.sq8_estimate_ref(*map(jnp.asarray, args))
    ta, tl = ops.sq8_estimate(*map(torch.as_tensor, args))
    for j, t in ((ja, ta), (jl, tl)):
        j = np.asarray(j)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(np.isinf(j), np.isinf(t.numpy()))
        fin = np.isfinite(j)
        np.testing.assert_allclose(t.numpy()[fin], j[fin], rtol=1e-5,
                                   atol=1e-5)
    assert np.isinf(ta.numpy()[0]).all() and np.isinf(tl.numpy()[0]).all()
    assert (tl.numpy() <= ta.numpy()).all()


def test_sq8_estimate_ref_follows_the_kernel_order():
    """ad2 and lb2 are summed as the CUDA kernel sums them: lane t of a warp
    accumulates elements 128*j + 4*t + c in (j, c) order with every product
    and sum rounded on its own, then a shfl_xor butterfly.  Emulated here
    element by element in float32."""
    f = np.float32
    for d in (8, 100, 128, 261):
        nbrs, q, _, codes, lo, scale, eps = _sq8_inputs(d, 2, 3, 40, d)
        t = torch.as_tensor
        ad2, lb2 = ref.sq8_estimate_ref(t(nbrs), t(q), None, t(codes), t(lo),
                                        t(scale), t(eps))
        for b in range(2):
            for m in range(3):
                row = codes[nbrs[b, m]]
                acc, sl = np.zeros(32, f), np.zeros(32, f)
                for t in range(32):
                    for base in range(0, d, 128):
                        for c in range(4):
                            e = base + 4 * t + c
                            if e < d:
                                xh = f(lo[e] + f(f(row[e]) * scale[e]))
                                de = f(q[b, e] - xh)
                                acc[t] = f(acc[t] + f(de * de))
                                sl[t] = f(sl[t] + f(abs(de) * eps[e]))
                for off in (16, 8, 4, 2, 1):
                    acc = (acc + acc[np.arange(32) ^ off]).astype(f)
                    sl = (sl + sl[np.arange(32) ^ off]).astype(f)
                want_lb = max(f(acc[0] - f(f(2.0) * sl[0])), f(0.0))
                assert ad2[b, m].item() == acc[0]
                assert lb2[b, m].item() == want_lb


def test_sq8_wrapper_masks_out_of_range_ids():
    nbrs, q, ev, codes, lo, scale, eps = _sq8_inputs(3, 3, 16, 50, 24)
    nbrs[1, :4] = -2
    nbrs[2, ::3] = 50 + 7
    ad2, lb2 = ops.sq8_estimate(*map(torch.as_tensor, (
        nbrs, q, np.ones_like(ev), codes, lo, scale, eps)))
    out = (nbrs < 0) | (nbrs >= 50)
    assert np.isinf(ad2.numpy()[out]).all() and np.isinf(lb2.numpy()[out]).all()
    assert np.isfinite(ad2.numpy()[~out]).all()


def test_sq8_tables_are_added_only_when_asked():
    ds = make_dataset(n_base=300, n_query=4, dim=16, n_clusters=4, seed=2)
    idx = AnnIndex.build(ds.base, graph="hnsw", m=6, efc=24, device="cpu")
    cfg = SearchSpec(router="crouting", use_hierarchy=True)
    arrays, _ = S.build_search_fn(idx.graph, cfg, device="cpu")
    assert "sq8_codes" not in arrays
    arrays2, _ = S.build_search_fn(idx.graph, cfg.replace(estimate="both"),
                                   device="cpu")
    assert arrays2 is arrays and arrays["sq8_codes"].dtype == torch.uint8
    assert arrays["sq8_codes"].shape == (idx.graph.n + 1, 16)
    p = JSQ.sq8_train(idx.graph.vectors)
    assert arrays["sq8_scale"].numpy().tobytes() == p.scale.tobytes()
    assert (arrays["sq8_codes"].numpy()[-1] ==
            JSQ.sq8_encode(np.zeros((1, 16), np.float32), p)[0]).all()


# --- the two-stage path end to end (tests/test_quant.py's suite) ------------
@pytest.fixture(scope="module")
def suite():
    out = []
    for dim, seed in ((48, 0), (96, 11)):
        ds = make_dataset(n_base=1500, n_query=32, dim=dim, n_clusters=24,
                          seed=seed)
        idx = AnnIndex.build(ds.base, graph="hnsw", m=12, efc=80,
                             device="cpu")
        out.append((ds, idx, exact_ground_truth(ds, k=10, device="cpu")))
    return out


@pytest.mark.parametrize("engine", ["fused", "unfused", "torch"])
@pytest.mark.parametrize("estimate,router", [("sq8", "none"),
                                             ("both", "crouting")])
def test_sq8_recall_floor_at_efs64(suite, estimate, router, engine):
    """estimate="sq8"|"both" keeps the exact path's recall@10 within 0.01
    at efs=64, with fewer fp32 row reads than the exact path's calls."""
    for ds, idx, gt in suite:
        ids_e, _, st_e = idx.search(ds.queries, spec=SearchSpec(
            k=10, efs=64, router="none", estimate="exact", engine=engine))
        ids_q, _, st_q = idx.search(ds.queries, spec=SearchSpec(
            k=10, efs=64, router=router, estimate=estimate, engine=engine))
        rec_e, rec_q = recall_at_k(ids_e, gt, 10), recall_at_k(ids_q, gt, 10)
        assert rec_q >= rec_e - 0.01, (rec_e, rec_q)
        assert st_q.rerank_calls.mean() < st_e.dist_calls.mean()
        assert st_q.dist_calls.mean() < st_e.dist_calls.mean()
        assert st_q.sq8_calls.mean() > 0 and st_q.rerank_calls.mean() > 0
        assert st_e.sq8_calls.sum() == 0 and st_e.rerank_calls.sum() == 0


@pytest.mark.parametrize("engine", ["fused", "unfused", "torch"])
def test_sq8_returned_distances_are_exact(suite, engine):
    """Approximate pool entries are reranked before they are returned: the
    reported distances are the true distances of the returned ids."""
    ds, idx, _ = suite[0]
    ids, dists, _ = idx.search(ds.queries, spec=SearchSpec(
        k=10, efs=64, router="none", estimate="sq8", engine=engine))
    for qi in range(0, len(ds.queries), 7):
        for j in range(10):
            if ids[qi, j] < 0:
                continue
            true = float(((ds.queries[qi] - ds.base[ids[qi, j]]) ** 2).sum())
            assert abs(true - float(dists[qi, j])) <= 1e-3 * (1 + true)


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


def _sq8_form(raw, form):
    """The raw ``_sq8_inputs`` tensors with the eval mask as int8, bool or
    None, or the code table one byte off alignment; negative and
    out-of-range ids are handed to the kernel unmasked."""
    nbrs, q, ev, codes, lo, scale, eps = raw
    N = codes.shape[0]
    nbrs[2, ::3] = N + 5
    nbrs[2, 1::3] = -1
    ev[2] = 1
    if form == "bool":
        ev = ev != 0
    elif form == "no_mask":
        ev = None
    elif form == "unaligned":
        flat = torch.empty(codes.numel() + 1, dtype=codes.dtype,
                           device=codes.device)
        flat[1:] = codes.reshape(-1)
        codes = flat[1:].view(codes.shape)
    return nbrs, q, ev, codes, lo, scale, eps


SQ8_FORMS = ("int8", "bool", "no_mask", "unaligned")


@pytest.mark.gpu
@pytest.mark.parametrize("form", SQ8_FORMS)
@pytest.mark.parametrize("L,d", [(L, d) for L in (32, 128, 256)
                                 for d in (128, 960, 100)]
                         + [(128, 200), (128, 384)])
def test_sq8_distance_kernel_is_bit_equal_on_gpu(cuda, L, d, form):
    from repro_torch.kernels.sq8_distance import sq8_distance_cuda
    raw = _sq8_inputs(L + d, 128, L, 5000, d, "constant")
    args = _sq8_form([torch.as_tensor(a, device=cuda) for a in raw], form)
    ka, kl = sq8_distance_cuda(*args)
    pa, pl = ref.sq8_estimate_ref(*ops.prepare_sq8_estimate(*args))
    assert torch.equal(ka, pa) and torch.equal(kl, pl)
    assert torch.isinf(ka[2, ::3]).all() and torch.isinf(ka[2, 1::3]).all()


@pytest.mark.parametrize("form", SQ8_FORMS)
def test_sq8_estimate_operand_forms_match_jax_oracle(form):
    """The wrapper's mask forms and an unaligned code table, with negative
    and out-of-range ids unmasked, give the JAX oracle's result on the
    equivalent masked inputs."""
    raw = _sq8_inputs(7, 3, 32, 60, 24)
    args = _sq8_form([torch.as_tensor(a) for a in raw], form)
    ta, tl = ops.sq8_estimate(*args)
    nbrs = args[0].numpy()
    inr = (nbrs >= 0) & (nbrs < 60)
    ev = inr if args[2] is None else (args[2].numpy() != 0) & inr
    ja, jl = jref.sq8_estimate_ref(
        jnp.asarray(np.where(inr, nbrs, 0)), jnp.asarray(args[1].numpy()),
        jnp.asarray(ev.astype(np.int8)),
        *[jnp.asarray(a.contiguous().numpy()) for a in args[3:]])
    for j, t in ((ja, ta), (jl, tl)):
        j = np.asarray(j)
        np.testing.assert_array_equal(np.isinf(j), np.isinf(t.numpy()))
        fin = np.isfinite(j)
        np.testing.assert_allclose(t.numpy()[fin], j[fin], rtol=1e-5,
                                   atol=1e-5)
    assert np.isinf(ta.numpy()[~inr]).all()
