"""``normalize_rows``: a cosine index's query rows normalised on the card.

The plain version (``ref.normalize_rows_ref``) is NumPy's formula,
``x / max(|x|, 1e-12)`` in float32, with the squares summed in the kernels'
warp order and the root correctly rounded.  NumPy sums the squares in
another order, so the two norms may differ by an ulp or two; the tests hold
each part on its own: the division is NumPy's bit for bit, and the norm is
within an ulp of the exact (float64) one.  On the CPU ``search_on`` keeps
the NumPy path (``preprocess_vectors``) bit for bit, and no metric but
``cosine`` on the card ever reaches the kernel.  The ``gpu``-marked tests
hold the kernel to the plain version bit for bit on the card, show that a
row's bits depend on the row alone, and run a CUDA cosine index through
it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import distances as D
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec, SearchStats
from repro_torch.kernels import build
from repro_torch.kernels import normalize_rows as K
from repro_torch.kernels import ops, ref

DIMS = (3, 16, 128, 960, 1536, 1537)


def _rows(n, d, seed):
    """Rows whose norms span six decades, so that every exponent range of
    the division is met."""
    rng = np.random.default_rng(seed)
    scale = np.logspace(-3, 3, n)[:, None]
    return (rng.standard_normal((n, d)) * scale).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.fixture(autouse=True)
def clean_counts():
    trace.reset()
    K.reset_launch_counts()
    yield
    trace.reset()
    K.reset_launch_counts()


@pytest.mark.parametrize("d", DIMS)
def test_plain_version_is_numpys_division_by_a_correctly_summed_norm(d):
    """Given its own norm, the plain version is NumPy's
    ``x / np.maximum(n, 1e-12)`` bit for bit; that norm is within an ulp of
    the exact norm and two of NumPy's (a float32 sum in another order), so
    each element lies within 3 ulp of ``preprocess_vectors``'s."""
    x = _rows(300, d, seed=d)
    got = ref.normalize_rows_ref(torch.from_numpy(x)).numpy()
    mine = np.sqrt(ref.warp_order_sum(torch.from_numpy(x * x)).numpy())
    want = x / np.maximum(mine, np.float32(1e-12))[:, None]
    assert got.dtype == np.float32 and np.array_equal(got, want)
    exact = np.sqrt((x.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    assert _ulps(mine, exact).max() <= 1
    assert _ulps(mine, np.linalg.norm(x, axis=-1)).max() <= 2
    assert _ulps(got, D.preprocess_vectors(x, "cosine")).max() <= 3


def test_a_zero_or_tiny_row_is_clamped_as_numpy_clamps_it():
    """A zero row gives zeros; a row whose norm is below 1e-12 is divided
    by 1e-12, as NumPy's ``np.maximum`` does."""
    x = _rows(6, 40, seed=1)
    x[2] = 0.0
    x[4] = np.float32(1e-14)
    got = K.normalize_rows(torch.from_numpy(x)).numpy()
    assert np.array_equal(got[2], np.zeros(40, np.float32))
    assert np.array_equal(got[4], D.preprocess_vectors(x[4:5], "cosine")[0])
    assert np.array_equal(got[4], x[4] / np.float32(1e-12))


def test_wrapper_on_the_cpu_writes_in_place_and_launches_nothing():
    x = torch.from_numpy(_rows(50, 200, seed=2))
    want = ref.normalize_rows_ref(x)
    assert torch.equal(K.normalize_rows(x), want)
    out = ops.normalize_rows(x, out=x)
    assert out is x and torch.equal(x, want)
    assert K.LAUNCHES == {"normalize_rows": 0}


@pytest.mark.parametrize("case", [
    "float64", "bfloat16", "int32", "rank 1", "rank 3", "transposed",
    "out of another shape", "out of another dtype", "strided out"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x = torch.ones((8, 12))
    out = None
    if case in ("float64", "bfloat16", "int32"):
        x = x.to(getattr(torch, case))
    elif case == "rank 1":
        x = x[0]
    elif case == "rank 3":
        x = x.reshape(2, 4, 12)
    elif case == "transposed":
        x = x.t()
    elif case == "out of another shape":
        out = torch.empty((8, 11))
    elif case == "out of another dtype":
        out = torch.empty((8, 12), dtype=torch.float64)
    else:
        out = torch.empty((8, 24))[:, ::2]
    with pytest.raises(ValueError, match="normalize_rows"):
        K.normalize_rows(x, out=out)


# --- search_on ------------------------------------------------------------------
def _index(metric, device):
    rng = np.random.default_rng(30)
    base = rng.standard_normal((600, 24)).astype(np.float32)
    queries = rng.standard_normal((12, 24)).astype(np.float32)
    return AnnIndex.build(base, graph="knn", k=12, metric=metric,
                          device=device), queries


def _spec(engine="fused"):
    return SearchSpec(k=10, efs=32, router="crouting", beam_width=4,
                      engine=engine)


def _numpy_path(idx, fn, queries, spec):
    """``search_on`` as the CPU runs it: the rows normalised in NumPy, then
    the engine."""
    res = fn(D.preprocess_vectors(queries, idx.graph.metric),
             idx.profile.cos_theta_star)
    ids = res.ids[:, :spec.k].cpu().numpy().astype(np.int64)
    dists = res.dists[:, :spec.k].cpu().numpy()
    pad = ids >= idx.graph.n
    ids[pad], dists[pad] = -1, np.inf
    return ids, dists, SearchStats.from_result(res, router=spec.router)


@pytest.mark.parametrize("engine", ["fused", "unfused", "torch"])
def test_cosine_search_on_the_cpu_keeps_the_numpy_path(engine):
    """Ids, distances and every counter are those of the engine fed
    ``preprocess_vectors``' rows; the kernel never runs and the total
    ``search.normalised_rows`` stays 0."""
    idx, q = _index("cosine", "cpu")
    spec = _spec(engine)
    _, fn = build_search_fn(idx.graph, idx.engine_spec(spec), device="cpu")
    ids, dists, stats = idx.search_on(fn, q, spec)
    want_ids, want_dists, want = _numpy_path(idx, fn, q, spec)
    assert np.array_equal(ids, want_ids)
    assert np.array_equal(dists, want_dists)
    for f in dataclasses.fields(SearchStats):
        a, b = getattr(stats, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert trace.totals().get("search.normalised_rows", 0) == 0
    assert K.LAUNCHES == {"normalize_rows": 0}


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_l2_and_ip_queries_are_never_normalised(metric):
    """Under ``l2`` and ``ip`` the rows reach the engine as they are."""
    idx, q = _index(metric, "cpu")
    ids, _, _ = idx.search(q, _spec())
    _, fn = build_search_fn(idx.graph, idx.engine_spec(_spec()),
                            device="cpu")
    assert np.array_equal(ids, _numpy_path(idx, fn, q, _spec())[0])
    assert trace.totals().get("search.normalised_rows", 0) == 0
    assert K.LAUNCHES == {"normalize_rows": 0}


@pytest.mark.parametrize("metric,dev", [
    ("cosine", None), ("cosine", "cpu"), ("l2", None), ("l2", "cuda"),
    ("ip", "cpu"), ("ip", "cuda")])
def test_prepare_queries_off_the_card_is_preprocess_vectors(metric, dev):
    """Off the card, and under ``l2`` and ``ip`` on it, a batch is
    ``preprocess_vectors``' host array bit for bit (the caller's float64
    rows in float32) and nothing is counted."""
    x = _rows(40, 24, seed=7).astype(np.float64)
    got = D.prepare_queries(x, metric, dev)
    want = D.preprocess_vectors(x.astype(np.float32), metric)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert trace.totals().get("search.normalised_rows", 0) == 0
    assert K.LAUNCHES == {"normalize_rows": 0}


# --- on the card only -------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", (16, 128, 1536, 1537, 3000))
def test_kernel_is_bit_equal_to_plain_on_gpu(cuda, d):
    """d 1537 and 3000 take two sweeps (the first read twice), d 1537 the
    scalar loads."""
    x = _rows(700, d, seed=d)
    got = K.normalize_rows(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    want = ref.normalize_rows_ref(torch.from_numpy(x))
    assert torch.equal(got.cpu(), want)
    assert K.LAUNCHES == {"normalize_rows": 1}


@pytest.mark.gpu
def test_a_rows_bits_depend_on_the_row_alone_on_gpu(cuda):
    """The same rows at B = 1, 7 and 10,000, at other positions, in place,
    and off a 16-byte boundary (scalar loads): the same bits."""
    d = 1536
    big = torch.from_numpy(_rows(10_000, d, seed=5)).to(cuda)
    full = K.normalize_rows(big)
    for lo, b in ((0, 1), (3, 7), (9_990, 7), (4_321, 1)):
        part = K.normalize_rows(big[lo:lo + b].clone())
        assert torch.equal(part, full[lo:lo + b]), (lo, b)
    moved = K.normalize_rows(torch.roll(big, 137, 0))
    assert torch.equal(torch.roll(moved, -137, 0), full)
    flat = torch.empty(10_000 * d + 1, device=cuda)
    off = flat[1:].view(10_000, d)
    off.copy_(big)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(K.normalize_rows(off, out=off), full)
    inplace = big.clone()
    assert torch.equal(K.normalize_rows(inplace, out=inplace), full)


@pytest.mark.gpu
def test_a_zero_row_gives_zeros_on_gpu(cuda):
    x = torch.from_numpy(_rows(9, 1536, seed=3))
    x[4] = 0.0
    got = K.normalize_rows(x.to(cuda)).cpu()
    assert torch.equal(got[4], torch.zeros(1536))
    assert torch.equal(got, ref.normalize_rows_ref(x))


@pytest.mark.gpu
def test_cuda_cosine_index_normalises_on_the_card_on_gpu(cuda):
    """``search`` on a CUDA cosine index launches the kernel once a call
    and adds the batch's rows to ``search.normalised_rows``; its recall is
    that of the engine fed rows normalised on the host, within 1e-3."""
    rng = np.random.default_rng(31)
    base = rng.standard_normal((4000, 64)).astype(np.float32)
    q = rng.standard_normal((200, 64)).astype(np.float32)
    idx = AnnIndex.build(base, graph="knn", k=16, metric="cosine",
                         device=cuda)
    spec = SearchSpec(k=10, efs=48, router="crouting", beam_width=4)
    unit = D.preprocess_vectors(base, "cosine")
    truth = np.argsort(-(D.preprocess_vectors(q, "cosine") @ unit.T),
                       axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(ids, truth)])
    for b in (200, 37):
        before = trace.totals().get("search.normalised_rows", 0)
        launches = K.LAUNCHES["normalize_rows"]
        ids, _, _ = idx.search(q[:b], spec)
        assert trace.totals()["search.normalised_rows"] - before == b
        assert K.LAUNCHES["normalize_rows"] - launches == 1
    ids, _, _ = idx.search(q, spec)
    _, fn = build_search_fn(idx.graph, idx.engine_spec(spec), device=cuda)
    host_ids = _numpy_path(idx, fn, q, idx.engine_spec(spec))[0]
    assert recall(ids) > 0.5
    assert abs(recall(ids) - recall(host_ids)) <= 1e-3


@pytest.mark.gpu
def test_a_cuda_cosine_engine_loads_the_kernel_in_set_up_on_gpu(cuda):
    """Setting up a CUDA cosine engine loads ``normalize_rows``' library
    (building it on a fresh checkout), so no search call pays for that
    load uncounted; an l2 engine leaves it alone."""
    rng = np.random.default_rng(32)
    base = rng.standard_normal((500, 32)).astype(np.float32)
    spec = SearchSpec(k=10, efs=32, router="crouting", beam_width=4)
    for metric, loads in (("l2", False), ("cosine", True)):
        idx = AnnIndex.build(base, graph="knn", k=12, metric=metric,
                             device=cuda, profile=False)
        with build._lock:
            build._LIBS.pop("normalize_rows", None)
        build_search_fn(idx.graph, idx.engine_spec(spec), device=cuda)
        with build._lock:
            assert ("normalize_rows" in build._LIBS) == loads, metric
    assert K.normalize_rows(torch.ones((2, 8), device=cuda)).sum() > 0
