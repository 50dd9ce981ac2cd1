"""The fixed-order segment sum and the lookups built on it.

``kernels/segment_sum.py``'s plain version must equal a Python loop that
adds in increasing row order from zero, bit for bit (fp32 in fp32; bf16 in
an fp32 accumulator rounded once), and ``models/lookup.py``'s Functions
must equal ``F.embedding`` and ``index_add_`` on the CPU, values and
gradients, bit for bit.  The CUDA kernel itself runs only on the card: the
``gpu``-marked tests hold it against the plain version there bit for bit
(``chip_smoke.py``'s ``segment_sum`` check covers the main path's shapes).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as K
from repro_torch.models import lookup


def _case(n, s, d, dtype, seed, spread=True):
    rng = np.random.default_rng(seed)
    scale = np.logspace(-3, 3, n)[:, None] if spread else 1.0
    data = torch.as_tensor((rng.standard_normal((n, d)) * scale)
                           .astype(np.float32)).to(dtype)
    ids = torch.as_tensor(rng.integers(0, s, n))
    return data, ids


def _loop(data, ids, s):
    acc = torch.zeros((s, data.shape[1]), dtype=torch.float32)
    for i in range(data.shape[0]):
        acc[ids[i]] = acc[ids[i]] + data[i].float()
    return acc.to(data.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,d", [(700, 3, 1), (700, 16, 64), (300, 155, 128),
                                   (200, 40, 960), (0, 5, 8)])
def test_plain_version_equals_an_ordered_loop(n, s, d, dtype):
    """Adds in increasing row order from +0 (empty segments read 0):
    bit-equal to a loop, and, for bf16, to the CPU's own index_add_ of a
    2-D bf16 tensor (which sums in fp32 and rounds once)."""
    data, ids = _case(n, s, d, dtype, seed=n + d)
    got = ref.segment_sum_ref(data, ids, s)
    assert got.dtype == dtype and got.shape == (s, d)
    assert torch.equal(got, _loop(data, ids, s))
    assert torch.equal(got, torch.zeros((s, d), dtype=dtype)
                       .index_add_(0, ids, data))


def test_plain_version_keeps_trailing_shape_and_empty_segments():
    data, ids = _case(50, 4, 6, torch.float32, seed=1)
    ids = ids % 3                                    # segment 3 stays empty
    got = K.segment_sum(data.reshape(50, 2, 3), ids.int(), 4)
    assert got.shape == (4, 2, 3)
    assert torch.equal(got.reshape(4, 6), _loop(data, ids, 4))
    assert torch.equal(got[3], torch.zeros(2, 3))
    one_d = K.segment_sum(data[:, 0], ids, 4)
    assert torch.equal(one_d, _loop(data[:, :1], ids, 4)[:, 0])


def test_runs_are_each_segments_rows_in_order():
    ids = torch.tensor([2, 0, 2, 1, 0, 2, 5])
    sorted_ids, order, offsets = K.runs(ids, 4)
    assert offsets.tolist() == [0, 2, 3, 6, 6]       # id 5 lies past S
    assert order[:6].tolist() == [1, 4, 3, 0, 2, 5]
    assert sorted_ids.tolist() == [0, 0, 1, 2, 2, 2, 5]


def test_choose_grid_covers_run_starts_only_when_segments_outnumber_rows():
    """The main path's shapes: a 3- or 155-row table's gradient and GNN
    aggregations over the segments, a 4M-row table's and a vocabulary's
    over the run starts."""
    assert K.choose_grid(65_536, 16) == "segments"
    assert K.choose_grid(168_960, 169_984) == "segments"
    assert K.choose_grid(61_859_328, 2_449_408) == "segments"
    assert K.choose_grid(65_536, 4 * 65_536) == "segments"
    assert K.choose_grid(65_536, 4 * 65_536 + 1) == "run_starts"
    assert K.choose_grid(65_536, 4_000_256) == "run_starts"
    assert K.choose_grid(1_024, 49_280) == "run_starts"
    assert K.choose_grid(0, 5) == "run_starts"


def test_cpu_and_meta_take_the_plain_version_uncounted():
    K.reset_launch_counts()
    data, ids = _case(20, 3, 4, torch.float32, seed=2)
    K.segment_sum(data, ids, 3)
    lookup.embedding(ids, torch.zeros(3, 4))
    assert K.LAUNCHES == {"segment_sum": 0}
    meta = K.segment_sum(data.to("meta"), ids.to("meta"), 3)
    assert meta.device.type == "meta" and meta.shape == (3, 4)


@pytest.mark.parametrize("rows,ids_shape,d", [(3, (64,), 8), (155, (32, 5), 16),
                                              (40, (4, 9, 3), 1)])
def test_embedding_equals_f_embedding(rows, ids_shape, d):
    """Values and the table's gradient bit-equal to F.embedding's on the
    CPU, with each row looked up many times."""
    rng = np.random.default_rng(rows)
    table = torch.as_tensor(rng.standard_normal((rows, d)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, rows, ids_shape))
    g = torch.as_tensor(rng.standard_normal(ids_shape + (d,))
                        .astype(np.float32))
    a = table.clone().requires_grad_()
    b = table.clone().requires_grad_()
    out_a = lookup.embedding(ids, a)
    out_b = F.embedding(ids, b)
    assert torch.equal(out_a, out_b)
    out_a.backward(g)
    out_b.backward(g)
    assert torch.equal(a.grad, b.grad)


def test_embedding_bf16_gradient_is_the_plain_segment_sum():
    data, ids = _case(500, 7, 32, torch.bfloat16, seed=3)
    table = torch.zeros(7, 32, dtype=torch.bfloat16, requires_grad=True)
    lookup.embedding(ids, table).backward(data)
    assert table.grad.dtype == torch.bfloat16
    assert torch.equal(table.grad, _loop(data, ids, 7))


@pytest.mark.parametrize("tail", [(), (8,), (3, 4)])
def test_segment_sum_equals_index_add(tail):
    """Forward bit-equal to index_add_ into zeros; the gradient is the
    gather of the output gradient, as autograd's index_add gives it."""
    rng = np.random.default_rng(len(tail))
    n, s = 300, 11
    data = torch.as_tensor(rng.standard_normal((n,) + tail).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, s, n))
    g = torch.as_tensor(rng.standard_normal((s,) + tail).astype(np.float32))
    a = data.clone().requires_grad_()
    b = data.clone().requires_grad_()
    out_a = lookup.segment_sum(a, ids, s)
    out_b = torch.zeros((s,) + tail).index_add(0, ids, b)
    assert torch.equal(out_a, out_b)
    out_a.backward(g)
    out_b.backward(g)
    assert torch.equal(a.grad, b.grad)


# --- on the card only ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,d", [(65_536, 1, 64), (4_096, 16, 128),
                                   (65_536, 160, 128), (4_096, 3, 960),
                                   (1_000, 2_000, 1), (0, 4, 8),
                                   (1_000, 40_000, 33), (300, 1_201, 100)])
def test_kernel_is_bit_equal_to_plain_on_gpu(cuda, n, s, d, dtype):
    """Bit-equal with the plain version on CPU copies, twice, and one
    counted launch a call."""
    data, ids = _case(n, s, d, dtype, seed=d, spread=False)
    want = ref.segment_sum_ref(data, ids, s)
    K.reset_launch_counts()
    got = [K.segment_sum(data.to(cuda), ids.to(cuda), s) for _ in range(2)]
    assert K.LAUNCHES["segment_sum"] == 2
    assert torch.equal(got[0].cpu(), want)
    assert torch.equal(got[0], got[1])


@pytest.mark.gpu
def test_kernel_grid_rule_matches_the_python_copy(cuda):
    assert K.kernel_run_start_ratio() == K.RUN_START_RATIO


@pytest.mark.gpu
def test_lookup_gradients_repeat_on_gpu(cuda):
    data, ids = _case(65_536, 3, 128, torch.float32, seed=4, spread=False)
    table = torch.zeros(3, 128, device=cuda, requires_grad=True)
    grads = []
    for _ in range(2):
        table.grad = None
        lookup.embedding(ids.to(cuda), table).backward(data.to(cuda))
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0].cpu(), _loop(data, ids, 3))


@pytest.mark.gpu
def test_kernel_drops_ids_outside_the_segments_on_gpu(cuda):
    """Ids below 0 or past S fall outside every run on the card (the CPU's
    index_add_ raises on them): the in-range rows' sum, in order."""
    data, ids = _case(5_000, 40, 64, torch.float32, seed=6, spread=False)
    ids = ids - 5                                    # -5 .. 34 into S = 30
    keep = (ids >= 0) & (ids < 30)
    got = K.segment_sum(data.to(cuda), ids.to(cuda), 30)
    assert torch.equal(got.cpu(), _loop(data[keep], ids[keep], 30))
