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
    r = K.runs(ids, 4)
    assert r.offsets.tolist() == [0, 2, 3, 6, 6]     # id 5 lies past S
    assert r.order[:6].tolist() == [1, 4, 3, 0, 2, 5]
    assert r.sorted is None             # only the run-start grid reads it
    assert r.ids is ids and r.long.tolist() == [4]      # no long run
    wide = K.runs(torch.tensor([2, 0, 2, 1, 0, 2, 45]), 40)   # S > 4 N
    assert wide.sorted.dtype == torch.int32
    assert wide.sorted.tolist() == [0, 0, 1, 2, 2, 2, 40]  # 45 kept past S
    assert wide.offsets[:4].tolist() == [0, 2, 3, 6]


def _long_loop(ids, s):
    """The long-run list by a loop: every in-range id with at least
    LONG_RUN_ROWS rows, in increasing order, padded with S."""
    counts = np.bincount(ids[(ids >= 0) & (ids < s)], minlength=s)
    got = [i for i in range(s) if counts[i] >= K.LONG_RUN_ROWS]
    n_long = -(-len(ids) // K.LONG_RUN_ROWS)
    return got + [s] * (n_long - len(got))


def _run_lengths(lengths, seed, extra_ids=()):
    """Ids with runs of the given lengths, in a shuffled row order (segment
    i has lengths[i] rows), then ``extra_ids`` appended."""
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)]
                         + [np.asarray(extra_ids, dtype=np.int64)])
    return np.random.default_rng(seed).permutation(ids.astype(np.int64))


@pytest.mark.parametrize("case", [
    "thresholds", "aligned", "skewed", "one id", "out of range", "int32",
    "no long run", "empty"])
def test_long_run_list_holds_every_run_of_64_rows_once(case):
    """``Runs.long`` names each run of LONG_RUN_ROWS rows or more exactly
    once, in increasing order, padded with S, wherever the runs fall
    against the chunk starts (runs of 63, 64, 65, 127, 128, 129 rows beside
    short ones; a run that starts on a chunk start; a hot id among many
    short runs; ids out of range on both sides; int32 ids)."""
    s = 20
    ids = {
        "thresholds": lambda: _run_lengths(
            [63, 64, 65, 1, 0, 127, 128, 129, 2, 64 * 5, 3], 1),
        "aligned": lambda: np.repeat(np.arange(6), 64),
        "skewed": lambda: _run_lengths([500] + [1, 2, 0, 3] * 4, 2),
        "one id": lambda: np.full(1000, 7),
        "out of range": lambda: _run_lengths([70, 10], 3, [-1] * 90 + [s] * 80
                                             + [s + 5] * 70),
        "int32": lambda: _run_lengths([100, 64, 63], 4),
        "no long run": lambda: _run_lengths([63] * 10, 5),
        "empty": lambda: np.zeros(0, dtype=np.int64)}[case]()
    t = torch.as_tensor(ids)
    if case == "int32":
        t = t.int()
    r = K.runs(t, s)
    assert r.long.dtype == torch.int32
    assert r.long.tolist() == _long_loop(ids, s)


PLAN_SHAPES = {
    # (N, S, d, element bytes, align): the plan's deciding fields
    # (run_starts, vec, lanes, passes, tasks_per_warp, long_min)
    "dlrm 3-row table": ((65_536, 16, 128, 4, 16), (0, 4, 32, 1, 1, 64)),
    "dlrm 3-row table, B = 4,096": ((4_096, 16, 128, 4, 16),
                                    (0, 4, 32, 1, 1, 64)),
    "dlrm 155-row table": ((65_536, 160, 128, 4, 16), (0, 4, 32, 1, 1, 64)),
    "dlrm 4M-row table": ((65_536, 4_000_256, 128, 4, 16),
                          (1, 4, 32, 1, 16, 64)),
    "dlrm skewed ids": ((65_536, 100_000, 128, 4, 16), (0, 4, 32, 1, 16, 64)),
    "lm vocabulary (bf16)": ((1_024, 49_280, 1_024, 2, 16),
                             (1, 8, 32, 4, 1, 64)),
    "gin-tu minibatch_lg": ((168_960, 169_984, 64, 4, 16),
                            (0, 4, 16, 1, 32, 64)),
    "gin-tu ogb_products": ((61_859_328, 2_449_408, 64, 4, 16),
                            (0, 4, 16, 1, 32, 64)),
    "graph pooling, d = 1": ((2_560, 1, 1, 4, 4), (0, 1, 1, 1, 32, 64)),
    "S = 4 N": ((65_536, 4 * 65_536, 128, 4, 16), (0, 4, 32, 1, 32, 64)),
    "S = 4 N + 1": ((65_536, 4 * 65_536 + 1, 128, 4, 16),
                    (1, 4, 32, 1, 16, 64)),
    "no rows": ((0, 5, 8, 4, 16), (1, 4, 2, 1, 16, 0)),
    "odd bf16 rows": ((4_096, 16, 65, 2, 2), (0, 1, 32, 3, 1, 0)),
    "fp32 rows off 16 bytes": ((4_096, 16, 65, 4, 4), (0, 1, 32, 3, 1, 64)),
}


@pytest.mark.parametrize("what", list(PLAN_SHAPES))
def test_plan_at_the_main_path_shapes(what):
    """The launcher's rule (mirrored from csrc/segment_sum.cu) at the main
    path's shapes: segments are the tasks unless they outnumber the rows by
    more than RUN_START_RATIO (a 4M-row table, a vocabulary); 16-byte
    loads where the rows allow; a warp takes fewer tasks where they are
    few or wide, so the grid still fills the card; and the ring part for
    runs of LONG_RUN_ROWS rows or more wherever a row takes a 4-byte copy
    and one such run fits."""
    args, want = PLAN_SHAPES[what]
    p = K.plan(*args)
    got = (p.run_starts, p.vec, p.lanes, p.passes, p.tasks_per_warp,
           p.long_min)
    assert got == want
    N, S, d, e, _ = args
    tasks = N if p.run_starts else S
    assert p.task_blocks * p.tasks_per_warp >= tasks
    assert p.lanes * p.vec * p.passes >= d
    assert p.short_blocks * 8 >= p.task_blocks * p.passes
    assert p.tiles * 32 >= d * e
    if p.long_min:
        assert 0 < p.long_blocks <= min(K.LONG_CTAS,
                                        -(-N // 64) * p.tiles)
        assert p.copy_bytes in (4, 16) and p.smem_bytes > 0
    else:
        assert p.long_blocks == p.smem_bytes == 0


def test_as_rows_copies_only_what_is_not_contiguous():
    x = torch.zeros(6, 4, 2)
    assert K.as_rows(x).data_ptr() == x.data_ptr()
    assert K.as_rows(x).shape == (6, 8)
    assert K.as_rows(x[:, 0]).is_contiguous()           # [6, 2] strided
    y = x.transpose(1, 2)
    assert K.as_rows(y).is_contiguous() and K.as_rows(y).shape == (6, 8)


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


@pytest.mark.parametrize("setup", ["lookup.runs", "K.runs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookups_given_runs_equal_lookups_given_ids(setup, dtype):
    """``lookup.segment_sum`` and ``lookup.embedding`` given an id list's
    runs (as ``lookup.runs`` makes them off the card, ids only, and with
    the whole set-up) equal the same calls given the ids, values and
    gradients bit for bit, with the runs used three times over."""
    rng = np.random.default_rng(9)
    n, s, d = 400, 30, 12
    ids = torch.as_tensor(rng.integers(0, s, n))
    ids[:100] = 3                                    # one run of 100+ rows
    table = torch.as_tensor(rng.standard_normal((s, d))).to(dtype)
    data = torch.as_tensor(rng.standard_normal((n, d))).to(dtype)
    g = torch.as_tensor(rng.standard_normal((s, d))).to(dtype)
    r = (lookup.runs if setup == "lookup.runs" else K.runs)(ids, s)
    outs, grads = [], []
    for seg in (ids, r):
        t = table.clone().requires_grad_()
        x = data.clone().requires_grad_()
        rows = lookup.embedding(seg, t)              # [n, d]
        summed = lookup.segment_sum(rows * x, seg, s)
        back = lookup.embedding(seg, summed)
        (back * data).sum().backward(retain_graph=True)
        summed.backward(g)
        outs.append((rows, summed, back))
        grads.append((t.grad, x.grad))
    for a, b in zip(outs[0] + grads[0], outs[1] + grads[1]):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("seg", ["ids", "runs"])
@pytest.mark.parametrize("fn", ["embedding", "segment_sum"])
def test_lookups_save_their_ids_for_autograd(fn, seg):
    """The lookups keep their ids (and a ``Runs``' set-up) through
    ``save_for_backward``: saved-tensor hooks see them, and ids changed in
    place between the forward and the backward make the backward raise
    instead of summing by the new ids."""
    ids = torch.tensor([2, 0, 2, 1, 0, 2])
    s = 3
    arg = K.runs(ids, s) if seg == "runs" else ids
    packed = []

    def forward():
        if fn == "embedding":
            return lookup.embedding(arg, torch.randn(s, 4,
                                                     requires_grad=True))
        return lookup.segment_sum(torch.randn(len(ids), 4,
                                              requires_grad=True), arg, s)

    def pack(t):
        packed.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        forward().sum().backward()
    assert any(t is ids for t in packed)
    if seg == "runs" and fn == "embedding":
        assert any(t is arg.order for t in packed)
    out = forward()
    ids[0] = 1
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        out.sum().backward()


def test_runs_for_other_segments_are_refused():
    ids = torch.tensor([0, 1, 1])
    with pytest.raises(ValueError, match="set up for 2 segments"):
        lookup.segment_sum(torch.ones(3, 2), lookup.runs(ids, 2), 3)
    with pytest.raises(ValueError, match="num_segments"):
        K.runs(ids, 2 ** 31)


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
    """``plan`` equals the launcher's own plan field for field at the main
    path's shapes and around every threshold (RUN_START_RATIO, the warp
    count the short part aims at, LONG_CTAS, the alignments); its
    ``long_min`` is the LONG_RUN_ROWS the long-run list is built with."""
    shapes = [args for args, _ in PLAN_SHAPES.values()]
    for N in (0, 1, 63, 64, 65, 4_095, 4_096, 65_536, 131_073, 1 << 22):
        for ratio in (0, 1, 4):
            for d, e, align in ((1, 4, 4), (8, 2, 16), (64, 4, 16),
                                (65, 2, 2), (128, 4, 16), (960, 4, 4),
                                (1_024, 2, 16), (4_100, 4, 16)):
                shapes += [(N, max(1, ratio * N + r), d, e, align)
                           for r in (-1, 0, 1)]
    for N, S, d, e, align in shapes:
        dtype = torch.float32 if e == 4 else torch.bfloat16
        assert K.kernel_plan(N, S, d, dtype, align) == \
            K.plan(N, S, d, e, align), (N, S, d, e, align)


# run lengths (segment i holds lengths[i] rows) around each threshold the
# kernel uses: LONG_RUN_ROWS, a ring stage, the whole ring
_R, _RING = K.RING_ROWS, K.RING_ROWS * K.RING_STAGES
RULE_CASES = {
    "thresholds": ([63, 64, 65, 127, 128, 129, 1, 0, 2, 0], None),
    "ring wrap": ([_R - 1, _R, _R + 1, _RING - 1, _RING, _RING + 1,
                   _RING + _R + 5, 3], None),
    # one id holds half the rows, the rest uniform over 5,000 ids
    "skewed": (None, (8_192, 5_000, 200_000)),
    # the same with segments outnumbering rows 10 to 1: the run-start grid
    "skewed, run starts": (None, (8_192, 82_000, 200_000)),
    # more (run, tile) items than the ring part has CTAs
    "many long runs": ([70] * 600, None),
}


def _rule_ids(case, seed):
    lengths, skew = RULE_CASES[case]
    if lengths is not None:
        ids = _run_lengths(lengths, seed)
        return ids, len(lengths) + 2                 # two empty segments
    n, s, hot = skew
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s, n)
    ids[rng.permutation(n)[: n // 2]] = hot % s
    return ids, s


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 8, 64, 65, 128, 960])
@pytest.mark.parametrize("case", list(RULE_CASES))
def test_kernel_is_bit_equal_across_the_rule_on_gpu(cuda, case, d, dtype):
    """Bit-equal with the plain version and repeatable, one counted launch
    a call, for runs on both sides of every threshold the rule uses, a
    skewed id list on both grids, and rows whose width takes 16-byte, 4-byte
    or no ring copies (d = 1, 65; bf16 at odd d); given the ids and given
    their runs."""
    ids, s = _rule_ids(case, seed=d)
    rng = np.random.default_rng(d + 1)
    data = torch.as_tensor(rng.standard_normal((len(ids), d))
                           .astype(np.float32)).to(dtype)
    ids_c = torch.as_tensor(ids)
    want = ref.segment_sum_ref(data, ids_c, s)
    x, ids_d = data.to(cuda), ids_c.to(cuda)
    r = K.runs(ids_d, s)
    K.reset_launch_counts()
    got = [K.segment_sum(x, ids_d, s), K.segment_sum(x, r, s)]
    torch.cuda.synchronize()
    assert K.LAUNCHES["segment_sum"] == 2
    assert torch.equal(got[0].cpu(), want)
    assert torch.equal(got[0], got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_kernel_is_bit_equal_on_rows_off_16_bytes_on_gpu(cuda, d, dtype):
    """Data 4 bytes past a 16-byte boundary: scalar loads in the short
    part, 4-byte copies (or none) in the ring part; the same bits."""
    ids, s = _rule_ids("thresholds", seed=d)
    rng = np.random.default_rng(d)
    data = torch.as_tensor(rng.standard_normal((len(ids), d))
                           .astype(np.float32)).to(dtype)
    pad = 4 // data.element_size()
    buf = torch.zeros(len(ids) * d + pad, dtype=dtype, device=cuda)
    x = buf[pad:].view(len(ids), d)
    x.copy_(data.to(cuda))
    assert K.alignment(x) == 4
    got = K.segment_sum(x, torch.as_tensor(ids).to(cuda), s)
    assert torch.equal(got.cpu(), ref.segment_sum_ref(data,
                                                      torch.as_tensor(ids),
                                                      s))


@pytest.mark.gpu
def test_wrapper_given_runs_does_not_sync_on_gpu(cuda):
    """No host sync in a wrapper call given runs (nor in the set-up, nor
    through the lookups, forward and backward), on both grids."""
    rng = np.random.default_rng(12)
    for n, s in ((20_000, 3), (20_000, 15_000), (2_000, 50_000)):
        ids = torch.as_tensor(rng.integers(0, s, n)).to(cuda)
        data = torch.randn(n, 64, device=cuda, requires_grad=True)
        table = torch.randn(s, 64, device=cuda, requires_grad=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = K.runs(ids, s)
            K.segment_sum(data.detach(), r, s)
            lr = lookup.runs(ids, s)
            out = lookup.segment_sum(lookup.embedding(lr, table) * data, lr,
                                     s)
            out.backward(torch.ones_like(out))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrapper_reads_contiguous_data_in_place_on_gpu(cuda, monkeypatch):
    """A contiguous [N, d] gradient (or [N, *tail]) reaches the kernel as
    it is: the launch reads the caller's data pointer, no copy."""
    seen = []
    launch = K.launch_runs

    def spy(data2d, r):
        seen.append(data2d.data_ptr())
        return launch(data2d, r)
    monkeypatch.setattr(K, "launch_runs", spy)
    ids = torch.randint(0, 40, (3_000,), device=cuda)
    for shape in ((3_000, 128), (3_000, 4, 32), (3_000,)):
        x = torch.randn(shape, device=cuda)
        K.segment_sum(x, ids, 40)
        assert seen[-1] == x.data_ptr()


@pytest.mark.gpu
def test_add_chain_adds_in_one_thread_on_gpu(cuda):
    out = torch.zeros(1, device=cuda)
    K.add_chain(out, 1_000, 0.5)
    assert float(out) == 500.0


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
