"""The readers of the program's own counters (``repro_torch.trace``) on
counters filled with known values, and on a program that has none."""
import pytest

from perfbench import bench, counters
from repro_torch import trace

RECORD = {"config": {"dim": 128}, "setup_s": 41.5}
MS = 1_000_000


def _call(request, start_ms, end_ms, iters, dispatch_ms, sync_ms, **kw):
    return trace.Call(request=request, rows=10_000, iters=iters,
                      dispatch_ns=dispatch_ms * MS, sync_ns=sync_ms * MS,
                      start_ns=start_ms * MS, end_ns=end_ms * MS, **kw)


# the warm-up (a first use), two calls at the host's own pace, a profiled
# call, and a call after it
CALLS = [_call(1, 0, 900, 48, 850, 40, first_use=True),
         _call(2, 1000, 1180, 48, 150, 20),
         _call(3, 1200, 1400, 50, 160, 30),
         _call(4, 1500, 1800, 48, 260, 30, profiled=True),
         _call(5, 1900, 2100, 49, 170, 20)]
TOTALS = {"knn.product_s": 4.5, "knn.select_s": 12.25, "engine.sq8_s": 6.5}
EXPECTED = {
    # two calls at the host's own pace: 150 + 160 ms of dispatch and
    # 20 + 30 ms of sync over 98 iterations
    "host_ms_per_iter": 310.0 / 98, "host_dispatch_pct": 100.0 * 310 / 360,
    "knn_product_s": 4.5, "knn_select_s": 12.25, "sq8_setup_s": 6.5}
HOP = ("host_ms_per_iter", "host_dispatch_pct")


@pytest.fixture(autouse=True)
def program_counters():
    """The program's counters in this process, filled with known values."""
    trace.reset()
    for c in CALLS:
        trace.log_call(c)
    for name, v in TOTALS.items():
        trace.add(name, v)
    yield
    trace.reset()


def test_every_program_metric_is_in_the_benchmark():
    b = bench.load_benchmark()
    assert set(EXPECTED) <= {m["name"] for m in b["per_layer"]}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_reader_on_known_counters(name):
    got = bench.metric_reader(name).read(RECORD)
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


def test_hop_readers_skip_profiled_first_use_and_later_calls():
    trace.reset()
    for c in CALLS[:1] + CALLS[3:]:
        trace.log_call(c)
    for name in HOP:
        assert bench.metric_reader(name).read(RECORD) is None
    # a profiled call that began before a call at the host's pace ended
    # leaves that call out too
    trace.reset()
    for c in (CALLS[2], _call(6, 1300, 1350, 5, 40, 1, profiled=True)):
        trace.log_call(c)
    assert bench.metric_reader("host_ms_per_iter").read(RECORD) is None
    trace.reset()
    trace.log_call(CALLS[2])
    assert bench.metric_reader("host_ms_per_iter").read(RECORD) == \
        pytest.approx(160 / 50)
    assert bench.metric_reader("host_dispatch_pct").read(RECORD) == \
        pytest.approx(100 * 160 / 190)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_readers_read_nothing_without_the_programs_trace(
        name, monkeypatch):
    """An older program, without ``repro_torch.trace``, or one that added
    nothing to a total."""
    trace.reset()
    assert bench.metric_reader(name).read(RECORD) is None
    monkeypatch.setattr(counters, "_trace", lambda: None)
    for c in CALLS:
        trace.log_call(c)
    for total in TOTALS:
        trace.add(total, 1.0)
    assert bench.metric_reader(name).read(RECORD) is None
