"""Each metric's reader on a synthetic record, and the trace summary."""
from types import SimpleNamespace

import pytest

from perfbench import bench, tracing
from perfbench import test_perfbench_program_counters as program
from repro_torch import trace

CFG = {"dim": 128, "graph": {"k": 32}, "search": {"k": 10}}
TRACE = {"busy_s": 0.5, "window_s": 2.0, "kernels": 3000, "iters": 20,
         "calls": 2, "queries": 20_000, "dist_calls": 400_000,
         "sq8_calls": 1000, "hops": 10_000, "est_calls": 5, "rerank_calls": 0}
RECORD = {
    "config": CFG, "setup_s": 41.5, "recall_at_10": 0.93,
    "spans": {"build": 30.25, "profile": 2.5},
    "window": {"seconds": 20.0, "calls": 4, "queries": 40_000,
               "iters": [50, 52, 50, 52], "dist_calls": 80_000_000,
               "sq8_calls": 0, "hops": 0, "est_calls": 0, "rerank_calls": 0},
    "untraced": {"seconds": 18.0, "queries": 36_000},
    "trace": TRACE,
    # what the readers of the program's own counters take: its call log and
    # totals (``repro_torch.trace``), loaded into the process by
    # ``program_counters`` below
    "program": {"calls": program.CALLS, "totals": program.TOTALS}}
BYTES = (400_000 * 128 * 4 + 1000 * 128 + 10_000 * 32 * 8
         + 20_000 * (512 + 80))
EXPECTED = {
    "qps": 2000.0, "recall_at_10": 0.93, "setup_s": 41.5, "build_s": 30.25,
    "profile_s": 2.5, "iters_per_batch": 51.0, "kernels_per_iter": 150.0,
    "dist_calls_per_query": 2000.0,
    # 0.5 s over 20,000 traced queries, 36,000 queries in 18 s untraced
    "device_idle_pct": 100.0 * (1.0 - 0.5 / 20_000 * 36_000 / 18.0),
    "device_busy_ms_per_batch": 250.0,
    "search_roofline": 100.0 * BYTES / 3.35e12 / 0.5,
    **program.EXPECTED}
TRACED = ("kernels_per_iter", "device_idle_pct", "search_roofline",
          "device_busy_ms_per_batch")


@pytest.fixture(autouse=True)
def program_counters():
    """The program's counters in this process: ``RECORD["program"]``."""
    trace.reset()
    for c in RECORD["program"]["calls"]:
        trace.log_call(c)
    for name, v in RECORD["program"]["totals"].items():
        trace.add(name, v)
    yield
    trace.reset()


def _metrics():
    b = bench.load_benchmark()
    return [m["name"] for m in b["end_to_end"] + b["per_layer"]]


@pytest.mark.parametrize("name", _metrics())
def test_reader_on_a_synthetic_record(name):
    got = bench.metric_reader(name).read(RECORD)
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)
    if name in TRACED:
        assert bench.metric_reader(name).read({**RECORD, "trace": None}) \
            is None


def test_read_metrics_leaves_out_what_reads_nothing():
    ms = [{"name": n, "unit": "u"} for n in TRACED + ("qps",)]
    got = bench.read_metrics(ms, {**RECORD, "trace": None})
    assert list(got) == ["qps"]
    assert got["qps"] == {"value": 2000.0, "unit": "u"}


def _ev(name, a, b, cuda=False, parent=None):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=a, end=b), device_type="DeviceType.CUDA" if cuda else
        "DeviceType.CPU", cpu_parent=parent)


def test_summarize_busy_kernels_and_named_gaps():
    span = _ev("search_on", 10, 90)
    evs = [_ev(tracing.WINDOW, 0, 100), span,
           _ev("aten::sort", 20, 40, parent=span),
           _ev("aten::item", 45, 70, parent=span),
           _ev("void k1<float>()", 5, 30, cuda=True),
           _ev("void k1<float>()", 25, 35, cuda=True),
           _ev("Memcpy DtoH", 60, 62, cuda=True),
           _ev("spin_kernel", 95, 99, cuda=True),
           _ev("search_on", 10, 90, cuda=True)]
    s = tracing.summarize(evs, 1e-4)
    assert s["busy_s"] == pytest.approx(32e-6)
    assert s["kernels"] == 2
    assert s["window_s"] == 1e-4
    gaps = dict(s["idle_gaps"])
    # 0-5: outside every span; 35-60: mid 47.5 in the item (the host
    # waits on the device); 62-100: mid 81 in the span, after the item
    assert gaps == pytest.approx({"harness/python": 5e-6,
                                  "search_on/aten::item": 25e-6,
                                  "search_on/python": 38e-6})
    assert s["device_ops"][0] == ["void k1<float>()", pytest.approx(35e-6)]
