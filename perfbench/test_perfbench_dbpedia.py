"""The cosine cell ``dbpedia500k.offline`` at a tiny size on the CPU, and
the reader of ``pruned_pct``, the share of distance evaluations the
CRouting prune skipped."""
import time

import pytest
import torch

from perfbench import bench, control, counters, harness
from perfbench.conftest import tiny
from repro_torch import trace

CELL = "dbpedia500k.offline"


@pytest.fixture(autouse=True)
def clean_trace():
    trace.reset()
    yield
    trace.reset()


def test_the_cell_states_cosine_and_the_exact_path():
    cell = bench.find_cell(CELL, bench.load_benchmark())
    cfg = cell.config
    assert (cfg["metric"], cfg["dim"], cfg["n_query"]) == ("cosine", 1536,
                                                           10000)
    assert cfg["search"]["estimate"] == "exact"
    assert cfg["search"]["router"] == "crouting"
    assert cell.entry["chips"] == 1 and cell.mix["batch"] == "all"
    assert [m["name"] for m in cell.per_layer] == ["pruned_pct"]


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 33 + 17])
def test_a_tiny_run_is_correct_with_every_check_under_its_limit(seed):
    r = harness.run_cell(tiny(CELL), seed, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"] is True, r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name
    # the program's threshold is the reference's: its profile samples what
    # the reference samples under cosine
    info = r["info"]
    assert abs(info["theta_program"] - info["theta_reference"]) < 1e-5
    assert r["checks"]["angle_ks"]["value"] < 1e-3
    assert r["failed"] == 0 and r["attempted"] >= 48
    assert r["metrics"]["recall_at_10"]["value"] > 0.5
    # the run's searches pruned lanes, and the reader reads them
    pct = bench.metric_reader("pruned_pct").read({})
    assert 0.0 < pct < 100.0


def test_the_control_comes_out_not_correct_by_every_number():
    """The reference a step below float32 (TF32 K-NN products, bf16 rows)
    in the program's place fails each of the cell's inexact limits."""
    r = control.run_control(tiny(CELL).config, 3, torch.device("cpu"))
    assert r["correct"] is False
    for name in ("dist_err", "graph_ids_off", "edge_len_err", "angle_ks",
                 "query_mismatch"):
        c = r["checks"][name]
        assert c["value"] > c["limit"], name


@pytest.mark.parametrize("pruned,first,want", [
    (250, 750, 25.0), (0, 40, 0.0), (3, 1, 75.0)])
def test_pruned_pct_on_known_totals(pruned, first, want):
    trace.add("search.pruned", pruned)
    trace.add("search.first_stage", first)
    assert bench.metric_reader("pruned_pct").read({}) == pytest.approx(
        want, rel=1e-12)


def test_pruned_pct_reads_nothing_without_the_programs_totals(monkeypatch):
    """A program that added neither total (the parent's), one that added
    only one, one that searched nothing, and one without
    ``repro_torch.trace``."""
    read = bench.metric_reader("pruned_pct").read
    assert read({}) is None
    trace.add("search.pruned", 5)
    assert read({}) is None
    trace.reset()
    trace.add("search.pruned", 0)
    trace.add("search.first_stage", 0)
    assert read({}) is None
    trace.add("search.first_stage", 10)
    monkeypatch.setattr(counters, "_trace", lambda: None)
    assert read({}) is None
