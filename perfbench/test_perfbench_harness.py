"""The harness end to end on the CPU at a tiny size, its faults, its
refusals, and BENCHMARK.json against the contract it is written to."""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import bench, control, harness
from perfbench.conftest import CELLS, metric_cases, tiny
from repro_torch.core.index import AnnIndex

ROOT = Path(__file__).resolve().parents[1]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, trace=False, seconds=0.3, seed=2 ** 31 + 3, metric=None):
    return harness.run_cell(tiny(name, metric=metric), seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct_and_has_the_result_keys(name):
    r = _run(name)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 48
    assert r["attempted"] % 48 == 0
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert r["metrics"]["recall_at_10"]["value"] > 0.5
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def _spy_on_build(monkeypatch, metric=None):
    """The metric of every graph the harness builds; with ``metric``, the
    program is made to build under that metric whatever it is asked."""
    built, build = [], AnnIndex.build.__func__

    def spy(cls, base, **kw):
        idx = build(cls, base, **{**kw, **({"metric": metric} if metric
                                            else {})})
        built.append(idx.graph.metric)
        return idx
    monkeypatch.setattr(AnnIndex, "build", classmethod(spy))
    return built


@pytest.mark.parametrize("name,metric", metric_cases(("ip", "cosine")))
def test_a_tiny_run_under_ip_and_cosine_is_built_and_judged_under_it(
        name, metric, monkeypatch):
    """A configuration that states ``ip`` or ``cosine`` is built, searched
    and judged under it.  Every number is within its limit but
    ``angle_ks``: the program's profile under these metrics also samples
    the expansion of each profile query's own row (PERF.md, section 7;
    ``test_reference_equals_the_program_on_a_tiny_index`` pins it down)."""
    built = _spy_on_build(monkeypatch)
    r = _run(name, metric=metric)
    assert built == [metric]
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] >= 48
    assert r["metrics"]["recall_at_10"]["value"] > 0.5
    over = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert over <= {"angle_ks"}, r["checks"]
    assert r["correct"] is not over


@pytest.mark.parametrize("name,metric", metric_cases(("ip", "cosine")))
def test_a_program_built_under_l2_for_another_metric_is_not_correct(
        name, metric, monkeypatch):
    """The hole a harness blind to the metric leaves: an index built and
    searched under ``l2`` where the configuration states ``ip`` or
    ``cosine`` returns squared L2 distances, which the check's ranks
    refuse."""
    built = _spy_on_build(monkeypatch, metric="l2")
    r = _run(name, metric=metric)
    assert built == ["l2"]
    assert r["correct"] is False
    assert r["checks"]["dist_err"]["value"] > r["checks"]["dist_err"]["limit"]


UNJUDGEABLE = {"metric": ((), "metric", "hamming"),
               "graph": (("graph",), "kind", "hnsw"),
               "router": (("search",), "router", "finger")}


@pytest.mark.parametrize("what", UNJUDGEABLE)
def test_a_cell_the_reference_cannot_judge_is_refused_before_set_up(
        what, tmp_path, monkeypatch):
    """A metric outside the three, a graph other than the exact K-NN graph
    or a router the reference does not search with is refused as the cell
    is loaded, and by ``run_cell`` and the control before any set-up."""
    cell = tiny("sift1m.offline")
    group, key, value = UNJUDGEABLE[what]
    part = cell.config
    for g in group:
        part = part[g]
    part[key] = value

    def no_set_up(*a, **kw):
        raise AssertionError("set-up began")
    monkeypatch.setattr(harness.data, "make_inputs", no_set_up)
    with pytest.raises(ValueError, match="cannot judge"):
        harness.run_cell(cell, 1, 0.1, False, torch.device("cpu"),
                         time.perf_counter())
    with pytest.raises(ValueError, match="cannot judge"):
        control.run_control(cell.config, 1, torch.device("cpu"))
    (tmp_path / "perfbench" / "configs").mkdir(parents=True)
    (tmp_path / "perfbench" / "configs" / "bad.json").write_text(
        json.dumps(cell.config))
    b = bench.load_benchmark()
    b["configs"].append({"name": "bad", "source": ".", "reduced": [],
                         "file": "perfbench/configs/bad.json", "why": "."})
    b["workloads"].append({"name": "bad.offline", "config": "bad",
                           "traffic": "offline", "chips": 1, "why": "."})
    with pytest.raises(ValueError, match="cannot judge"):
        bench.find_cell("bad.offline", b, repo=tmp_path)


def _state_unchanged(orig):
    """The hop loop returns its first state: the entry point alone."""
    def search_on(self, fn, queries, spec):
        ids, dists, st = orig(self, fn, queries, spec)
        ids[:, 1:], dists[:, 1:] = -1, np.inf
        ids[:, 0] = self.graph.entry_point
        dists[:, 0] = ((queries - self.graph.vectors[ids[:, 0]]) ** 2).sum(1)
        for c in ("dist_calls", "est_calls", "hops", "sq8_calls",
                  "rerank_calls"):
            getattr(st, c)[:] = c == "dist_calls"
        return ids, dists, st
    return search_on


def _half_batch(orig):
    """Half of the batch is searched; the other half repeats its rows."""
    def search_on(self, fn, queries, spec):
        ids, dists, st = orig(self, fn, queries, spec)
        h = len(ids) // 2
        ids[h:], dists[h:] = ids[:len(ids) - h], dists[:len(ids) - h]
        return ids, dists, st
    return search_on


def _answer_altered(orig):
    """One id of one answer is altered where it is produced."""
    def search_on(self, fn, queries, spec):
        ids, dists, st = orig(self, fn, queries, spec)
        ids[0, 3] = (ids[0, 3] + 1) % self.graph.n
        return ids, dists, st
    return search_on


def _later_answer_altered(orig):
    """After the first call, one id of one answer is altered where it is
    produced."""
    calls = []

    def search_on(self, fn, queries, spec):
        ids, dists, st = orig(self, fn, queries, spec)
        if calls:
            ids[-1, 0] = (ids[-1, 0] + 1) % self.graph.n
        calls.append(1)
        return ids, dists, st
    return search_on


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _later_answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(AnnIndex, "search_on", fault(AnnIndex.search_on))
    r = _run(name)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_command_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "sift1m.offline",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_the_command_fails_outside_a_checkout(tmp_path):
    """With only BENCHMARK.json and the benchmark's folder (no program),
    the run fails and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "sift1m.offline",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_new_mix_and_metric_are_found_by_name_from_new_files(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "loops").mkdir()
    (tmp_path / "traffic" / "scratch_mix.json").write_text(json.dumps(
        {"loop": "scratch_loop", "batch": 7}))
    (tmp_path / "loops" / "scratch_loop.py").write_text(
        "def run(ctx):\n    return ctx\n")
    (tmp_path / "metrics" / "scratch.metric.py").write_text(
        "def read(record):\n    return record['x'] * 2\n")
    b = bench.load_benchmark()
    b["workloads"].append({"name": "sift1m.scratch", "config": "sift1m",
                           "traffic": "scratch_mix", "chips": 1, "why": "."})
    b["per_layer"].append({"name": "scratch.metric", "unit": "x",
                           "workloads": ["sift1m.scratch"]})
    cell = bench.find_cell("sift1m.scratch", b, root=tmp_path)
    assert cell.mix == {"loop": "scratch_loop", "batch": 7}
    assert cell.loop.run(5) == 5
    assert [m["name"] for m in cell.per_layer] == ["scratch.metric"]
    assert bench.read_metrics(cell.per_layer, {"x": 4}, root=tmp_path) == \
        {"scratch.metric": {"value": 8.0, "unit": "x"}}
    with pytest.raises(KeyError):
        bench.find_cell("sift1m.nothing", b, root=tmp_path)


class _Clock:
    """A clock that moves a quarter second each reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def test_a_new_cell_from_new_files_alone(tmp_path, monkeypatch):
    """A later PR's cell: a mix of 128 rows a batch and a configuration
    with the router ``none``, added as new files in a copy of the
    benchmark's folder and new entries, run through ``run_cell`` as they
    stand.  Batches that wrap round the query set answer each query in
    other company; every answer is judged."""
    import shutil
    bdir = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bdir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = tiny("sift1m.offline").config
    cfg["n_query"] = 300
    cfg["search"]["router"] = "none"
    (bdir / "configs" / "sift_none.json").write_text(json.dumps(cfg))
    (bdir / "traffic" / "rows128.json").write_text(json.dumps(
        {"loop": "closed", "batch": 128}))
    b = bench.load_benchmark()
    b["configs"].append({"name": "sift_none", "source": ".", "reduced": [],
                         "file": "perfbench/configs/sift_none.json",
                         "why": "."})
    b["workloads"].append({"name": "sift_none.rows128",
                           "config": "sift_none", "traffic": "rows128",
                           "chips": 1, "why": "."})
    cell = bench.find_cell("sift_none.rows128", b, root=bdir, repo=tmp_path)
    # four batches of the window, whatever the host's pace: 512 rows
    monkeypatch.setattr(cell.loop, "time", _Clock())
    r = harness.run_cell(cell, 2 ** 33 + 1, 1.0, False, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] == 512 and r["info"]["calls"] == 4
    assert r["failed"] == 0 and r["checks"]["answers_differ"]["value"] == 0
    assert r["metrics"]["recall_at_10"]["value"] > 0.5


def test_answers_fold_repeats_and_count_those_that_differ():
    from perfbench.check import Request, answers

    def req(rows, shift=0):
        rows = np.asarray(rows)
        ids = np.stack([rows, rows + 1]).T + shift
        return Request(rows, ids, ids.astype(np.float32),
                       {"hops": rows * 2})
    a = answers([req([4, 1, 4]), req([1, 2]), req([2, 4], shift=1)], 6, 7)
    assert a.rows.tolist() == [1, 2, 4]
    assert a.times.tolist() == [2, 2, 3]
    assert a.differ.tolist() == [0, 1, 1]
    assert a.ids.tolist() == [[1, 2], [2, 3], [4, 5]]
    assert a.counters["hops"].tolist() == [2, 4, 8]
    # an id out of range reads -1, as an empty slot
    b = answers([req([5])], 6, 6)
    assert b.ids.tolist() == [[5, -1]]


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    """Whole top-level names: ``repro_torch`` starts with ``repro``."""
    code = (
        "import sys, time, torch\n"
        "from perfbench import run, harness, control, check, reference\n"
        "from perfbench.conftest import tiny\n"
        "r = harness.run_cell(tiny('gist500k.offline'), 5, 0.1, False, "
        "torch.device('cpu'), time.perf_counter())\n"
        "assert r['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded, found = p.stdout.strip().splitlines()[-2:]
    assert "repro_torch" in loaded
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert f"'{name}'" not in loaded
    assert found == "[]"


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_contract():
    b = bench.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    e2e = [m["name"] for m in b["end_to_end"]]
    per = [m["name"] for m in b["per_layer"]]
    for n in names + cells + e2e + per:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(e2e + per)) == len(e2e + per)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank"))
                   for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert 0 < len(c["why"]) <= 200 and 0 < len(c["source"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reports = [m for m in b["per_layer"] if cell in m["workloads"]]
        assert reports and any(m["name"] != "setup_s" for m in b["end_to_end"])
