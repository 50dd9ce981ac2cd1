"""What a cell is made of, found by name from ``BENCHMARK.json``.

* a cell: one entry of ``workloads``;
* its configuration: ``configs/<config>.json`` (the file the entry of
  ``configs`` names);
* its traffic mix: ``traffic/<traffic>.json``, parameters that the loop the
  mix names (``loops/<loop>.py``) reads;
* each metric, end-to-end or per-layer: ``metrics/<name>.py``, whose
  ``read(record)`` returns the number or None where it finds nothing to
  read.

A later cell, configuration, mix or metric is new files and new entries;
nothing here changes for it.  A cell whose configuration the benchmark
cannot judge (``check.judgeable``) is refused as it is loaded.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

from perfbench import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    entry: dict       # the workloads entry
    config: dict      # configs/<config>.json
    mix: dict         # traffic/<traffic>.json
    loop: ModuleType  # loops/<mix's loop>.py
    end_to_end: List[dict]   # metric entries this cell reports
    per_layer: List[dict]


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = HERE) -> ModuleType:
    return load_module(root / "metrics" / f"{name}.py")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict, root: Path = HERE,
              repo: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    entry = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((repo / conf["file"]).read_text())
    check.judgeable(config)
    mix = json.loads((root / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    loop = load_module(root / "loops" / f"{mix['loop']}.py")
    return Cell(name, entry, config, mix, loop,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_benchmark(repo: Path = ROOT) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def read_metrics(metrics: List[dict], record: dict,
                 root: Path = HERE) -> dict:
    """Each metric's reading; one whose reader finds nothing is left out."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"], root).read(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
