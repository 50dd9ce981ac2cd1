"""Tiny cells for the benchmark's CPU tests: each cell of BENCHMARK.json
with its configuration cut to a few thousand rows (the limits as they
stand), run on the CPU through the program's plain kernel versions."""
import copy

import pytest
import torch

from perfbench import bench


def tiny(name: str, dim: int = 32, metric: str = None) -> bench.Cell:
    """The cell at a tiny size; ``metric``, where given, in place of its
    configuration's."""
    cell = bench.find_cell(name, bench.load_benchmark())
    cfg = copy.deepcopy(cell.config)
    cfg.update(n_base=2500, n_query=48, dim=dim)
    if metric is not None:
        cfg["metric"] = metric
    cfg["data"]["latent_dim"] = 8
    cfg["graph"]["k"] = 16
    cfg["profile"]["queries"] = 64
    cfg["search"]["efs"] = 32
    cfg["check"].update(graph_rows=400, queries=48)
    return cell._replace(config=cfg)


CELLS = ("sift1m.offline", "gist500k.offline")


def metric_cases(metrics=("l2", "ip", "cosine")):
    """(cell, metric) parameters: each cell under its configuration's own
    ``l2`` keeps the cell's name as its id, another metric adds its name."""
    return [pytest.param(n, m, id=n if m == "l2" else f"{n}.{m}")
            for m in metrics for n in CELLS]


@pytest.fixture
def cpu():
    return torch.device("cpu")
