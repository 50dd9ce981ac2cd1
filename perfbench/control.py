"""The control of the comparison: the reference, put in the program's
place, a step below the configuration's float32.

The control builds the K-NN graph from products of TF32 operands, and
profiles and searches on bf16 vectors, all under the configuration's
metric (under ``cosine`` on rows normalised before they are rounded);
``check.judge`` then judges what it produced exactly as it judges the
program's run.  A sound comparison
finds it not correct.  The benchmark's runs never run it; run it on the
card at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3

Each seed prints one JSON line with the readings beside their limits.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:] = [str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import check, data  # noqa: E402
from perfbench import reference as R  # noqa: E402


def control_side(inputs: data.Inputs, cfg: dict) -> check.Side:
    base, n, metric = inputs.base, inputs.base.shape[0], cfg["metric"]
    nbrs, edges = R.knn_graph(base, cfg["graph"]["k"], "low", metric)
    entry = R.medoid(base, "low", metric)
    x = R.rows_in(base, "low", metric)
    prof = cfg["profile"]
    angles = R.profile_angles(x.cpu().numpy(), nbrs.cpu().numpy(), entry,
                              x[inputs.profile_rows].cpu().numpy(),
                              prof["efs"], metric)
    theta = float(np.percentile(angles, prof["percentile"]))
    spec = cfg["search"]
    sq8 = R.sq8_tables(x) if spec["estimate"] in R.TWO_STAGE else None
    xp, nb, ed = R.with_pad(x, nbrs, edges)
    found = R.search_blocks(xp, nb, ed, entry,
                            R.rows_in(inputs.queries, "low", metric),
                            math.cos(theta), spec, metric, sq8,
                            block=check.rows_block(
                                x.shape[1], spec["beam_width"] * nbrs.shape[1]))
    ids = torch.where(found.ids >= n, -1, found.ids)
    nq = ids.shape[0]
    return check.Side(
        nbrs=nbrs.cpu().numpy(), edges=edges.cpu().numpy(), angles=angles,
        answers=check.Answers(
            rows=np.arange(nq), ids=ids.cpu().numpy(),
            dists=found.dists.float().cpu().numpy(),
            counters={c: v.cpu().numpy() for c, v in found.counters.items()},
            times=np.ones(nq, np.int64), differ=np.zeros(nq, np.int64)))


def run_control(cfg: dict, seed: int, device) -> dict:
    check.judgeable(cfg)
    inputs = data.make_inputs(cfg, seed, device)
    t0 = time.perf_counter()
    side = control_side(inputs, cfg)
    t1 = time.perf_counter()
    correct, checks, _ = check.judge(inputs, side, cfg, seed)
    return {"seed": seed, "correct": correct, "control_s": t1 - t0,
            "judge_s": time.perf_counter() - t1, "checks": checks}


def main(argv=None) -> int:
    from perfbench import bench
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload, bench.load_benchmark(ROOT))
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, **run_control(
            cell.config, seed, torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
