"""Quickstart on the PyTorch/CUDA port: build a CRouting-HNSW index and see
the distance-call savings.  The counterpart of examples/quickstart.py; the
searches run the default ``fused`` engine, whose hop loop launches the
``fused_expand`` and ``pool_merge`` CUDA kernels on the GPU (their plain
PyTorch versions on the CPU).

    PYTHONPATH=src python examples/quickstart_torch.py                # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.data.vectors import (exact_ground_truth, make_dataset,
                                      recall_at_k)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(device: Optional[str] = None):
    dev = resolve_device(device)
    ops.reset_launch_counts()
    # 1. a clustered synthetic dataset (stands in for SIFT; dim matches)
    ds = make_dataset(n_base=5000, n_query=100, dim=128, n_clusters=64,
                      seed=0)

    # 2. build the graph index; CRouting keeps the construction-time edge
    #    distances and samples the dataset's angle distribution (paper §4.1)
    idx = AnnIndex.build(ds.base, graph="hnsw", m=16, efc=128, device=dev)
    print(f"index built: {idx.graph.n} nodes on {dev}, "
          f"theta* = {idx.profile.theta_star/np.pi:.3f}*pi "
          f"(90th pct of {len(idx.profile.samples)} sampled angles)")

    # 3. search with and without routing plugins — any registry entry works
    #    (repro_torch.core.routers: none | crouting | crouting_o | triangle |
    #    finger)
    gt = exact_ground_truth(ds, k=10, device=dev)
    calls = {}
    for router in ("none", "crouting", "finger"):
        ids, dists, stats = idx.search(
            ds.queries, spec=SearchSpec(k=10, efs=96, router=router))
        rec = recall_at_k(ids, gt, 10)
        calls[router] = stats.dist_calls.mean()
        print(f"router={router:9s} recall@10={rec:.3f} "
              f"dist_calls/query={stats.dist_calls.mean():7.1f} "
              f"estimates/query={stats.est_calls.mean():7.1f}")

    # 4. the paper's headline: same accuracy, far fewer exact distance calls
    saved = 1 - calls["crouting"] / calls["none"]
    print(f"CRouting skipped {saved:.1%} of exact distance computations")
    print("kernel launches: " + json.dumps(dict(ops.LAUNCHES)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
