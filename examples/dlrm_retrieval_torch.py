"""CRouting applied to recsys retrieval, on the PyTorch/CUDA port: the
dlrm-mlperf ``retrieval_cand`` path of examples/dlrm_retrieval.py, step for
step.  Brute-force scoring (one matrix product + top-k) is the exact
baseline; a CRouting-HNSW index over the same item embeddings
(``metric="ip"``) answers the same queries with a fraction of the exact
distance computations; the ``l2_distance`` kernel in ip mode is the
brute-force hot path.

    PYTHONPATH=src python examples/dlrm_retrieval_torch.py            # GPU
    PYTHONPATH=src python examples/dlrm_retrieval_torch.py --device cpu --n-cand 2000
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.dlrm import DlrmConfig, make_retrieval_step


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """``n`` L2-normalised Gaussian rows (item embeddings as a trained
    DLRM tower would emit them)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def run(n_cand: int = 100_000, n_query: int = 32, k: int = 100,
        device: Optional[str] = None, seed: int = 0) -> Dict[str, float]:
    """The example's three steps; returns what it prints."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = 128
    cands = unit_rows(rng, n_cand, d)
    queries = unit_rows(rng, n_query, d)
    qt = torch.as_tensor(queries, device=dev)
    ct = torch.as_tensor(cands, device=dev)

    # --- baseline: brute-force batched dot (the retrieval step) -----------
    step = make_retrieval_step(DlrmConfig(), k=k)
    t0 = time.perf_counter()
    _, ids_bf = step(qt, ct)
    ids_bf = ids_bf.cpu().numpy()
    t_bf = time.perf_counter() - t0
    print(f"brute force: {n_cand} candidates x {n_query} queries "
          f"in {t_bf * 1e3:.0f}ms (exact)")

    # --- CRouting-ANN retrieval ---------------------------------------------
    t0 = time.perf_counter()
    idx = AnnIndex.build(cands, graph="hnsw", metric="ip", m=16, efc=96,
                         device=dev)
    t_build = time.perf_counter() - t0
    print(f"ANN index built in {t_build:.1f}s")
    ids_ann, _, stats = idx.search(
        queries, spec=SearchSpec(k=k, efs=2 * k, router="crouting"))
    recall = float(np.mean([len(set(a) & set(b)) / k
                            for a, b in zip(ids_ann, ids_bf)]))
    calls = float(stats.dist_calls.mean())
    print(f"CRouting ANN: recall@{k}={recall:.3f}, exact distance calls/query "
          f"= {calls:.0f} ({calls / n_cand:.2%} of brute force)")

    # --- the l2_distance kernel is the brute-force hot path -----------------
    block = ct[:8192]
    t0 = time.perf_counter()
    dmat = ops.l2_distance(qt[:8], block, mode="ip")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_blk = time.perf_counter() - t0
    print(f"l2_distance ({'kernel' if dev.type == 'cuda' else 'plain'}): "
          f"{dmat.shape[0]}x{dmat.shape[1]} block in {t_blk * 1e3:.1f}ms")
    return {"brute_force_secs": t_bf, "build_secs": t_build,
            "recall": recall, "dist_calls": calls,
            "dist_call_share": calls / n_cand, "block_secs": t_blk,
            "block_shape": tuple(dmat.shape)}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--n-cand", type=int, default=100_000)
    ap.add_argument("--n-query", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    return run(n_cand=a.n_cand, n_query=a.n_query, device=a.device,
               seed=a.seed)


if __name__ == "__main__":
    main()
