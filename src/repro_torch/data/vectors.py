"""Deterministic synthetic vector datasets + exact ground truth.

The counterpart of ``repro.data.vectors``: ``make_dataset`` is a NumPy copy
and gives byte-identical arrays for the same arguments and seed.  SIFT /
DEEP / MSONG / MNIST / GIST are stood in for by synthetic hierarchically
clustered Gaussian mixtures with matched dimensionality.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class VectorDataset:
    name: str
    base: np.ndarray      # [N, d] float32
    queries: np.ndarray   # [Q, d] float32
    metric: str = "l2"
    gt: Optional[np.ndarray] = None  # [Q, K] exact nearest ids (lazily filled)


def make_dataset(
    name: str = "synth",
    n_base: int = 10_000,
    n_query: int = 100,
    dim: int = 128,
    n_clusters: int = 64,
    cluster_std: float = 0.25,
    metric: str = "l2",
    seed: int = 0,
    heavy_tail: bool = False,
    sub_spread: float = 0.5,
) -> VectorDataset:
    """Hierarchically clustered Gaussian mixture (super-clusters of
    sub-clusters), queries from the same mixture.  ``n_clusters=1`` is one
    Gaussian cloud."""
    rng = np.random.default_rng(seed)
    n_super = max(1, int(np.sqrt(n_clusters)))
    n_sub = max(1, n_clusters // n_super)
    sup = rng.normal(size=(n_super, dim)).astype(np.float32)
    sup /= np.linalg.norm(sup, axis=1, keepdims=True)
    centers = (sup[:, None, :] + sub_spread
               * rng.normal(size=(n_super, n_sub, dim)).astype(np.float32))
    centers = centers.reshape(n_super * n_sub, dim)
    n_cl = centers.shape[0]

    def _sample(n, salt):
        r = np.random.default_rng(seed * 1_000_003 + salt)
        which = r.integers(0, n_cl, size=n)
        x = centers[which] + cluster_std * r.normal(size=(n, dim)).astype(np.float32)
        if heavy_tail:
            scale = np.exp(0.5 * r.normal(size=(n, 1))).astype(np.float32)
            x = x * scale
        return x.astype(np.float32)

    base = _sample(n_base, 1)
    queries = _sample(n_query, 2)
    base = D.preprocess_vectors(base, metric)
    queries = D.preprocess_vectors(queries, metric)
    return VectorDataset(name=name, base=base, queries=queries, metric=metric)


def exact_ground_truth(ds: VectorDataset, k: int = 10, block: int = 512,
                       device: DeviceLike = None) -> np.ndarray:
    """Blocked brute-force exact top-k (the oracle for recall).

    On ``device="cpu"`` this is the JAX package's NumPy path (identical ids).
    On the GPU (the default) each block is one fp32 ``torch.matmul`` (TF32
    off) plus ``torch.topk``; ties between equal distances may be ordered
    differently, which recall does not see.
    """
    if ds.gt is not None and ds.gt.shape[1] >= k:
        return ds.gt[:, :k]
    dev = resolve_device(device)
    out = np.empty((ds.queries.shape[0], k), dtype=np.int64)
    if dev.type == "cuda":
        met = D.get_metric(ds.metric)
        xb = torch.as_tensor(ds.base, device=dev)
        for s in range(0, ds.queries.shape[0], block):
            q = torch.as_tensor(ds.queries[s: s + block], device=dev)
            _, idx = torch.topk(met.pairwise(q, xb), k, dim=1, largest=False,
                                sorted=True)
            out[s: s + block] = idx.cpu().numpy()
        del xb
    else:
        for s in range(0, ds.queries.shape[0], block):
            q = ds.queries[s: s + block]
            dist = D.pairwise_np(q, ds.base, ds.metric)
            idx = np.argpartition(dist, kth=k - 1, axis=1)[:, :k]
            row = np.take_along_axis(dist, idx, axis=1)
            order = np.argsort(row, axis=1, kind="stable")
            out[s: s + block] = np.take_along_axis(idx, order, axis=1)
    ds.gt = out
    return out


def recall_at_k(found_ids: np.ndarray, gt_ids: np.ndarray, k: int = 10) -> float:
    """Recall@K = |found ∩ true| / K averaged over queries (paper §5.1)."""
    hits = 0
    for f, g in zip(found_ids[:, :k], gt_ids[:, :k]):
        hits += len(set(int(i) for i in f if i >= 0) & set(int(i) for i in g))
    return hits / (len(gt_ids) * k)


# (name, n_base, dim) stand-ins for the paper's Table 2 datasets, scaled down
# but keeping each dataset's dimensionality.
PAPER_DATASETS = {
    "sift-synth": dict(dim=128, n_clusters=64),
    "deep-synth": dict(dim=256, n_clusters=64),
    "msong-synth": dict(dim=420, n_clusters=36),
    "mnist-synth": dict(dim=784, n_clusters=25),
    "gist-synth": dict(dim=960, n_clusters=36),
}


def paper_dataset(name: str, n_base: int = 10_000, n_query: int = 100,
                  metric: str = "l2", seed: int = 0) -> VectorDataset:
    cfg = PAPER_DATASETS[name]
    return make_dataset(name=name, n_base=n_base, n_query=n_query,
                        dim=cfg["dim"], n_clusters=cfg["n_clusters"],
                        metric=metric, seed=seed)
