"""Distance-metric registry for the ANNS engine (PyTorch).

The counterpart of ``repro.core.distances``.  The graph-search engine ranks
candidates by a *ranking distance* (smaller is better).  CRouting's
cosine-theorem geometry lives in Euclidean space, so every metric provides
an exact, cheap bidirectional conversion between its ranking distance and
the squared Euclidean distance (paper Eq. 4):

    EuclideanDist(a, b)^2 = |a|^2 + |b|^2 + 2 * IPDist(a, b) - 2
    IPDist(a, b)          = 1 - <a, b>
    CosineDist            = IPDist on unit-normalized vectors.

For ``l2`` the ranking distance *is* the squared Euclidean distance (sqrt is
monotone, so ranking by the square is equivalent and cheaper).

The ``Metric`` callables take torch tensors; ``preprocess_vectors``,
``pairwise_np`` and ``rank_to_eu_np`` are the NumPy construction-time
twins, byte-equal to the JAX package's.  ``prepare_queries`` decides where
a query batch is preprocessed: on the card or on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels.normalize_rows import normalize_rows

METRICS = ("l2", "ip", "cosine")


@dataclasses.dataclass(frozen=True)
class Metric:
    """A ranking distance plus its Euclidean-space conversions.

    Attributes:
      name: one of METRICS.
      needs_norms: whether per-node norms must be stored in the index.
      pairwise: (Q[b,d], X[n,d]) -> ranking distance [b,n].
      point: (q[d], x[d]) -> scalar ranking distance.
      rank_to_eu2: (rank, |a|, |b|) -> squared Euclidean distance.
      eu2_to_rank: (eu2, |a|, |b|) -> ranking distance.
    """

    name: str
    needs_norms: bool
    pairwise: Callable
    point: Callable
    rank_to_eu2: Callable
    eu2_to_rank: Callable


def _l2_pairwise(q, x):
    # |q - x|^2 = |q|^2 + |x|^2 - 2 q.x ; the matmul form, as in the JAX
    # package: the K-NN graph's stored edge distances come from it, so the
    # form (not only the value) is part of the contract.  fp32 matmul with
    # TF32 off (repro_torch.device sets it).
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    xn = torch.sum(x * x, dim=-1)
    d2 = qn + xn[None, :] - 2.0 * (q @ x.T)
    return torch.clamp_min(d2, 0.0)


def _l2_point(q, x):
    d = q - x
    return torch.sum(d * d, dim=-1)


def _ip_pairwise(q, x):
    return 1.0 - q @ x.T


def _ip_point(q, x):
    return 1.0 - torch.sum(q * x, dim=-1)


def _ip_rank_to_eu2(rank, na, nb):
    return torch.clamp_min(na * na + nb * nb + 2.0 * rank - 2.0, 0.0)


def _ip_eu2_to_rank(eu2, na, nb):
    return (eu2 - na * na - nb * nb + 2.0) / 2.0


_L2 = Metric(
    name="l2",
    needs_norms=False,
    pairwise=_l2_pairwise,
    point=_l2_point,
    rank_to_eu2=lambda rank, na, nb: rank,
    eu2_to_rank=lambda eu2, na, nb: eu2,
)

_IP = Metric(
    name="ip",
    needs_norms=True,
    pairwise=_ip_pairwise,
    point=_ip_point,
    rank_to_eu2=_ip_rank_to_eu2,
    eu2_to_rank=_ip_eu2_to_rank,
)

# Cosine distance == IP distance on normalized vectors; the index stores the
# normalized vectors (norms == 1), so the conversions collapse to eu2 = 2*rank.
_COS = Metric(
    name="cosine",
    needs_norms=True,
    pairwise=_ip_pairwise,
    point=_ip_point,
    rank_to_eu2=_ip_rank_to_eu2,
    eu2_to_rank=_ip_eu2_to_rank,
)

_REGISTRY = {"l2": _L2, "ip": _IP, "cosine": _COS}


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; choose from {METRICS}")


def preprocess_vectors(x: np.ndarray, metric: str) -> np.ndarray:
    """Dataset-side preprocessing a metric requires (cosine -> normalize)."""
    if metric == "cosine":
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return (x / np.maximum(n, 1e-12)).astype(x.dtype)
    return x


def prepare_queries(queries, metric: str, dev=None):
    """A query batch as a search engine on ``dev`` takes it: float32 rows
    preprocessed for ``metric``.

    On a CUDA ``dev`` under ``cosine`` the rows are uploaded as they are
    (span ``search.normalise``) and the ``normalize_rows`` kernel normalises
    them in place; the batch's rows add to the total
    ``search.normalised_rows`` and the result is the device tensor.
    Otherwise, and for callers that read the rows on the host (``dev``
    None: the live index's delta scan, the sharded index's per-shard
    uploads), ``preprocess_vectors`` on a contiguous float32 array."""
    queries = np.ascontiguousarray(queries, np.float32)
    if metric != "cosine" or dev is None or torch.device(dev).type != "cuda":
        return preprocess_vectors(queries, metric)
    with trace.span("search.normalise"):
        q = torch.as_tensor(queries, device=dev)
        normalize_rows(q, out=q)
    trace.add("search.normalised_rows", q.shape[0])
    return q


def pairwise_np(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    """NumPy twin of Metric.pairwise (construction-time offline path)."""
    if metric == "l2":
        qn = np.sum(q * q, axis=-1, keepdims=True)
        xn = np.sum(x * x, axis=-1)
        return np.maximum(qn + xn[None, :] - 2.0 * (q @ x.T), 0.0)
    return 1.0 - q @ x.T


def rank_to_eu_np(rank: np.ndarray, na, nb, metric: str) -> np.ndarray:
    """Ranking distance -> Euclidean (non-squared) distance, NumPy."""
    if metric == "l2":
        return np.sqrt(np.maximum(rank, 0.0))
    eu2 = na * na + nb * nb + 2.0 * rank - 2.0
    return np.sqrt(np.maximum(eu2, 0.0))
