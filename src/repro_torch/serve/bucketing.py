"""Bucket-ladder batch shaping (DESIGN.md §6, serving frontend).

A copy of ``repro.serve.bucketing`` (the port imports nothing of the JAX
package).  An engine pays one-time work for each new input *shape* (in the
port: allocations and, at a kernel's first call, its library load — the
``SearchEngine`` ledger's first-use events): a ragged stream of request
sizes (1, 7, 3, 19, ...) would pay it for every new batch size on the
request path.  The frontend instead rounds
every micro-batch up to a fixed ladder of bucket sizes (default 1/8/32/128),
pads the query matrix, and passes a ``valid`` mask so padded lanes never
pollute results or counters.  After a one-time warmup of every rung, any
request mix replays against at most ``len(buckets)`` batch shapes.

Padding repeats real query rows rather than inserting zeros: a duplicated
row provably changes nothing (per-query lanes are independent and its
counters are masked), while an all-zero query could run the hop loop longer
than any real lane and stretch the batch's iteration count.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (1, 8, 32, 128)


def validate_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Normalize a bucket ladder: sorted, unique, positive ints."""
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"bucket ladder must be positive ints, got {buckets}")
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest rung >= n.  Raises for n beyond the ladder (the frontend
    rejects oversized requests instead of silently splitting them)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"batch of {n} rows exceeds the largest bucket {buckets[-1]}")


def pad_to_bucket(queries: np.ndarray, bucket: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad [n, d] -> [bucket, d] by cycling real rows; returns (padded, valid).

    ``valid`` is the [bucket] bool mask the engines use to zero padded
    lanes' counters; callers slice results back to ``[:n]``.
    """
    n = queries.shape[0]
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    if n == bucket:
        return queries, np.ones((n,), bool)
    reps = np.take(queries, np.arange(bucket - n) % n, axis=0)
    padded = np.concatenate([queries, reps], axis=0)
    valid = np.zeros((bucket,), bool)
    valid[:n] = True
    return padded, valid
