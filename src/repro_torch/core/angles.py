"""Angle-distribution acquisition (paper §3.3, §4.1).

A NumPy copy of ``repro.core.angles``: same samples and ``theta_star`` for
the same graph and seed under ``l2``.  Under ``ip`` and ``cosine`` the
angles' lengths come from the rows (``core/ref_search.py``), so a profile
query's own row gives no samples, as the paper's Euclidean angles have it.

After the graph is built, ``n_sample`` (default 0.1%·N) random queries are
searched and, at every neighbor expansion (c, n), the angle
theta = ∠(cq, cn) is recovered from the three exact Euclidean distances via
the cosine theorem.  The pruning threshold theta* is a percentile (default
90th, paper §5.5) of the collected distribution.  Each profile adds its
queries and its samples to the totals ``profile.queries`` and
``profile.samples`` (``repro_torch.trace``).

Also provides the theoretical random-vector angle PDF (paper Eq. 3):
    P(eta) = Gamma(d/2) / (Gamma((d-1)/2) * sqrt(pi)) * sin^(d-2)(eta)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.special import gammaln

from repro_torch import trace
from repro_torch.core.graph import GraphIndex
from repro_torch.core.ref_search import search_ref


@dataclasses.dataclass
class AngleProfile:
    """The dataset's angle distribution + chosen pruning threshold."""

    theta_star: float          # selected angle (radians)
    cos_theta_star: float
    percentile: float          # which percentile theta_star is
    samples: np.ndarray        # raw sampled angles (radians)
    n_sample_queries: int
    sample_secs: float
    # Corpus size at sampling time: after mutation, |n_now - corpus_n| /
    # corpus_n measures profile staleness (MutableAnnIndex refresh policy).
    corpus_n: int = 0

    def at_percentile(self, pct: float) -> "AngleProfile":
        th = float(np.percentile(self.samples, pct))
        return dataclasses.replace(
            self, theta_star=th, cos_theta_star=float(np.cos(th)), percentile=pct)


def theoretical_angle_pdf(eta: np.ndarray, d: int) -> np.ndarray:
    """Paper Eq. 3 — PDF of the angle between two random vectors in R^d."""
    logc = gammaln(d / 2.0) - gammaln((d - 1) / 2.0) - 0.5 * np.log(np.pi)
    return np.exp(logc + (d - 2) * np.log(np.maximum(np.sin(eta), 1e-300)))


def sample_angle_profile(
    g: GraphIndex,
    n_sample: Optional[int] = None,
    efs: int = 100,
    percentile: float = 90.0,
    seed: int = 0,
    queries: Optional[np.ndarray] = None,
) -> AngleProfile:
    """Instrumented searches over random queries -> empirical theta distribution.

    Default n_sample = max(8, 0.1%·N) per paper §4.1; overhead is recorded so
    benchmarks can verify the <4% construction-time claim.

    When ``queries`` is supplied, ALL of them are searched unless the caller
    also passes an explicit ``n_sample`` cap — the default cap applies only
    to the random-sampling path (a held-out query set must never be silently
    truncated to 0.1%·N).  ``n_sample_queries`` records the number of
    queries actually searched.
    """
    import time

    t0 = time.time()
    n = g.n
    if queries is None:
        if n_sample is None:
            n_sample = max(8, int(0.001 * n))
        rng = np.random.default_rng(seed)
        queries = g.vectors[rng.integers(0, n, size=n_sample)]
    elif n_sample is not None:
        queries = queries[:n_sample]

    angles = []
    for q in queries:
        _, _, stats = search_ref(g, q, efs=efs, k=1, router=None, record_angles=True)
        angles.extend(stats.angles)
    trace.add("profile.queries", len(queries))
    trace.add("profile.samples", len(angles))
    samples = np.asarray(angles, dtype=np.float64)
    if samples.size == 0:
        samples = np.asarray([np.pi / 2])
    th = float(np.percentile(samples, percentile))
    return AngleProfile(
        theta_star=th,
        cos_theta_star=float(np.cos(th)),
        percentile=percentile,
        samples=samples,
        n_sample_queries=len(queries),
        sample_secs=time.time() - t0,
        corpus_n=n,
    )
