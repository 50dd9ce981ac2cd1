"""High-level ANNS index API: build -> profile angles -> search (PyTorch).

The counterpart of ``repro.core.index``, and the port's entry point:

    from repro_torch.core.index import AnnIndex
    from repro_torch.core.spec import SearchSpec

    idx = AnnIndex.build(base, graph="hnsw")            # device=None: the GPU
    ids, dists, stats = idx.search(
        queries, spec=SearchSpec(k=10, efs=100, router="crouting"))

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU present the default raises.  ``AnnIndex.from_payload`` takes
the dict of arrays the JAX package's ``AnnIndex._payload()`` produces, so
one graph can be searched by both packages.  ``save``/``load`` are not
ported yet (they need ``durable/`` and ``fault/``; ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.angles import AngleProfile, sample_angle_profile
from repro_torch.core.graph import GraphIndex
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.knn_graph import build_knn_graph
from repro_torch.core.routers import get_router
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec, SearchStats, resolve_search_spec
from repro_torch.device import DeviceLike, resolve_device

# What a bare `idx.search(queries)` means: crouting on the kernel engine.
DEFAULT_SEARCH = SearchSpec(k=10, efs=100, router="crouting", engine="fused")


@dataclasses.dataclass
class AnnIndex:
    graph: GraphIndex
    profile: Optional[AngleProfile] = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))

    # --- construction --------------------------------------------------------
    @classmethod
    def build(cls, base: np.ndarray, graph: str = "hnsw", metric: str = "l2",
              profile_percentile: float = 90.0, seed: int = 0,
              profile: bool = True, device: DeviceLike = None,
              **graph_kw) -> "AnnIndex":
        """Build a graph (``"hnsw"`` on the host, ``"knn"`` on ``device``)
        and sample its angle profile; the index searches on ``device``."""
        dev = resolve_device(device)
        if graph == "hnsw":
            g = build_hnsw(base, metric=metric, seed=seed, **graph_kw)
        elif graph == "knn":
            g = build_knn_graph(base, metric=metric, device=dev, **graph_kw)
        elif graph == "nsg":
            raise NotImplementedError(
                "graph='nsg' is not ported to repro_torch yet (ROADMAP.md "
                "Queue 1, construction paths)")
        else:
            raise ValueError(f"unknown graph {graph!r}; choose hnsw or knn")
        prof = sample_angle_profile(g, percentile=profile_percentile,
                                    seed=seed) if profile else None
        return cls(graph=g, profile=prof, device=dev)

    @classmethod
    def from_payload(cls, arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> "AnnIndex":
        """Rebuild an index from the JAX package's ``AnnIndex._payload()``
        dict (vectors, neighbors, edge_eu_dist, entry_point, metric, kind,
        norms, the HNSW upper layers and the ``theta_*`` profile).  The SQ8
        tables of ``estimate="sq8"|"both"`` are fit to the graph's rows at
        first use, so they need no carrying."""
        dev = resolve_device(device)
        z = arrays
        upper_ids = upper_nbrs = None
        if "n_upper" in z:
            k = int(z["n_upper"])
            upper_ids = [np.asarray(z[f"upper_ids_{i}"]) for i in range(k)]
            upper_nbrs = [np.asarray(z[f"upper_nbrs_{i}"]) for i in range(k)]
        g = GraphIndex(
            vectors=np.asarray(z["vectors"]), neighbors=np.asarray(z["neighbors"]),
            edge_eu_dist=np.asarray(z["edge_eu_dist"]),
            entry_point=int(z["entry_point"]), metric=str(z["metric"]),
            norms=None if z.get("norms") is None else np.asarray(z["norms"]),
            upper_ids=upper_ids, upper_neighbors=upper_nbrs, kind=str(z["kind"]))
        prof = None
        if "theta_samples" in z:
            th = float(z["theta_star"])
            prof = AngleProfile(
                theta_star=th, cos_theta_star=float(np.cos(th)),
                percentile=float(z["theta_pct"]),
                samples=np.asarray(z["theta_samples"]),
                n_sample_queries=int(z.get("theta_nq", 0)),
                sample_secs=float(z.get("theta_secs", 0.0)),
                corpus_n=int(z.get("theta_corpus_n", 0)))
        return cls(graph=g, profile=prof, device=dev)

    # --- search ---------------------------------------------------------------
    def search(self, queries: np.ndarray, spec: Optional[SearchSpec] = None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Batched search.  Returns (ids [B,k], dists [B,k], SearchStats);
        the stats carry dist_calls, est_calls, rerank_calls, sq8_calls and
        hops per query and the batch's iters.

        ``spec``'s ``metric`` and ``use_hierarchy`` are overridden from the
        graph, and ``cos_theta=None`` resolves to the sampled angle profile.
        A pruning router with neither a profile nor an explicit
        ``cos_theta`` raises ``ValueError``; non-pruning routers never read
        the threshold.  Slots with no result carry id -1 and distance +inf.
        Anything other than a ``SearchSpec`` (or ``None``) raises
        ``TypeError``.
        """
        spec = resolve_search_spec(spec, DEFAULT_SEARCH, "AnnIndex.search")
        queries = D.preprocess_vectors(
            np.ascontiguousarray(queries, np.float32), self.graph.metric)
        cos_theta = spec.cos_theta
        if cos_theta is None:
            if self.profile is not None:
                cos_theta = self.profile.cos_theta_star
            elif get_router(spec.router).prunes:
                raise ValueError(
                    f"router {spec.router!r} prunes on the angle threshold, "
                    "but this index was built with profile=False and the "
                    "spec carries no explicit cos_theta. Build with "
                    "profile=True, or set SearchSpec.cos_theta.")
            else:
                cos_theta = 0.0   # never read by a non-pruning router
        k = spec.k
        cfg = dataclasses.replace(
            spec, efs=max(spec.efs, k), metric=self.graph.metric,
            use_hierarchy=self.graph.upper_neighbors is not None)
        _, fn = build_search_fn(self.graph, cfg, device=self.device)
        res = fn(queries, cos_theta)
        ids = res.ids[:, :k].cpu().numpy().astype(np.int64)
        dists = res.dists[:, :k].cpu().numpy().copy()
        # empty slots resolve to the pad row: mask BOTH columns
        pad = ids >= self.graph.n
        ids[pad] = -1
        dists[pad] = np.inf
        return ids, dists, SearchStats.from_result(res, router=spec.router)
