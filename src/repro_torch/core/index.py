"""High-level ANNS index API: build -> profile angles -> search (PyTorch).

The counterpart of ``repro.core.index``, and the port's entry point:

    from repro_torch.core.index import AnnIndex
    from repro_torch.core.spec import SearchSpec

    idx = AnnIndex.build(base, graph="hnsw")            # device=None: the GPU
    ids, dists, stats = idx.search(
        queries, spec=SearchSpec(k=10, efs=100, router="crouting"))

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU present the default raises.  Graphs: ``"hnsw"`` (built on the
host), ``"knn"`` and ``"nsg"`` (built on ``device``).

Persistence is the JAX package's .npz format, version 3: ``save`` writes
it atomically (temp file, fsync, content checksum, rename; failpoint sites
``index.save.write`` and ``index.save.rename``), and ``load`` verifies the
checksum and raises ``CorruptIndexError`` on truncation or corruption and
``ValueError`` on a newer version.  A file saved by either package loads
in the other.  ``AnnIndex.from_payload`` takes the same dict of arrays in
memory (the JAX package's ``AnnIndex._payload()``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import distances as D
from repro_torch.core.angles import AngleProfile, sample_angle_profile
from repro_torch.core.graph import GraphIndex
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.knn_graph import build_knn_graph
from repro_torch.core.nsg import build_nsg
from repro_torch.core.routers import get_router
from repro_torch.core.search import build_search_fn
from repro_torch.core.spec import SearchSpec, SearchStats, resolve_search_spec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.durable.atomic import (atomic_write_npz, read_npz,
                                        verify_checksum)


def _build_hnsw(base, metric="l2", seed=0, device=None, **kw):
    return build_hnsw(base, metric=metric, seed=seed, **kw)


def _build_knn(base, metric="l2", seed=0, device=None, **kw):
    return build_knn_graph(base, metric=metric, device=device, **kw)


def _build_nsg(base, metric="l2", seed=0, device=None, **kw):
    return build_nsg(base, metric=metric, seed=seed, device=device, **kw)


# graph kind -> builder(base, metric=, seed=, device=, **graph_kw): HNSW on
# the host, the K-NN graph and NSG on ``device`` (the K-NN graph takes no
# seed).  ``AnnIndex.build`` and ``MutableAnnIndex``'s merges build through
# it.
GRAPH_BUILDERS = {"hnsw": _build_hnsw, "knn": _build_knn, "nsg": _build_nsg}

# What a bare `idx.search(queries)` means: crouting on the kernel engine.
DEFAULT_SEARCH = SearchSpec(k=10, efs=100, router="crouting", engine="fused")

# .npz payload schema version.  v1 (implicit — no stamp): files missing
# theta_nq/theta_secs.  v2: format_version + theta_corpus_n stamps.
# v3: content ``checksum`` entry, required and verified on load.
FORMAT_VERSION = 3


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
        """Build a graph (``"hnsw"`` on the host, ``"knn"`` and ``"nsg"``
        on ``device``) and sample its angle profile; the index searches on
        ``device``."""
        dev = resolve_device(device)
        if graph not in GRAPH_BUILDERS:
            raise ValueError(f"unknown graph {graph!r}; choose hnsw, knn "
                             "or nsg")
        g = GRAPH_BUILDERS[graph](base, metric=metric, seed=seed, device=dev,
                                  **graph_kw)
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
        return cls._from_payload(arrays, device)

    # --- search ---------------------------------------------------------------
    def search(self, queries: np.ndarray, spec: Optional[SearchSpec] = None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Batched search.  Returns (ids [B,k], dists [B,k], SearchStats);
        the stats carry dist_calls, est_calls, rerank_calls, sq8_calls,
        hops, pruned, first_stage and the router's own counters
        (``extra``) per query and the batch's iters.

        ``spec``'s ``metric`` and ``use_hierarchy`` are overridden from the
        graph, and ``cos_theta=None`` resolves to the sampled angle profile.
        A pruning router with neither a profile nor an explicit
        ``cos_theta`` raises ``ValueError``; non-pruning routers never read
        the threshold.  Slots with no result carry id -1 and distance +inf.
        Anything other than a ``SearchSpec`` (or ``None``) raises
        ``TypeError``.
        """
        spec = resolve_search_spec(spec, DEFAULT_SEARCH, "AnnIndex.search")
        _, fn = build_search_fn(self.graph, self.engine_spec(spec),
                                device=self.device)
        return self.search_on(fn, queries, spec)

    def engine_spec(self, spec: SearchSpec) -> SearchSpec:
        """``spec`` as the engine runs it: the result pool widened to
        ``k``, ``metric`` and ``use_hierarchy`` taken from the graph."""
        g = self.graph
        return dataclasses.replace(
            spec, efs=max(spec.efs, spec.k), metric=g.metric,
            use_hierarchy=g.upper_neighbors is not None)

    def search_on(self, fn, queries: np.ndarray, spec: SearchSpec
                  ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """``search`` through ``fn``, the engine ``build_search_fn`` gave
        for this graph and ``engine_spec(spec)``, held by the caller (a
        serving session): the engine cache's eviction cannot make such a
        call set an engine up again.  An engine of another spec raises
        ``ValueError``.  The call's pruned and first-stage lanes add to the
        totals ``search.pruned`` and ``search.first_stage``
        (``repro_torch.trace``).

        A cosine graph's queries are normalised where the engine runs
        (``distances.prepare_queries``): on the card by the
        ``normalize_rows`` kernel, counted in ``search.normalised_rows``; on
        the CPU by ``preprocess_vectors`` in NumPy."""
        if fn.graph_ref() is not self.graph or \
                fn.cfg != self.engine_spec(spec).canonical():
            raise ValueError("search_on: the engine was built for another "
                             "graph or spec")
        queries = D.prepare_queries(queries, self.graph.metric, fn.dev)
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
        res = fn(queries, cos_theta)
        with trace.span("search.to_host"):
            ids = res.ids[:, :k].cpu().numpy().astype(np.int64)
            dists = res.dists[:, :k].cpu().numpy().copy()
            # empty slots resolve to the pad row: mask BOTH columns
            pad = ids >= self.graph.n
            ids[pad] = -1
            dists[pad] = np.inf
            stats = SearchStats.from_result(res, router=spec.router)
        trace.add("search.pruned", int(stats.pruned.sum()))
        trace.add("search.first_stage", int(stats.first_stage.sum()))
        return ids, dists, stats

    # --- persistence ----------------------------------------------------------
    def _payload(self) -> Dict[str, np.ndarray]:
        """The v3 .npz payload (sans checksum: the atomic writer stamps
        it), the JAX package's ``AnnIndex._payload()`` key for key."""
        g = self.graph
        payload = dict(
            format_version=np.asarray(FORMAT_VERSION),
            vectors=g.vectors, neighbors=g.neighbors, edge_eu_dist=g.edge_eu_dist,
            entry_point=np.asarray(g.entry_point), metric=np.asarray(g.metric),
            kind=np.asarray(g.kind),
        )
        if g.norms is not None:
            payload["norms"] = g.norms
        if g.upper_neighbors:
            payload["n_upper"] = np.asarray(len(g.upper_neighbors))
            for i, (ids, mat) in enumerate(zip(g.upper_ids, g.upper_neighbors)):
                payload[f"upper_ids_{i}"] = ids
                payload[f"upper_nbrs_{i}"] = mat
        if self.profile is not None:
            payload["theta_samples"] = self.profile.samples
            payload["theta_star"] = np.asarray(self.profile.theta_star)
            payload["theta_pct"] = np.asarray(self.profile.percentile)
            payload["theta_nq"] = np.asarray(self.profile.n_sample_queries)
            payload["theta_secs"] = np.asarray(self.profile.sample_secs)
            payload["theta_corpus_n"] = np.asarray(self.profile.corpus_n)
        return payload

    def save(self, path: str):
        """Atomically persist the index (temp file + fsync + rename).

        The payload carries a content checksum; a crash at any point leaves
        ``path`` holding either the previous version or the complete new
        one.  Failpoint sites: ``index.save.write`` (raise = crash
        mid-save; ``corrupt``/``truncate`` = damage the bytes before
        publication) and ``index.save.rename`` (crash in the
        write->publish window).
        """
        atomic_write_npz(path, self._payload(),
                         write_site="index.save.write",
                         rename_site="index.save.rename")

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "AnnIndex":
        """Load a persisted index, verifying integrity first; the index
        searches on ``device`` (``None``: the GPU).

        Truncated or corrupted files (unreadable zip structure, entry
        decompression failures, or a v3 content-checksum mismatch) raise
        ``CorruptIndexError``.  A future ``format_version`` raises
        ``ValueError`` (an incompatibility, not damage).
        """
        dev = resolve_device(device)
        z = read_npz(path)
        cls._check_version(z, path)
        return cls._from_payload(z, dev)

    @staticmethod
    def _check_version(z: Dict[str, np.ndarray], path: str) -> int:
        """Version + checksum gate: v1 files predate the stamp; anything
        newer than this code knows fails loudly; v3+ files always carry a
        checksum, verified here."""
        version = int(z["format_version"]) if "format_version" in z else 1
        if version > FORMAT_VERSION:
            raise ValueError(
                f"{path}: index format_version={version} is newer than this "
                f"build understands (max {FORMAT_VERSION}); upgrade the code "
                "or re-save the index with a compatible version")
        if version >= 3:
            verify_checksum(path, z)
        return version

    @classmethod
    def _from_payload(cls, z: Dict[str, np.ndarray],
                      device: DeviceLike = None) -> "AnnIndex":
        """Rebuild graph + profile from a (verified) payload dict; extra
        keys are ignored.  v2+ payloads must carry every profile field; v1
        payloads may lack ``theta_nq``/``theta_secs``/``theta_corpus_n``."""
        dev = resolve_device(device)
        version = int(z["format_version"]) if "format_version" in z else 1
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
            if version >= 2:
                nq, secs = int(z["theta_nq"]), float(z["theta_secs"])
                corpus_n = int(z["theta_corpus_n"])
            else:
                nq = int(z["theta_nq"]) if "theta_nq" in z else 0
                secs = float(z["theta_secs"]) if "theta_secs" in z else 0.0
                corpus_n = 0
            prof = AngleProfile(
                theta_star=th, cos_theta_star=float(np.cos(th)),
                percentile=float(z["theta_pct"]),
                samples=np.asarray(z["theta_samples"]),
                n_sample_queries=nq, sample_secs=secs, corpus_n=corpus_n)
        return cls(graph=g, profile=prof, device=dev)
