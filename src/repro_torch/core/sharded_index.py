"""Dataset-sharded ANNS serving (DESIGN.md §6), on the port's engine.

The counterpart of ``repro.core.sharded_index``.  The base set is split
into S shards, each with a search graph built over that shard alone.  A
query batch is replicated, every shard runs the batched CRouting engine
(``_search_batch``) on its own tensors, and the global top-k is a merge of
the per-shard result pools (``efs`` x S candidates a query, not a
vector-data exchange).

Straggler mitigation: each shard's search runs under a fixed hop budget
(``SearchSpec.max_hops``), so one slow shard cannot stall the merge;
quality degrades instead of latency.

Where the JAX package runs one ``shard_map`` step over a device mesh, the
port runs a per-shard loop over shard slots (``repro_torch.launch.mesh``):
each slot names the device a shard's tensors live on, and one H100 can hold
every slot.  ``make_serve_step`` returns the two halves of the reference's
step: the per-shard local search and the merge (the reference's
``all_gather`` + ``top_k`` + ``psum`` + ``pmax``) as tensor ops on the
first slot's device.  ``top_k`` takes the lower index on ties, which a
stable sort of the ``[B, S*efs]`` candidates reproduces: equal distances
from two shards come out in shard order.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.angles import AngleProfile, sample_angle_profile
from repro_torch.core.graph import GraphIndex
from repro_torch.core.routers import get_router
from repro_torch.core.search import HopGraphs, _search_batch
from repro_torch.core.spec import SearchSpec, SearchStats, resolve_search_spec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fault import failpoints as fault
from repro_torch.kernels import build
from repro_torch.quant import sq8 as SQ

@dataclasses.dataclass
class ShardedIndexArrays:
    """Stacked per-shard host arrays (leading axis = shard)."""

    vectors: np.ndarray      # [S, ns+1, d]
    neighbors: np.ndarray    # [S, ns+1, M]
    edge_eu: np.ndarray      # [S, ns+1, M]
    norms: np.ndarray        # [S, ns+1]
    entries: np.ndarray      # [S]
    offsets: np.ndarray      # [S] global id of local id 0
    ns: int                  # local shard capacity (excl. pad row)
    metric: str
    cos_theta: float
    # SQ8 companion tables (per-shard grids; SearchSpec.estimate="sq8")
    sq8_codes: np.ndarray = None   # [S, ns+1, d] uint8
    sq8_lo: np.ndarray = None      # [S, d]
    sq8_scale: np.ndarray = None   # [S, d]
    sq8_eps: np.ndarray = None     # [S, d]


def build_shards(base: np.ndarray, n_shards: int, metric: str = "l2",
                 graph: str = "hnsw", seed: int = 0,
                 profile_percentile: float = 90.0,
                 device: DeviceLike = None, **graph_kw
                 ) -> Tuple[List[GraphIndex], List[AngleProfile]]:
    """Partition the base set into contiguous blocks of ``ceil(n / S)``
    rows and build one sub-graph per block (HNSW on the host with seed
    ``seed + s``, NSG on ``device``, ``None``: the GPU), each with its
    angle profile (sampled with ``seed`` on every shard, as the reference
    does).  ``stack_shards`` turns them into the serving arrays; a mutable
    sharded index can wrap the same graphs."""
    from repro_torch.core.hnsw import build_hnsw
    from repro_torch.core.nsg import build_nsg

    if graph == "hnsw":
        def builder(sub, seed):
            return build_hnsw(sub, metric=metric, seed=seed, **graph_kw)
    elif graph == "nsg":
        dev = resolve_device(device)

        def builder(sub, seed):
            return build_nsg(sub, metric=metric, seed=seed, device=dev,
                             **graph_kw)
    else:
        raise KeyError(graph)
    base = D.preprocess_vectors(np.ascontiguousarray(base, np.float32), metric)
    n = base.shape[0]
    ns = (n + n_shards - 1) // n_shards
    graphs = [builder(base[s * ns:min((s + 1) * ns, n)], seed + s)
              for s in range(n_shards)]
    profiles = [sample_angle_profile(g, percentile=profile_percentile,
                                     seed=seed) for g in graphs]
    return graphs, profiles


def stack_shards(graphs: Sequence[GraphIndex],
                 profiles: Sequence[AngleProfile]) -> ShardedIndexArrays:
    """Stack ``build_shards``'s graphs into the serving arrays: shard s
    holds global ids ``[s * ns, s * ns + n_s)``, its pad ids remapped to
    the stacked pad slot ``ns``, its own SQ8 grid, and ``cos_theta`` is
    the median of the shards' profiled thresholds."""
    n_shards = len(graphs)
    ns = graphs[0].n
    d = graphs[0].dim
    m = max(g.max_degree for g in graphs)
    vecs = np.zeros((n_shards, ns + 1, d), np.float32)
    nbrs = np.full((n_shards, ns + 1, m), ns, np.int32)
    ed = np.full((n_shards, ns + 1, m), np.inf, np.float32)
    norms = np.ones((n_shards, ns + 1), np.float32)
    entries = np.zeros((n_shards,), np.int32)
    codes = np.zeros((n_shards, ns + 1, d), np.uint8)
    sq_lo = np.zeros((n_shards, d), np.float32)
    sq_scale = np.full((n_shards, d), 1e-12, np.float32)
    sq_eps = np.zeros((n_shards, d), np.float32)
    for s, g in enumerate(graphs):
        k = g.n
        vecs[s, :k] = g.vectors
        # remap pad ids (== k) to the stacked pad slot (== ns)
        nb = g.neighbors.copy()
        nb[nb >= k] = ns
        nbrs[s, :k, : g.max_degree] = nb
        ed[s, :k, : g.max_degree] = g.edge_eu_dist
        norms[s, :k] = g.norms if g.norms is not None else np.linalg.norm(g.vectors, axis=1)
        entries[s] = g.entry_point
        # per-shard SQ8 grid, fit on the shard's real rows; the pad rows
        # encode the zero vector and are always masked
        qp = SQ.sq8_train(g.vectors)
        codes[s] = SQ.sq8_encode(vecs[s], qp)
        sq_lo[s], sq_scale[s], sq_eps[s] = qp.lo, qp.scale, qp.eps
    return ShardedIndexArrays(
        vectors=vecs, neighbors=nbrs, edge_eu=ed, norms=norms, entries=entries,
        offsets=np.arange(n_shards, dtype=np.int64) * ns, ns=ns,
        metric=graphs[0].metric,
        cos_theta=float(np.median([p.cos_theta_star for p in profiles])),
        sq8_codes=codes, sq8_lo=sq_lo, sq8_scale=sq_scale, sq8_eps=sq_eps)


def shard_dataset(base: np.ndarray, n_shards: int, metric: str = "l2",
                  graph: str = "hnsw", seed: int = 0,
                  profile_percentile: float = 90.0,
                  device: DeviceLike = None, **graph_kw
                  ) -> ShardedIndexArrays:
    """Partition the base set; build one sub-graph per shard
    (``build_shards``) and stack them (``stack_shards``)."""
    return stack_shards(*build_shards(
        base, n_shards, metric=metric, graph=graph, seed=seed,
        profile_percentile=profile_percentile, device=device, **graph_kw))


def _backfill_sq8(arrays: ShardedIndexArrays) -> ShardedIndexArrays:
    """Fill missing SQ8 tables on a pre-existing ShardedIndexArrays."""
    S, _, d = arrays.vectors.shape
    codes = np.zeros(arrays.vectors.shape, np.uint8)
    lo = np.zeros((S, d), np.float32)
    scale = np.full((S, d), 1e-12, np.float32)
    eps = np.zeros((S, d), np.float32)
    for s in range(S):
        qp = SQ.sq8_train(arrays.vectors[s])
        codes[s] = SQ.sq8_encode(arrays.vectors[s], qp)
        lo[s], scale[s], eps[s] = qp.lo, qp.scale, qp.eps
    return dataclasses.replace(arrays, sq8_codes=codes, sq8_lo=lo,
                               sq8_scale=scale, sq8_eps=eps)


def shard_tensors(arrays: ShardedIndexArrays, s: int,
                  dev: torch.device) -> Dict[str, object]:
    """Shard ``s`` as the engine's arrays dict (``_search_batch``) on
    ``dev``, with its global-id ``offset`` beside it."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return {"vectors": t(arrays.vectors[s]), "neighbors": t(arrays.neighbors[s]),
            "edge_eu": t(arrays.edge_eu[s]), "norms": t(arrays.norms[s]),
            "entry": int(arrays.entries[s]), "n": arrays.ns,
            "sq8_codes": t(arrays.sq8_codes[s]), "sq8_lo": t(arrays.sq8_lo[s]),
            "sq8_scale": t(arrays.sq8_scale[s]),
            "sq8_eps": t(arrays.sq8_eps[s]),
            "offset": int(arrays.offsets[s])}


def make_serve_step(cfg: SearchSpec, ns: int):
    """The serve step's two halves: ``(local_search, merge)``.

    ``local_search(shard, queries, cos_theta, valid, graphs=None)`` runs
    one shard's search (``shard`` from ``shard_tensors``; ``valid`` [B]
    bool marks the real lanes of a bucket-padded batch, padded lanes count
    zero; ``graphs``: the shard's ``HopGraphs``, which replay its hop
    iterations on a CUDA device) and
    returns ``(dists [B, efs], global ids [B, efs] int32 with -1 for empty
    slots, SearchResult)``.

    ``merge(parts)`` folds the S shards' outputs on the first one's device:
    an ``efs``-wide re-top-k (``k`` slices on the host, so ``k`` stays
    request-only) and the counter vector ``[dist_calls, est_calls,
    rerank_calls, sq8_calls, hops, iters, *Router.extra_counters]``, sums
    over shards and queries except ``iters``, the maximum over shards.
    """
    extra_names = get_router(cfg.router).extra_counters
    kk = cfg.efs              # merge width; k slices host-side

    def local_search(shard, queries, cos_theta, valid, graphs=None):
        res = _search_batch(shard, queries, cos_theta, cfg, valid=valid,
                            graphs=graphs)
        loc_d, loc_i = res.dists[:, :kk], res.ids[:, :kk]
        glob_i = torch.where(loc_i < ns, loc_i + shard["offset"], -1)
        return loc_d, glob_i.to(torch.int32), res

    def merge(parts):
        dev = parts[0][0].device
        B = parts[0][0].shape[0]
        flat_d = torch.stack([p[0].to(dev) for p in parts], 1).reshape(B, -1)
        flat_i = torch.stack([p[1].to(dev) for p in parts], 1).reshape(B, -1)
        d, pos = torch.sort(flat_d, dim=1, stable=True)
        ids = flat_i.gather(1, pos[:, :kk])
        sums = torch.stack([torch.stack(
            [r.dist_calls.sum(), r.est_calls.sum(), r.rerank_calls.sum(),
             r.sq8_calls.sum(), r.hops.sum()]
            + [r.extra[nm].sum() for nm in extra_names]).to(dev)
            for _, _, r in parts]).sum(0).tolist()
        iters = max(int(r.iters) for _, _, r in parts)
        return d[:, :kk], ids, sums[:5] + [iters] + sums[5:]

    return local_search, merge


class ShardedStep:
    """The serve step for one canonical spec, with its first-use ledger.

    Counts one setup, each batch shape it first runs, each kernel library
    its calls first load and each call that captured a hop graph on a
    batch shape it had run (a new cos(theta*), say; ``SearchEngine``), once
    for the step and not per shard: the counterpart of the reference's one
    jitted step, which compiles once per batch shape whatever the shard
    count.
    """

    def __init__(self, cfg: SearchSpec, ns: int):
        self.local_search, self.merge = make_serve_step(cfg, ns)
        self._lock = threading.Lock()
        self._shapes: set = set()       # guarded by: self._lock
        self._loads = 0                 # guarded by: self._lock
        self._recaptures = 0            # guarded by: self._lock
        # each shard's captured hop iterations, by its position
        self._graphs: Dict[int, HopGraphs] = {}   # guarded by: self._lock

    def __call__(self, shards, queries: np.ndarray, cos_theta: float,
                 valid: np.ndarray):
        loads0 = build.first_loads_on_this_thread()
        on_dev = {}
        parts = []
        captured = False
        for i, shard in enumerate(shards):
            dev = shard["vectors"].device
            if dev not in on_dev:
                on_dev[dev] = (torch.as_tensor(queries, device=dev),
                               torch.as_tensor(valid, device=dev))
            q, v = on_dev[dev]
            with self._lock:
                graphs = self._graphs.setdefault(i, HopGraphs())
            caps0 = graphs.captures_on_this_thread()
            parts.append(self.local_search(shard, q, cos_theta, v, graphs))
            captured |= graphs.captures_on_this_thread() > caps0
        out = self.merge(parts)
        loads = build.first_loads_on_this_thread() - loads0
        shape = tuple(queries.shape)
        with self._lock:
            self._recaptures += int(captured and shape in self._shapes)
            self._shapes.add(shape)
            self._loads += loads
        return out

    def first_uses(self) -> int:
        """Setup (1) + batch shapes run + kernel libraries first loaded +
        calls that captured on a shape run before."""
        with self._lock:
            return 1 + len(self._shapes) + self._loads + self._recaptures


class ShardedAnnIndex:
    """Place shards on their slots and serve batched queries.

    ``mesh`` is a ``repro_torch.launch.mesh.LocalMesh`` with one slot per
    shard (``None``: every shard on the GPU).  ``spec`` is the same
    ``SearchSpec`` the single-index path takes (``metric``/
    ``use_hierarchy`` are overridden from the shard arrays); anything else
    raises ``TypeError``.  Per-call specs that differ only in the
    request-only fields (``k``/``cos_theta``) reuse the serve step (``k``
    slices the ``efs``-wide merge on the host, ``cos_theta`` is a call
    argument); an engine-shaping change sets up one new step, cached per
    canonical spec.  Routers that need per-graph companion tables
    (``Router.companion_tables``, e.g. ``finger``) are not plumbed through
    the stacked per-shard arrays and are rejected here.
    """

    DEFAULT_SEARCH = SearchSpec(k=10, efs=100, router="crouting",
                                max_hops=2048)

    def __init__(self, arrays: ShardedIndexArrays, mesh=None,
                 spec: Optional[SearchSpec] = None):
        from repro_torch.launch.mesh import make_local_mesh

        spec = resolve_search_spec(spec, self.DEFAULT_SEARCH,
                                   "ShardedAnnIndex")
        spec = dataclasses.replace(spec, metric=arrays.metric,
                                   use_hierarchy=False)
        n_shards = arrays.vectors.shape[0]
        if mesh is None:
            mesh = make_local_mesh(n_shards, "shards")
        if len(mesh.devices) != n_shards:
            raise ValueError(f"{n_shards} shards need {n_shards} shard "
                             f"slots, the mesh has {len(mesh.devices)}")
        if arrays.sq8_codes is None:
            # arrays predating the SQ8 tables: backfill per-shard grids from
            # the stacked vectors (the zero pad rows only widen the grid, so
            # the lower-bound contract holds)
            arrays = _backfill_sq8(arrays)
        self.arrays = arrays
        self.mesh = mesh
        self.spec = spec
        self._lock = threading.Lock()
        # canonical spec -> ShardedStep -- guarded by: self._lock
        self._steps: Dict[SearchSpec, ShardedStep] = {}
        self._placed: Tuple[Dict[str, object], ...] = tuple(
            shard_tensors(arrays, s, dev)
            for s, dev in enumerate(mesh.devices))
        self._step(spec)       # validate the construction spec

    def _step(self, spec: SearchSpec) -> ShardedStep:
        """The serve step for ``spec`` (its ``metric``/``use_hierarchy``
        taken from the shards), cached per canonical form."""
        key = dataclasses.replace(spec, metric=self.arrays.metric,
                                  use_hierarchy=False).canonical()
        with self._lock:
            fn = self._steps.get(key)
            if fn is not None:
                return fn
            rt = get_router(spec.router)
            if rt.companion_tables:
                raise NotImplementedError(
                    f"router {spec.router!r} needs companion tables "
                    f"{rt.companion_tables} which the sharded arrays do not "
                    "carry yet; use the single-index path")
            fn = self._steps[key] = ShardedStep(key, self.arrays.ns)
            return fn

    def search(self, queries: np.ndarray, spec=None, *,
               valid: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Returns (ids [B,k] int32, dists [B,k], SearchStats).

        ``spec`` overrides the construction spec for this call (non-
        ``SearchSpec`` values raise ``TypeError``).  ``valid`` [B] bool
        marks the real lanes of a bucket-padded batch; padded lanes count
        zero.  The stats fields are batch TOTALS over shards and queries
        (``iters`` is the straggler's count), not per-query arrays.
        """
        spec = resolve_search_spec(spec, self.spec, "ShardedAnnIndex.search")
        # the shards answer together: a fault fails the whole dispatch,
        # and the serving frontend contains it to its batch (DESIGN.md §10:
        # MutableShardedAnnIndex's host composition degrades instead)
        fault.hit("sharded.search")
        fn = self._step(spec)
        q = D.prepare_queries(queries, self.arrays.metric)
        # precedence: spec override > profiled shard median
        ct = spec.cos_theta
        if ct is None:
            ct = self.arrays.cos_theta
        v = (np.ones((q.shape[0],), bool) if valid is None
             else np.asarray(valid, bool))
        d, i, sv = fn(self._placed, q, float(np.float32(ct)), v)
        extra_names = get_router(spec.router).extra_counters
        stats = SearchStats(
            dist_calls=int(sv[0]), est_calls=int(sv[1]),
            rerank_calls=int(sv[2]), sq8_calls=int(sv[3]), hops=int(sv[4]),
            iters=int(sv[5]), router=spec.router,
            extra={nm: int(sv[6 + j]) for j, nm in enumerate(extra_names)})
        k = spec.k
        return (i[:, :k].cpu().numpy(), d[:, :k].cpu().numpy(), stats)
