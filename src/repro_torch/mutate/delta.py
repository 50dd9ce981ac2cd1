"""The delta segment: where freshly-inserted vectors live before a merge.

The counterpart of ``repro.mutate.delta``.  ``DeltaSegment`` is a
fixed-capacity, padded, brute-force-scanned side table (DESIGN.md §9).  New
vectors do NOT enter the main graph — linking into an NSG/HNSW is
expensive and would change arrays the engines hold — they land in the next
free slot here, and every search scans the segment with plain tensor code
on the index's device whose shapes never change:

* the vector table is always ``[capacity, d]`` (empty slots hold zeros and
  are masked by ``live``), so a fill-level change never changes a shape;
* distances use the reference's ranking formula (l2: squared Euclidean;
  ip/cosine: ``1 - <q, x>``), and dead or empty slots are ``+inf``;
* the segment is IMMUTABLE (copy-on-write): ``insert``/``delete`` return a
  new ``DeltaSegment`` sharing nothing mutable with the old one, which is
  what lets ``MutableAnnIndex.search`` grab a consistent (snapshot, delta)
  state with one reference read and no lock on the query path.  Each
  instance uploads its table to a device once, at its first scan there.

The scan is an XLA computation in the reference, not a Pallas kernel, so
plain PyTorch is its port.  Eager PyTorch compiles nothing per shape; what
a warmup must take off the request path instead is each first (scan kind,
batch shape, capacity, dim, metric, device) — the allocations and kernel
selections a new shape brings — and ``delta_scan_compile_count`` counts
those first uses where the reference counts its jitted scans' executables.

Quantized scan (``use_sq8=True``): the segment lazily encodes itself to
SQ8 codes on first use; stage 1 scans the dequantized codes, stage 2
exactly re-ranks only the top ``max(32, 4k)`` candidates host-side.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.quant import sq8 as SQ

_SCAN_LOCK = threading.Lock()
_SCAN_SHAPES: set = set()       # guarded by: _SCAN_LOCK


def _note_scan(kind: str, queries: torch.Tensor, table: torch.Tensor,
               metric: str) -> None:
    with _SCAN_LOCK:
        _SCAN_SHAPES.add((kind, tuple(queries.shape), tuple(table.shape),
                          metric, str(queries.device)))


def _rank(vectors: torch.Tensor, queries: torch.Tensor, metric: str):
    if metric == "l2":
        diff = queries[:, None, :] - vectors[None, :, :]
        return torch.sum(diff * diff, dim=-1)
    return 1.0 - queries @ vectors.T


def _scan_dists(vectors, live, queries, metric):
    """Ranking distances of every query to every segment slot.

    vectors [cap, d], live [cap] bool, queries [B, d] -> [B, cap] f32 with
    dead/empty slots at +inf.  Fixed shapes: fill level is data, not shape.
    """
    _note_scan("exact", queries, vectors, metric)
    d = _rank(vectors, queries, metric)
    return torch.where(live[None, :], d, torch.full_like(d, float("inf")))


def _scan_dists_sq8(codes, lo, scale, live, queries, metric):
    """Stage-1 approximate ranking distances over the uint8 codes."""
    _note_scan("sq8", queries, codes, metric)
    xhat = SQ.sq8_dequantize_rows(codes, lo, scale)        # [cap, d]
    d = _rank(xhat, queries, metric)
    return torch.where(live[None, :], d, torch.full_like(d, float("inf")))


def delta_scan_compile_count() -> int:
    """First uses of the scans in this process: one per (scan kind, batch
    shape, capacity, dim, metric, device) ever scanned.

    Feeds ``MutableAnnIndex.compile_count`` so a new scan shape on the
    request path is just as visible to serving telemetry as an engine one.
    """
    with _SCAN_LOCK:
        return len(_SCAN_SHAPES)


@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    """Immutable fixed-capacity segment of freshly-inserted vectors."""

    vectors: np.ndarray      # [capacity, d] f32, preprocessed; empty = 0
    ext_ids: np.ndarray      # [capacity] int64 external ids; -1 = empty slot
    live: np.ndarray         # [capacity] bool; False = empty OR deleted
    count: int               # high-water mark (slots [0, count) were used)
    metric: str

    @classmethod
    def empty(cls, capacity: int, dim: int, metric: str) -> "DeltaSegment":
        assert capacity >= 1, "delta capacity must be >= 1"
        return cls(vectors=np.zeros((capacity, dim), np.float32),
                   ext_ids=np.full((capacity,), -1, np.int64),
                   live=np.zeros((capacity,), bool),
                   count=0, metric=metric)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    @property
    def room(self) -> int:
        return self.capacity - self.count

    def insert(self, vectors: np.ndarray, ext_ids: np.ndarray
               ) -> "DeltaSegment":
        """Append rows (already preprocessed for ``metric``); copy-on-write."""
        vectors = np.asarray(vectors, np.float32)
        ext_ids = np.asarray(ext_ids, np.int64)
        n = vectors.shape[0]
        if n > self.room:
            raise ValueError(
                f"delta overflow: {n} rows into {self.room} free slots "
                f"(capacity {self.capacity}); merge first")
        lo, hi = self.count, self.count + n
        vec = self.vectors.copy()
        vec[lo:hi] = vectors
        ids = self.ext_ids.copy()
        ids[lo:hi] = ext_ids
        live = self.live.copy()
        live[lo:hi] = True
        return dataclasses.replace(self, vectors=vec, ext_ids=ids, live=live,
                                   count=hi)

    def delete(self, ext_id: int) -> Tuple["DeltaSegment", bool]:
        """Mark one external id dead.  Returns (segment, found)."""
        slot = np.flatnonzero((self.ext_ids[:self.count] == ext_id)
                              & self.live[:self.count])
        if slot.size == 0:
            return self, False
        live = self.live.copy()
        live[slot] = False
        return dataclasses.replace(self, live=live), True

    def contains(self, ext_id: int) -> bool:
        return bool(((self.ext_ids[:self.count] == ext_id)
                     & self.live[:self.count]).any())

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(vectors [m, d], ext_ids [m]) of the surviving rows (merge feed)."""
        mask = self.live[:self.count]
        return self.vectors[:self.count][mask], self.ext_ids[:self.count][mask]

    # --- device-side copies, cached on the (frozen) instance --------------
    def _on(self, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        # derived data, not state: each copy-on-write successor uploads
        # its own table at its first scan on ``dev``
        key = f"_dev_{dev}"
        tables = self.__dict__.get(key)
        if tables is None:
            tables = (torch.as_tensor(self.vectors, device=dev),
                      torch.as_tensor(self.live, device=dev))
            object.__setattr__(self, key, tables)
        return tables

    def _sq8(self, dev: torch.device):
        key = f"_sq8_{dev}"
        tables = self.__dict__.get(key)
        if tables is None:
            qp = SQ.sq8_train(self.vectors)
            tables = tuple(torch.as_tensor(a, device=dev) for a in (
                SQ.sq8_encode(self.vectors, qp), qp.lo, qp.scale))
            object.__setattr__(self, key, tables)
        return tables

    # --- search -----------------------------------------------------------
    def topk(self, queries: np.ndarray, k: int, use_sq8: bool = False,
             device: DeviceLike = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Brute-force top-k over the live slots, scanned on ``device``
        (``None``: the GPU).

        queries [B, d] (preprocessed) -> (ext_ids [B, k] int64 with -1 pads,
        dists [B, k] ranking distances with +inf pads, scanned [B] int32 =
        live slots each query compared against).  Runs even when the
        segment is empty — the scan's shapes are what serving warms, and an
        "empty" fast path would un-warm them.
        """
        dev = resolve_device(device)
        queries = np.ascontiguousarray(queries, np.float32)
        B = queries.shape[0]
        q_dev = torch.as_tensor(queries, device=dev)
        vectors_dev, live_dev = self._on(dev)
        if use_sq8:
            codes, lo, scale = self._sq8(dev)
            d = _scan_dists_sq8(codes, lo, scale, live_dev, q_dev,
                                self.metric).cpu().numpy()
            # stage 2: exact re-rank of the top-m approximate candidates
            m = min(self.capacity, max(32, 4 * k))
            cand = np.argpartition(d, m - 1, axis=1)[:, :m]
            rows = self.vectors[cand]                      # [B, m, d]
            if self.metric == "l2":
                diff = rows - queries[:, None, :]
                exact = np.sum(diff * diff, axis=-1)
            else:
                exact = 1.0 - np.einsum("bmd,bd->bm", rows, queries)
            d = np.full_like(d, np.inf)
            np.put_along_axis(d, cand,
                              np.where(self.live[cand], exact, np.inf),
                              axis=1)
        else:
            d = _scan_dists(vectors_dev, live_dev, q_dev,
                            self.metric).cpu().numpy()
        kk = min(k, self.capacity)
        if kk < self.capacity:
            part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        else:
            part = np.broadcast_to(np.arange(kk), (B, kk))
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1)
        dists = np.take_along_axis(pd, order, axis=1)
        ids = self.ext_ids[idx]
        ids = np.where(np.isfinite(dists), ids, -1)
        if kk < k:
            ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
            dists = np.pad(dists, ((0, 0), (0, k - kk)),
                           constant_values=np.inf)
        scanned = np.full((B,), self.n_live, np.int32)
        return ids, dists, scanned
