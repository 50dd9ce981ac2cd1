"""Per-shard deltas: mutation over a sharded corpus with staggered merges.

The counterpart of ``repro.mutate.sharded``.  ``MutableShardedAnnIndex``
is a host-side composition of one ``MutableAnnIndex`` per shard (children
run ``auto_merge="off"``; the parent owns merge policy).  It is NOT the
serve step of ``ShardedAnnIndex``: each shard is its own index on its own
device, and the top-k merge happens host-side, which is exactly what the mutation story
needs: a merge rebuilds ONE shard's graph while every other shard keeps
serving untouched, so the rebuild cost is 1/S of the corpus at a time
(staggering; DESIGN.md §9).

Routing: inserts go to the currently-least-loaded shard (by live count),
so deltas fill — and therefore merge — out of phase with each other.
External ids are allocated globally by the parent and mapped to shards
with a host dict; deletes route through it.

Failure domains (DESIGN.md §10): because the top-k composition is
host-side, a shard that fails or stalls can simply be LEFT OUT — the
batch resolves with the survivors' pool and ``SearchStats.shards_failed``
/ ``degraded`` set (partial results are data, not an exception; only when
every shard fails does ``search`` raise ``DegradedSearchError``).  With
``shard_timeout_s`` set, per-shard searches run on a thread pool and a
straggler past the deadline is dropped the same way.  Merge policy is
quarantine-aware: a shard whose merge-retry budget is exhausted sits out
(its pre-merge snapshot serves) and inserts route around it.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.index import DEFAULT_SEARCH, AnnIndex
from repro_torch.core.spec import SearchSpec, SearchStats, resolve_search_spec
from repro_torch.device import DeviceLike
from repro_torch.durable.manifest import (Manifest, read_manifest,
                                          write_manifest)
from repro_torch.durable.store import DurableStore
from repro_torch.fault import (CorruptIndexError, DegradedSearchError,
                               MergeQuarantinedError)
from repro_torch.fault import failpoints as fault
from repro_torch.mutate.delta import delta_scan_compile_count
from repro_torch.mutate.index import MutableAnnIndex, MutateConfig

_SHARD_DIR = "shard-{:d}"


class MutableShardedAnnIndex:
    """S mutable shards behind one insert/delete/search surface.

    Each shard searches on the device of the ``AnnIndex`` it wraps (or, in
    ``recover``/``load``, on ``device``).
    """

    def __init__(self, indexes: List[AnnIndex],
                 config: MutateConfig = MutateConfig(),
                 spec: Optional[SearchSpec] = None, *,
                 shard_timeout_s: Optional[float] = None,
                 durable_dir: Optional[str] = None):
        if not indexes:
            raise ValueError("need at least one shard")
        child_cfg = dataclasses.replace(config, auto_merge="off")
        self._init_common(config, spec, len(indexes), shard_timeout_s)
        for s, idx in enumerate(indexes):
            child = MutableAnnIndex(idx, config=child_cfg, spec=spec)
            # children hand out their own ids starting at their local n;
            # the parent overrides allocation so ids are globally unique
            for e in child._state.snapshot.ext_ids:
                ge = self._next_ext
                self._remap_child_ext(child, int(e), ge)
                self._ext_to_shard[ge] = s
                self._next_ext += 1
            self.shards.append(child)
        if durable_dir is not None:
            # per-shard stores attach AFTER the remap above, so the initial
            # checkpoints capture GLOBAL ids; the parent manifest lands
            # last — its existence implies every shard dir is complete
            for s, child in enumerate(self.shards):
                child._init_durable(
                    os.path.join(durable_dir, _SHARD_DIR.format(s)))
            write_manifest(durable_dir, self._parent_manifest())

    def _init_common(self, config: MutateConfig, spec: Optional[SearchSpec],
                     n_shards: int, shard_timeout_s: Optional[float]):
        """Field setup shared by ``__init__`` and ``recover``."""
        self.config = config
        self.default_spec = spec if spec is not None else DEFAULT_SEARCH
        self.shard_timeout_s = shard_timeout_s
        self.shards: List[MutableAnnIndex] = []
        self._ext_to_shard: Dict[int, int] = {}
        self._next_ext = 0
        self._merge_threads: Dict[int, threading.Thread] = {}
        # pool only when a timeout is configured: the serial path has no
        # per-search executor overhead and identical degradation semantics
        self._pool = (ThreadPoolExecutor(
            max_workers=n_shards, thread_name_prefix="shard-search")
            if shard_timeout_s is not None else None)

    def _parent_manifest(self) -> Manifest:
        """The parent binding: no checkpoint/segments of its own — the
        per-shard truth lives in ``shard-*/MANIFEST``."""
        return Manifest(checkpoint=None, segments=[],
                        meta={"kind": "mutable-sharded",
                              "n_shards": len(self.shards)})

    @staticmethod
    def _remap_child_ext(child: MutableAnnIndex, old: int, new: int):
        snap = child._state.snapshot
        row = snap.ext_to_row.pop(old)
        snap.ext_ids[row] = new
        snap.ext_to_row[new] = row

    # --- mutation ---------------------------------------------------------
    def _pick_shard(self, n_rows: int) -> int:
        """Least-loaded shard that can absorb ``n_rows`` now: a quarantined
        shard with a full delta cannot drain, so inserts route around it.
        Every shard full AND quarantined is typed backpressure."""
        order = sorted(range(len(self.shards)),
                       key=lambda i: self.shards[i].n_live)
        for s in order:
            child = self.shards[s]
            if n_rows <= child._state.delta.room or not child.quarantined:
                return s
        raise MergeQuarantinedError(
            "every shard's delta is full and its merges are quarantined; "
            "retry after a cooldown or clear_quarantine() per shard")

    def insert(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        # least-loaded (non-quarantined-full) shard keeps fill staggered
        s = self._pick_shard(vectors.shape[0])
        child = self.shards[s]
        if vectors.shape[0] > child._state.delta.room:
            try:
                # children run auto_merge="off"; drain explicitly (with the
                # child's retry budget — exhaustion quarantines the shard)
                child._merge_with_retry()
            except Exception as e:   # noqa: BLE001 — typed backpressure
                raise MergeQuarantinedError(
                    f"shard delta full and its drain merge failed "
                    f"(shard now quarantined)") from e
        ids = np.arange(self._next_ext, self._next_ext + vectors.shape[0],
                        dtype=np.int64)
        self._next_ext += vectors.shape[0]
        with child._lock:
            child._next_ext = int(ids[0])
            got = child.insert(vectors)
        assert (got == ids).all()
        for e in ids:
            self._ext_to_shard[int(e)] = s
        self.maybe_merge()
        return ids

    def delete(self, ext_ids) -> int:
        if np.ndim(ext_ids) == 0:
            ext_ids = [ext_ids]
        by_shard: Dict[int, List[int]] = {}
        for e in map(int, ext_ids):
            s = self._ext_to_shard.get(e)
            if s is None:
                raise KeyError(f"external id {e} is not live")
            by_shard.setdefault(s, []).append(e)
        removed = 0
        for s, ids in by_shard.items():
            removed += self.shards[s].delete(ids)
        self.maybe_merge()
        return removed

    def maybe_merge(self):
        """Merge AT MOST the single most-pressured, non-quarantined shard
        per call, so shard rebuilds stagger instead of stampeding.  The
        parent owns merge policy: ``sync`` merges inline (failures raise
        after the retry budget), ``background`` rebuilds on a daemon thread
        (failures quarantine the shard silently — the state is the
        record), ``off`` leaves merges to explicit calls.

        Background merges run one shard at a time: while any shard's merge
        thread is alive, a due shard waits for the next call after it
        (the reference starts a second shard's merge beside the first;
        two host graph builds beside serving would share one interpreter
        lock).  A shard whose delta fills meanwhile drains inline on
        insert, as in the reference."""
        if self.config.auto_merge == "off":
            return
        due = [s for s, sh in enumerate(self.shards)
               if sh.needs_merge() and not sh.quarantined]
        if not due:
            return
        s = max(due, key=lambda i: self.shards[i]._state.delta.count)
        sh = self.shards[s]
        if self.config.auto_merge == "sync":
            sh._merge_with_retry()
            return
        if any(t.is_alive() for t in self._merge_threads.values()):
            return

        def run():
            try:
                sh._merge_with_retry()
            # repolint: ignore[fail-open] _merge_with_retry stored the failure
            # (shard merge_error + quarantine) before raising; the wrapper
            # only keeps the daemon thread quiet
            except Exception:   # noqa: BLE001 — recorded as shard quarantine
                pass

        t = threading.Thread(target=run, name=f"shard-merge-{s}", daemon=True)
        self._merge_threads[s] = t
        t.start()

    def wait_for_merges(self):
        """Join outstanding background shard merges.  Does NOT raise:
        failures live on as per-shard quarantine + ``merge_error``."""
        for t in list(self._merge_threads.values()):
            t.join()

    def clear_quarantine(self):
        """Operator override: lift every shard's quarantine."""
        for sh in self.shards:
            sh.clear_quarantine()

    @property
    def quarantined_shards(self) -> Tuple[int, ...]:
        return tuple(s for s, sh in enumerate(self.shards) if sh.quarantined)

    # --- search -----------------------------------------------------------
    def _shard_search(self, s: int, queries: np.ndarray, spec: SearchSpec):
        fault.hit("shard.search", sub=str(s))
        return self.shards[s].search(queries, spec=spec)

    def search(self, queries: np.ndarray,
               spec: Optional[SearchSpec] = None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Fan out to every shard, host-merge the per-shard top-k.

        Graceful degradation: a shard that raises (or, with
        ``shard_timeout_s``, misses its deadline) is dropped from the
        composition — the batch resolves with the survivors' pool,
        ``stats.shards_failed`` counting the losses and ``stats.degraded``
        set.  Only when EVERY shard fails does the search raise
        (``DegradedSearchError`` chained to the first failure).
        """
        spec = resolve_search_spec(spec, self.default_spec,
                                   "MutableShardedAnnIndex.search")
        k = spec.k
        parts: List[Tuple[np.ndarray, np.ndarray, SearchStats]] = []
        failed = 0
        first_err: Optional[BaseException] = None
        if self._pool is None:
            for s in range(len(self.shards)):
                try:
                    parts.append(self._shard_search(s, queries, spec))
                except Exception as e:   # noqa: BLE001 — degrade, not fail
                    failed += 1
                    if first_err is None:
                        first_err = e
        else:
            futs = {self._pool.submit(self._shard_search, s, queries, spec): s
                    for s in range(len(self.shards))}
            done, not_done = wait(futs, timeout=self.shard_timeout_s)
            for f in futs:
                if f in done:
                    try:
                        parts.append(f.result())
                        continue
                    except Exception as e:   # noqa: BLE001 — degrade
                        err: BaseException = e
                else:
                    # straggler: abandoned (its thread finishes into the
                    # void; results are discarded), the batch moves on
                    f.cancel()
                    err = TimeoutError(
                        f"shard {futs[f]} search missed the "
                        f"{self.shard_timeout_s}s deadline")
                failed += 1
                if first_err is None:
                    first_err = err
        if not parts:
            raise DegradedSearchError(
                f"all {len(self.shards)} shards failed") from first_err
        all_ids = np.concatenate([p[0] for p in parts], axis=1)
        all_d = np.concatenate([p[1] for p in parts], axis=1)
        order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
        out_ids = np.take_along_axis(all_ids, order, axis=1)
        out_d = np.take_along_axis(all_d, order, axis=1)
        out_ids = np.where(np.isfinite(out_d), out_ids, -1)
        stats = parts[0][2] if len(parts) == 1 else SearchStats.merge(
            [p[2] for p in parts])
        if failed:
            stats = dataclasses.replace(
                stats, shards_failed=stats.shards_failed + failed,
                degraded=True)
        return out_ids, out_d, stats

    # --- accounting -------------------------------------------------------
    def compile_count(self) -> int:
        """Graph-engine first uses summed over shards, plus the
        process-wide delta-scan first uses counted ONCE (the shards share
        that ledger)."""
        return (sum(sh.engine_compile_count() for sh in self.shards)
                + delta_scan_compile_count())

    @property
    def metric(self) -> str:
        return self.shards[0].metric

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @property
    def n_live(self) -> int:
        return sum(sh.n_live for sh in self.shards)

    @property
    def epochs(self) -> Tuple[int, ...]:
        return tuple(sh.epoch for sh in self.shards)

    # --- persistence (DESIGN.md §11) --------------------------------------
    def save(self, dirname: str):
        """Export the full live state to a fresh durable directory: one
        checkpoint + empty WAL per shard under ``shard-<i>/``, bound by a
        parent ``MANIFEST``.  Unlike ``MutableAnnIndex.save`` this loses
        NOTHING — unmerged deltas and tombstones ride in the checkpoints.
        ``load`` (or ``recover``) reads it back; refuses a directory that
        already holds durable state.
        """
        self.wait_for_merges()
        for s, child in enumerate(self.shards):
            sd = os.path.join(dirname, _SHARD_DIR.format(s))
            store = DurableStore.create(
                sd, fsync=self.config.wal_fsync,
                fsync_interval_s=self.config.wal_fsync_interval_s,
                meta={"kind": "mutable-index"})
            store.publish_checkpoint(child._checkpoint_payload())
            store.close()
        write_manifest(dirname, self._parent_manifest())

    @classmethod
    def load(cls, dirname: str, config: MutateConfig = MutateConfig(),
             spec: Optional[SearchSpec] = None, *,
             shard_timeout_s: Optional[float] = None,
             device: DeviceLike = None) -> "MutableShardedAnnIndex":
        """Read a ``save``d (or crashed durable) directory WITHOUT taking
        over its log: the result mutates in memory only."""
        return cls.recover(dirname, config=config, spec=spec,
                           shard_timeout_s=shard_timeout_s, attach=False,
                           device=device)

    @classmethod
    def recover(cls, dirname: str, config: MutateConfig = MutateConfig(),
                spec: Optional[SearchSpec] = None, *,
                shard_timeout_s: Optional[float] = None,
                attach: bool = True,
                device: DeviceLike = None) -> "MutableShardedAnnIndex":
        """Rebuild every shard from ``shard-<i>/`` (checkpoint + WAL
        replay, see ``MutableAnnIndex.recover``) on ``device`` (``None``:
        the GPU) and re-derive the parent's routing state:
        ``_ext_to_shard`` from each shard's live ids and the global id
        allocator from the max of the shards' allocators.  With
        ``attach=True`` the shards keep logging into their WALs.  A
        directory the JAX package's ``MutableShardedAnnIndex`` wrote
        recovers here, and the other way round: the formats are the
        same."""
        m = read_manifest(dirname)
        n_shards = int(m.meta.get("n_shards", 0))
        if m.meta.get("kind") != "mutable-sharded" or n_shards <= 0:
            raise CorruptIndexError(
                f"{dirname}: parent manifest is not a mutable-sharded "
                f"binding (meta={m.meta!r})")
        child_cfg = dataclasses.replace(config, auto_merge="off")
        obj = cls.__new__(cls)
        obj._init_common(config, spec, n_shards, shard_timeout_s)
        for s in range(n_shards):
            child = MutableAnnIndex.recover(
                os.path.join(dirname, _SHARD_DIR.format(s)),
                config=child_cfg, spec=spec, attach=attach, device=device)
            for e in child.live_ids():
                obj._ext_to_shard[int(e)] = s
            obj._next_ext = max(obj._next_ext, child._next_ext)
            obj.shards.append(child)
        return obj

    def close(self):
        """Release every shard's WAL writer (final fsync included)."""
        for sh in self.shards:
            sh.close()
