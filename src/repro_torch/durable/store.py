"""``DurableStore``: one directory of manifest + checkpoint + WAL segments.

A copy of ``repro.durable.store``: the same file names, protocol and
checkpoint payload, so either package recovers the other's directory.

The store owns the durability *state machine* (DESIGN.md §11); the
mutation stack (``MutableAnnIndex``) owns WHAT gets logged and HOW records
replay.  Directory layout::

    dir/
      MANIFEST                  root of truth: checkpoint + segment binding
      checkpoint-00000001.npz   full-state checkpoint (v3 atomic-save recipe)
      wal-00000001.log          CRC32-framed mutation records since the ckpt

Protocol (every arrow is an atomic publish; a crash between any two leaves
a consistent binding):

1. ``create``   → empty segment S1 exists, ``{ckpt: ∅, segments: [S1]}``
2. initial ``publish_checkpoint`` → ``{ckpt: C1, segments: [S1]}``
3. mutations append to S1 (acked at their fsync-policy durability point)
4. ``rotate``   (caller holds the mutation lock, so the segment boundary
   is a mutation-order boundary) → S2 created, ``{C1, [S1, S2]}``
5. ``publish_checkpoint(state captured at the rotate boundary)``
   → ``{C2, [S2]}``; C1 + S1 are garbage, unlinked best-effort
6. recovery: load the manifest's checkpoint, replay its segments in
   order (torn tail on the final segment truncated; mid-log corruption
   raises), ``attach`` to the final segment and keep appending.

The store is also the *export* format: ``create`` + ``publish_checkpoint``
+ ``close`` writes a self-contained durable directory with an empty log
(the JAX package's ``MutableShardedAnnIndex.save``).
"""
from __future__ import annotations

import glob
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fault import failpoints as fault
from repro_torch.fault.errors import CorruptIndexError

from repro_torch.durable import wal
from repro_torch.durable.atomic import (atomic_write_npz, fsync_dir,
                                        read_npz_verified)
from repro_torch.durable.manifest import (MANIFEST_NAME, Manifest,
                                          read_manifest, write_manifest)

_SEG_FMT = "wal-{:08d}.log"
_CKPT_FMT = "checkpoint-{:08d}.npz"


def _seq_of(name: str) -> int:
    """The 8-digit sequence number embedded in a segment/checkpoint name."""
    stem = os.path.splitext(name)[0]
    return int(stem.rsplit("-", 1)[1])


def has_manifest(dirname: str) -> bool:
    """True when ``dirname`` holds durable state to ``recover`` from."""
    return os.path.exists(os.path.join(dirname, MANIFEST_NAME))


class DurableStore:
    """Manifest + checkpoint + WAL segment files under one directory."""

    def __init__(self, dirname: str, manifest: Manifest, *,
                 fsync: str = "every", fsync_interval_s: float = 0.002):
        assert fsync in wal.FSYNC_POLICIES, f"unknown fsync policy {fsync!r}"
        self.dir = os.path.abspath(dirname)
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self._manifest = manifest            # guarded by: self._lock
        self._writer: Optional[wal.SegmentWriter] = None  # guarded by: self._lock
        self._lock = threading.Lock()        # manifest + writer swaps
        self._replayed_next_lsn: Optional[int] = None

    # --- lifecycle --------------------------------------------------------
    @classmethod
    def create(cls, dirname: str, *, fsync: str = "every",
               fsync_interval_s: float = 0.002,
               meta: Optional[Dict] = None) -> "DurableStore":
        """Initialize a fresh durable directory (refuses an existing one)."""
        dirname = os.path.abspath(dirname)
        if has_manifest(dirname):
            raise ValueError(
                f"{dirname} already holds durable state; recover() from it "
                "or point at a fresh directory")
        os.makedirs(dirname, exist_ok=True)
        seg = _SEG_FMT.format(1)
        with open(os.path.join(dirname, seg), "ab") as f:
            os.fsync(f.fileno())
        fsync_dir(dirname)
        manifest = Manifest(checkpoint=None, segments=[seg], next_lsn=0,
                            meta=dict(meta or {}))
        write_manifest(dirname, manifest)
        return cls(dirname, manifest, fsync=fsync,
                   fsync_interval_s=fsync_interval_s)

    @classmethod
    def open(cls, dirname: str, *, fsync: str = "every",
             fsync_interval_s: float = 0.002) -> "DurableStore":
        """Open existing durable state (recovery entry point).  Raises
        ``FileNotFoundError`` when there is no manifest."""
        dirname = os.path.abspath(dirname)
        manifest = read_manifest(dirname)
        return cls(dirname, manifest, fsync=fsync,
                   fsync_interval_s=fsync_interval_s)

    @property
    def manifest(self) -> Manifest:
        with self._lock:
            return self._manifest

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None

    # --- mutation logging -------------------------------------------------
    def _require_writer(self) -> wal.SegmentWriter:
        with self._lock:
            w = self._writer
        if w is None:
            raise wal.WalFailedError(
                "store has no active WAL writer (not attached, or closed)")
        return w

    def append_insert(self, ext_ids: np.ndarray, vectors: np.ndarray) -> int:
        """Write-ahead one insert batch; returns its LSN (ack separately)."""
        return self._require_writer().append(wal.encode_insert,
                                             ext_ids, vectors)

    def append_delete(self, ext_ids) -> int:
        return self._require_writer().append(wal.encode_delete,
                                             np.asarray(ext_ids, np.int64))

    def ack(self, lsn: int) -> None:
        """Block until ``lsn`` is durable per the fsync policy — the
        acknowledgment point of the mutation that logged it."""
        self._require_writer().wait_durable(lsn)

    @property
    def next_lsn(self) -> int:
        with self._lock:
            w = self._writer
            manifest = self._manifest
        return w.next_lsn if w is not None else manifest.next_lsn

    # --- checkpoint protocol ----------------------------------------------
    def rotate(self) -> None:
        """Seal the active segment and open its successor (the caller MUST
        hold the mutation lock: the segment boundary is a mutation-order
        boundary).  The new segment joins the manifest BEFORE any mutation
        is acked into it."""
        fault.hit("wal.rotate")
        with self._lock:
            writer = self._writer
            if writer is None:
                raise wal.WalFailedError(
                    "store has no active WAL writer (not attached, or "
                    "closed)")
            next_lsn = writer.next_lsn
            writer.close(do_fsync=True)   # no torn tail behind a successor
            self._writer = None
            seq = _seq_of(self._manifest.segments[-1]) + 1
            seg = _SEG_FMT.format(seq)
            with open(self.path(seg), "ab") as f:
                os.fsync(f.fileno())
            fsync_dir(self.dir)
            manifest = Manifest(
                checkpoint=self._manifest.checkpoint,
                segments=list(self._manifest.segments) + [seg],
                next_lsn=next_lsn, meta=self._manifest.meta)
            write_manifest(self.dir, manifest)
            self._manifest = manifest
            self._writer = wal.SegmentWriter(
                self.path(seg), fsync=self.fsync,
                interval_s=self.fsync_interval_s, next_lsn=next_lsn)

    def publish_checkpoint(self, payload: Dict[str, np.ndarray]) -> str:
        """Write a full-state checkpoint and swap the manifest to it.

        ``payload`` must be the state captured at the LAST ``rotate``
        boundary (or creation, for the initial checkpoint): after the
        swap, only the active segment remains bound, and every superseded
        checkpoint/segment file is unlinked best-effort.  Returns the
        checkpoint file name.
        """
        with self._lock:
            old = self._manifest
            seq = (_seq_of(old.checkpoint) + 1 if old.checkpoint is not None
                   else 1)
            name = _CKPT_FMT.format(seq)
            atomic_write_npz(self.path(name), payload,
                             write_site="checkpoint.write")
            w = self._writer
            manifest = Manifest(
                checkpoint=name, segments=[old.segments[-1]],
                next_lsn=w.next_lsn if w is not None else old.next_lsn,
                meta=old.meta)
            write_manifest(self.dir, manifest)
            self._manifest = manifest
        self.prune()
        return name

    def prune(self) -> None:
        """Unlink files the manifest no longer references (best-effort —
        a crash leaves garbage, never inconsistency; re-pruned next time)."""
        with self._lock:
            keep = set(self._manifest.segments)
            if self._manifest.checkpoint is not None:
                keep.add(self._manifest.checkpoint)
        for pat in ("wal-*.log", "checkpoint-*.npz", "*.tmp.*"):
            for p in glob.glob(self.path(pat)):
                if os.path.basename(p) in keep:
                    continue
                try:
                    os.unlink(p)
                except OSError:
                    pass

    # --- recovery ---------------------------------------------------------
    def load_checkpoint(self) -> Dict[str, np.ndarray]:
        """Read + verify the manifest's checkpoint payload."""
        name = self.manifest.checkpoint
        if name is None:
            raise CorruptIndexError(
                f"{self.dir}: manifest has no checkpoint — creation "
                "crashed before initialization completed; rebuild the "
                "index instead of recovering")
        return read_npz_verified(self.path(name))

    def replay(self) -> List[wal.WalRecord]:
        """Read every bound segment in order, applying the recovery rules.

        A torn tail on the FINAL segment is truncated away on disk (the
        records behind it were never acked); mid-log corruption raises
        ``CorruptIndexError``.  LSNs must be strictly increasing across
        the whole replay.  Idempotence is the APPLIER's job — after a
        crash between a checkpoint's rotate and publish, the replay
        legitimately overlaps state the caller already holds.
        """
        records: List[wal.WalRecord] = []
        segments = self.manifest.segments
        for i, seg in enumerate(segments):
            path = self.path(seg)
            final = i == len(segments) - 1
            recs, valid_len, torn = wal.read_segment(path, final=final)
            if torn:
                with open(path, "r+b") as f:
                    f.truncate(valid_len)
                    os.fsync(f.fileno())
            records.extend(recs)
        last = -1
        for r in records:
            if r.lsn <= last:
                raise CorruptIndexError(
                    f"{self.dir}: WAL replay out of order (lsn {r.lsn} "
                    f"after {last}) — segment files were tampered with")
            last = r.lsn
        self._replayed_next_lsn = max(last + 1, self.manifest.next_lsn)
        return records

    def attach(self) -> None:
        """Open the active (final) segment for appending — recovery's last
        step, after ``replay`` has truncated any torn tail.  Also prunes
        files orphaned by a crash mid-protocol."""
        with self._lock:
            assert self._writer is None, "already attached"
            next_lsn = (self._replayed_next_lsn
                        if self._replayed_next_lsn is not None
                        else self._manifest.next_lsn)
            self._writer = wal.SegmentWriter(
                self.path(self._manifest.segments[-1]), fsync=self.fsync,
                interval_s=self.fsync_interval_s, next_lsn=next_lsn)
        self.prune()
