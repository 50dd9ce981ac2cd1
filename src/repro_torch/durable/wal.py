"""Append-only, CRC32-framed write-ahead log segments (DESIGN.md §11).

A copy of ``repro.durable.wal`` (the port imports nothing of the JAX
package).  The frame and record layout is the reference's byte for byte,
so either package replays the other's segments.

Framing: every record is ``[u32 len][u32 crc32(payload)] payload``; the
payload starts ``[u8 type][u64 lsn]`` followed by the record body
(little-endian throughout).  LSNs are globally monotonic across segments,
so replay can assert ordering.

Reading (``read_segment``) applies the recovery rules the mutation stack
relies on:

* a *torn tail* — an incomplete header, a payload running past EOF, or a
  CRC-failed frame that is the LAST thing in the file (a torn in-place
  write) — is tolerated: the segment is valid up to the bad frame, which
  a recovery truncates away.  Only acked-after-fsync records matter, and a
  torn tail can only hold records whose ack never returned;
* a bad frame with MORE bytes after it is *mid-log corruption*: acked
  records may be damaged, so the reader raises ``CorruptIndexError``
  instead of silently dropping them.  Rotation fsyncs a segment before
  opening its successor, so a torn tail in a non-final segment is also
  corruption, never an artifact of a crash.

Writing (``SegmentWriter``) separates the *append* (buffered write under
the writer lock, WAL ordering = apply ordering) from the *ack*
(``wait_durable``): the durability point depends on the fsync policy —

* ``every``    — every ack fsyncs (group-committed: one fsync covers every
  append that landed before it, so concurrent writers batch for free);
* ``interval`` — group commit with an accumulation window: the leader ack
  sleeps ``interval_s`` before its fsync so a burst of concurrent writers
  rides one fsync (PostgreSQL's ``commit_delay``); acks still BLOCK until
  the covering fsync returns, so acknowledged-means-durable holds;
* ``off``      — acks return immediately; durability is best-effort (the
  OS flushes eventually).  For benchmarks and bulk loads only.

A durability failure (an fsync that raised — in production a dying disk,
in the chaos suite the ``wal.fsync`` failpoint) poisons the writer: the
in-memory index may be ahead of the log, so every later append/ack raises
``WalFailedError`` instead of silently diverging.  The process should
recover from disk.

Failpoint sites: ``wal.append`` (``raise`` = crash before the frame is
written; ``truncate`` = a torn write — half a frame lands, then the
"process" dies; ``corrupt`` = the frame's bytes are damaged in place but
appends continue, manufacturing mid-log corruption) and ``wal.fsync``
(crash between write and durability point).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np

from repro_torch.fault import failpoints as fault
from repro_torch.fault.errors import CorruptIndexError

FSYNC_POLICIES = ("every", "interval", "off")

_HEADER = struct.Struct("<II")           # frame: len, crc32(payload)
_REC_HEAD = struct.Struct("<BQ")         # payload: type, lsn
_INSERT_HEAD = struct.Struct("<II")      # n rows, dim
_DELETE_HEAD = struct.Struct("<I")       # n ids

REC_INSERT = 1
REC_DELETE = 2

# a frame longer than this is treated as a bad length field, not a request
# to allocate gigabytes (the largest legal record is a delta-capacity
# insert batch: capacity * (8 + 4 * dim) bytes, far below this)
MAX_FRAME_BYTES = 1 << 30


class WalFailedError(RuntimeError):
    """The WAL hit a durability failure earlier; the in-memory index may be
    ahead of the log.  Recover from disk instead of appending further."""


@dataclasses.dataclass(frozen=True)
class InsertRecord:
    lsn: int
    ext_ids: np.ndarray      # [n] int64
    vectors: np.ndarray      # [n, d] f32 (already preprocessed)


@dataclasses.dataclass(frozen=True)
class DeleteRecord:
    lsn: int
    ext_ids: np.ndarray      # [n] int64


WalRecord = Union[InsertRecord, DeleteRecord]


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------
def encode_insert(lsn: int, ext_ids: np.ndarray, vectors: np.ndarray) -> bytes:
    ids = np.ascontiguousarray(ext_ids, np.int64)
    vec = np.ascontiguousarray(vectors, np.float32)
    assert ids.ndim == 1 and vec.ndim == 2 and ids.shape[0] == vec.shape[0]
    return (_REC_HEAD.pack(REC_INSERT, lsn)
            + _INSERT_HEAD.pack(ids.shape[0], vec.shape[1])
            + ids.tobytes() + vec.tobytes())


def encode_delete(lsn: int, ext_ids) -> bytes:
    ids = np.ascontiguousarray(ext_ids, np.int64)
    assert ids.ndim == 1
    return (_REC_HEAD.pack(REC_DELETE, lsn)
            + _DELETE_HEAD.pack(ids.shape[0]) + ids.tobytes())


def frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def decode_record(payload: bytes, path: str, offset: int) -> WalRecord:
    """Decode one CRC-verified payload; malformed bodies are corruption
    (the CRC passed, so the bytes are what the writer wrote — a decode
    failure means a broken writer or damage the CRC happened to miss)."""
    try:
        rtype, lsn = _REC_HEAD.unpack_from(payload, 0)
        off = _REC_HEAD.size
        if rtype == REC_INSERT:
            n, d = _INSERT_HEAD.unpack_from(payload, off)
            off += _INSERT_HEAD.size
            ids = np.frombuffer(payload, np.int64, n, off)
            off += 8 * n
            vec = np.frombuffer(payload, np.float32, n * d, off
                                ).reshape(n, d)
            if off + 4 * n * d != len(payload):
                raise ValueError("trailing bytes in insert record")
            return InsertRecord(lsn=lsn, ext_ids=ids.copy(),
                                vectors=vec.copy())
        if rtype == REC_DELETE:
            (n,) = _DELETE_HEAD.unpack_from(payload, off)
            off += _DELETE_HEAD.size
            ids = np.frombuffer(payload, np.int64, n, off)
            if off + 8 * n != len(payload):
                raise ValueError("trailing bytes in delete record")
            return DeleteRecord(lsn=lsn, ext_ids=ids.copy())
        raise ValueError(f"unknown record type {rtype}")
    except (struct.error, ValueError) as e:
        raise CorruptIndexError(
            f"{path}: undecodable WAL record at offset {offset} "
            f"({e})") from e


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------
def read_segment(path: str, *, final: bool
                 ) -> Tuple[List[WalRecord], int, bool]:
    """Scan one segment; returns ``(records, valid_len, torn)``.

    ``final`` marks the manifest's LAST segment — the only place a torn
    tail is legal.  ``valid_len`` is the byte offset of the first bad
    frame (== file size when the segment is clean); a recovery truncates
    the file there before appending continues.  Mid-log corruption — a bad
    frame with valid bytes after it, or ANY bad frame in a non-final
    segment — raises ``CorruptIndexError``.
    """
    with open(path, "rb") as f:
        data = f.read()
    size = len(data)
    records: List[WalRecord] = []
    off = 0

    def tail_or_raise(why: str) -> Tuple[List[WalRecord], int, bool]:
        if final:
            return records, off, True
        raise CorruptIndexError(
            f"{path}: {why} at offset {off} in a non-final WAL segment — "
            "mid-log corruption, not a torn tail (rotation fsyncs a "
            "segment before opening its successor)")

    while off < size:
        if size - off < _HEADER.size:
            return tail_or_raise("incomplete frame header")
        length, crc = _HEADER.unpack_from(data, off)
        if length > MAX_FRAME_BYTES:
            return tail_or_raise(f"implausible frame length {length}")
        lo, hi = off + _HEADER.size, off + _HEADER.size + length
        if hi > size:
            return tail_or_raise("frame payload runs past EOF")
        payload = data[lo:hi]
        if zlib.crc32(payload) != crc:
            if hi == size:
                # CRC-failed FINAL frame: a torn in-place write
                return tail_or_raise("CRC mismatch on the final frame")
            raise CorruptIndexError(
                f"{path}: WAL frame CRC mismatch at offset {off} with "
                f"{size - hi} valid bytes after it — mid-log corruption "
                "(acked records may be damaged); refusing to replay")
        records.append(decode_record(payload, path, off))
        off = hi
    return records, off, False


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------
class SegmentWriter:
    """Append/ack on ONE open segment file (see the module docstring)."""

    def __init__(self, path: str, *, fsync: str = "every",
                 interval_s: float = 0.002, next_lsn: int = 0):
        assert fsync in FSYNC_POLICIES, f"unknown fsync policy {fsync!r}"
        self.path = path
        self.fsync = fsync
        self.interval_s = float(interval_s)
        self._f: Optional[BinaryIO] = open(path, "ab")
        self._write_lock = threading.Lock()
        self._cond = threading.Condition()
        self._next_lsn = next_lsn                # guarded by: self._write_lock
        self._synced_lsn = next_lsn - 1          # guarded by: self._cond
        self._sync_in_progress = False           # guarded by: self._cond
        # poison marker; read on BOTH lock paths (append under _write_lock,
        # wait_durable under _cond) so it carries no single-lock annotation:
        # a stale read only delays the WalFailedError by one call
        self._failed: Optional[BaseException] = None

    # -- append -----------------------------------------------------------
    def append(self, encode, *args) -> int:
        """Write one framed record; returns its LSN.  ``encode`` is
        ``encode_insert``/``encode_delete`` (called with the assigned LSN
        first).  The write is buffered — durability comes from
        ``wait_durable``."""
        with self._write_lock:
            self._check_alive()
            lsn = self._next_lsn
            buf = frame(encode(lsn, *args))
            action = fault.hit("wal.append")
            if action == "truncate":
                # a torn write: half the frame lands, then the "process"
                # dies.  The writer is poisoned like any crash site.
                self._f.write(buf[:max(len(buf) // 2, 1)])
                self._f.flush()
                err = fault.FaultInjected("wal.append[torn-write]", -1)
                self._failed = err
                raise err
            if action == "corrupt":
                # damaged frame, appends continue: manufactures MID-log
                # corruption once later records land after it
                bad = bytearray(buf)
                bad[_HEADER.size] ^= 0xFF
                buf = bytes(bad)
            self._f.write(buf)
            self._next_lsn = lsn + 1
            return lsn

    def _check_alive(self):
        if self._failed is not None:
            raise WalFailedError(
                "WAL poisoned by an earlier durability failure; recover "
                "from disk") from self._failed
        if self._f is None:
            raise WalFailedError("WAL segment is closed")

    # -- durability point --------------------------------------------------
    def wait_durable(self, lsn: int) -> None:
        """Block until ``lsn`` is covered by an fsync (the ack point).

        Group commit: the first waiter becomes the leader and fsyncs once
        for every append that landed so far; the rest just wait for
        coverage.  ``off`` policy: returns immediately.
        """
        if self.fsync == "off":
            return
        while True:
            with self._cond:
                if self._failed is not None:
                    raise WalFailedError(
                        "WAL poisoned by an earlier durability failure"
                    ) from self._failed
                if self._synced_lsn >= lsn:
                    return
                if not self._sync_in_progress:
                    self._sync_in_progress = True
                    break
                self._cond.wait(0.5)
        try:
            if self.fsync == "interval" and self.interval_s > 0:
                time.sleep(self.interval_s)   # group-accumulation window
            self.sync()
        except BaseException as e:   # noqa: BLE001 — poison + wake waiters
            with self._cond:
                if self._failed is None:
                    self._failed = e
                self._sync_in_progress = False
                self._cond.notify_all()
            raise
        with self._cond:
            self._sync_in_progress = False
            self._cond.notify_all()

    def sync(self) -> None:
        """Flush + fsync everything appended so far (one leader commit)."""
        with self._write_lock:
            self._check_alive()
            target = self._next_lsn - 1
            self._f.flush()
            fault.hit("wal.fsync")
            os.fsync(self._f.fileno())
        with self._cond:
            self._synced_lsn = max(self._synced_lsn, target)

    # -- lifecycle ---------------------------------------------------------
    @property
    def next_lsn(self) -> int:
        with self._write_lock:
            return self._next_lsn

    def close(self, *, do_fsync: bool = True) -> None:
        """Flush (+fsync) and close.  Rotation closes the old segment with
        ``do_fsync=True`` so a torn tail can never appear behind a
        successor segment."""
        with self._cond:
            while self._sync_in_progress:
                self._cond.wait(0.5)
        with self._write_lock:
            if self._f is None:
                return
            if self._failed is None and do_fsync:
                self._f.flush()
                os.fsync(self._f.fileno())
                with self._cond:
                    self._synced_lsn = self._next_lsn - 1
            self._f.close()
            self._f = None
        with self._cond:
            self._cond.notify_all()
