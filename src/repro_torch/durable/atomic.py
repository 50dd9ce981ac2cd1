"""The atomic-persistence recipe shared by every durable artifact.

A copy of ``repro.durable.atomic`` (the port imports nothing of the JAX
package); the content checksum is the reference's byte for byte, so a file
written by either package loads in the other.  One protocol for index
snapshots (``AnnIndex.save``), durability checkpoints and manifests: write ``{path}.tmp.{pid}``,
stamp a content checksum, flush + fsync the file, ``os.replace`` into
place, fsync the directory.  A crash at any instant leaves ``path``
holding the old version or the complete new one, never a torn file;
readers verify the checksum and raise ``CorruptIndexError`` on damage.

Failpoint plumbing: each writer names its own sites (``index.save.write``
/ ``index.save.rename`` for snapshots, ``checkpoint.write`` for
checkpoints, ``manifest.rename`` for manifests).  The data kinds (``corrupt``/``truncate``)
damage the temp file before publication, exercising the reader-side
integrity checks.
"""
from __future__ import annotations

import os
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np

from repro_torch.fault import failpoints as fault
from repro_torch.fault.errors import CorruptIndexError


def payload_checksum(payload: Dict[str, np.ndarray]) -> int:
    """CRC32 over every array's name, dtype, shape, and bytes (sorted by
    name) — deterministic across a save/load round trip, independent of the
    zip container, so it catches damage the container's own CRCs can miss
    (and torn rewrites of uncompressed entries)."""
    crc = 0
    for name in sorted(payload):
        a = np.ascontiguousarray(payload[name])
        for token in (name, str(a.dtype), str(a.shape)):
            crc = zlib.crc32(token.encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


def damage_file(path: str, kind: str) -> None:
    """Apply an armed data fault (``corrupt``/``truncate``) to a file."""
    size = os.path.getsize(path)
    if kind == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return
    with open(path, "r+b") as f:          # "corrupt": flip a byte run
        f.seek(size // 3)
        chunk = bytearray(f.read(min(64, max(size - size // 3, 1))))
        f.seek(size // 3)
        f.write(bytes(b ^ 0xFF for b in chunk))


def fsync_dir(dirname: str) -> None:
    """Make a rename/create in ``dirname`` durable (POSIX dir fsync)."""
    dfd = os.open(dirname, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def atomic_replace(tmp: str, path: str) -> None:
    """``os.replace`` + directory fsync: the publish step of the recipe."""
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_bytes(path: str, data: bytes,
                       rename_site: Optional[str] = None) -> None:
    """Atomically publish raw bytes (the manifest writer's primitive)."""
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if rename_site is not None:
            fault.hit(rename_site)
        atomic_replace(tmp, path)
    except BaseException:   # noqa: BLE001 — temp-file hygiene, re-raised
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_npz(path: str, payload: Dict[str, np.ndarray], *,
                     write_site: Optional[str] = None,
                     rename_site: Optional[str] = None) -> None:
    """Atomically publish an .npz payload, stamping its content checksum.

    ``payload`` must not already carry a ``checksum`` entry — the writer
    owns that key.  ``write_site`` fires between the bytes landing and the
    fsync (``raise`` = crash mid-save; ``corrupt``/``truncate`` = damage
    the temp file so the reader-side checks are exercised);
    ``rename_site`` fires in the write→publish window.
    """
    assert "checksum" not in payload, "checksum is stamped by the writer"
    payload = dict(payload)
    payload["checksum"] = np.asarray(payload_checksum(payload), np.uint64)
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
            action = fault.hit(write_site) if write_site else None
            f.flush()
            os.fsync(f.fileno())
        if action in ("corrupt", "truncate"):
            damage_file(tmp, action)
        if rename_site is not None:
            fault.hit(rename_site)
        atomic_replace(tmp, path)
    except BaseException:   # noqa: BLE001 — temp-file hygiene, re-raised
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """Read an .npz into a dict, converting container damage into
    ``CorruptIndexError`` (``FileNotFoundError`` passes through)."""
    try:
        with np.load(path, allow_pickle=False) as npz:
            return {k: npz[k] for k in npz.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, OSError, EOFError,
            KeyError, ValueError) as e:
        raise CorruptIndexError(
            f"{path}: unreadable file ({type(e).__name__}: {e}); "
            "the bytes on disk are truncated or corrupted") from e


def verify_checksum(path: str, z: Dict[str, np.ndarray]) -> None:
    """Verify a payload's stamped content checksum (see ``payload_checksum``);
    a file without one is corrupt."""
    if "checksum" not in z:
        raise CorruptIndexError(
            f"{path}: file is missing its content checksum")
    want = int(z["checksum"])
    got = payload_checksum({k: v for k, v in z.items() if k != "checksum"})
    if got != want:
        raise CorruptIndexError(
            f"{path}: content checksum mismatch (stored {want:#010x}, "
            f"computed {got:#010x}) — the payload was corrupted after it "
            "was written")


def read_npz_verified(path: str) -> Dict[str, np.ndarray]:
    """``read_npz`` + ``verify_checksum`` in one step (checkpoint reader)."""
    z = read_npz(path)
    verify_checksum(path, z)
    return z
