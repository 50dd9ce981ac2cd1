"""The durability manifest: one small JSON binding checkpoint + WAL state.

A copy of ``repro.durable.manifest``: the same JSON body and CRC stamp, so
either package reads the other's manifest.

``MANIFEST`` is the root of truth of a durable directory: which checkpoint
file (if any) holds the base state, and which WAL segments — in replay
order — hold the mutations since its boundary.  It is rewritten with the
same temp + fsync + atomic-rename recipe as every other durable artifact
(``repro_torch.durable.atomic``), so readers always see a complete, internally
consistent binding; the state machine (DESIGN.md §11) only ever moves it
between consistent bindings:

* rotation APPENDS the fresh segment before any mutation is acked into it
  (``{ckpt: C, segments: [S1, S2]}``) — a crash before the checkpoint
  publishes replays S1+S2 onto C, exactly the acked history;
* a checkpoint publish REPLACES the binding (``{ckpt: C', segments:
  [S2]}``) only after C' (which covers everything through S1) is durable —
  then the superseded files are garbage and unlinked best-effort.

A ``crc`` stamp over the canonical body catches manifest bit rot
(``CorruptIndexError``), distinct from a future ``format`` (ValueError —
an incompatibility, not damage).  The parent of a sharded deployment
writes the same manifest shape with ``meta.n_shards`` and no segments; the
per-shard truth lives in ``shard-*/MANIFEST``.

Failpoint site: ``manifest.rename`` (crash in the write→publish window —
the previous manifest keeps ruling, which is exactly the recovery
contract).
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, List, Optional

from repro_torch.fault.errors import CorruptIndexError

from repro_torch.durable.atomic import atomic_write_bytes

MANIFEST_NAME = "MANIFEST"
MANIFEST_FORMAT = 1


@dataclasses.dataclass(frozen=True)
class Manifest:
    """One consistent (checkpoint, active-segments) binding."""

    checkpoint: Optional[str]       # file name within the dir, or None
    segments: List[str]             # WAL segment file names, replay order
    next_lsn: int = 0               # first unassigned LSN at last write
    meta: Dict = dataclasses.field(default_factory=dict)
    format: int = MANIFEST_FORMAT

    def body(self) -> Dict:
        return {"format": self.format, "checkpoint": self.checkpoint,
                "segments": list(self.segments), "next_lsn": self.next_lsn,
                "meta": dict(self.meta)}


def _canonical(body: Dict) -> bytes:
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def write_manifest(dirname: str, manifest: Manifest) -> None:
    """Atomically publish the manifest (site ``manifest.rename``)."""
    body = manifest.body()
    doc = dict(body, crc=zlib.crc32(_canonical(body)))
    atomic_write_bytes(os.path.join(dirname, MANIFEST_NAME),
                       json.dumps(doc, sort_keys=True, indent=1).encode(),
                       rename_site="manifest.rename")


def read_manifest(dirname: str) -> Manifest:
    """Read + verify the manifest.  Damage raises ``CorruptIndexError``;
    a future ``format`` raises ``ValueError``; a missing file raises
    ``FileNotFoundError`` (no durable state here at all)."""
    path = os.path.join(dirname, MANIFEST_NAME)
    with open(path, "rb") as f:
        raw = f.read()
    try:
        doc = json.loads(raw)
        crc = doc.pop("crc")
        body = {"format": doc["format"], "checkpoint": doc["checkpoint"],
                "segments": list(doc["segments"]),
                "next_lsn": int(doc["next_lsn"]), "meta": dict(doc["meta"])}
    except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        raise CorruptIndexError(
            f"{path}: unreadable manifest ({type(e).__name__}: {e})") from e
    if zlib.crc32(_canonical(body)) != crc:
        raise CorruptIndexError(
            f"{path}: manifest CRC mismatch — the file was damaged after "
            "it was written")
    if body["format"] > MANIFEST_FORMAT:
        raise ValueError(
            f"{path}: manifest format={body['format']} is newer than this "
            f"build understands (max {MANIFEST_FORMAT})")
    return Manifest(checkpoint=body["checkpoint"], segments=body["segments"],
                    next_lsn=body["next_lsn"], meta=body["meta"],
                    format=body["format"])
