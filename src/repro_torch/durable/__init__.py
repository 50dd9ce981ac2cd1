"""Durable mutations (DESIGN.md §11): write-ahead log + checkpoint/recovery.

The counterpart of ``repro.durable``, with the same on-disk formats (WAL
frames, manifest JSON, checkpoint .npz), so either package recovers the
other's directory::

    from repro_torch import durable

    store = durable.DurableStore.create(dir, fsync="every")
    lsn = store.append_insert(ids, vectors)   # write-ahead
    store.ack(lsn)                            # durability point = ack point

    store = durable.DurableStore.open(dir)    # recovery
    state = store.load_checkpoint()
    for rec in store.replay():                # torn tail truncated,
        ...                                   # mid-log damage raises
    store.attach()                            # keep appending

The high-level entry points live on the mutation stack:
``MutableAnnIndex(..., durable_dir=...)`` / ``MutableAnnIndex.recover`` /
``.checkpoint()``.  ``AnnIndex.save``/``load`` use ``atomic`` alone.
"""
from repro_torch.durable.atomic import (atomic_write_bytes, atomic_write_npz,
                                        damage_file, fsync_dir,
                                        payload_checksum, read_npz,
                                        read_npz_verified, verify_checksum)
from repro_torch.durable.manifest import (MANIFEST_NAME, Manifest,
                                          read_manifest, write_manifest)
from repro_torch.durable.store import DurableStore, has_manifest
from repro_torch.durable.wal import (FSYNC_POLICIES, DeleteRecord,
                                     InsertRecord, SegmentWriter,
                                     WalFailedError, read_segment)

__all__ = [
    "atomic_write_bytes", "atomic_write_npz", "damage_file", "fsync_dir",
    "payload_checksum", "read_npz", "read_npz_verified", "verify_checksum",
    "MANIFEST_NAME", "Manifest", "read_manifest", "write_manifest",
    "DurableStore", "has_manifest",
    "FSYNC_POLICIES", "DeleteRecord", "InsertRecord", "SegmentWriter",
    "WalFailedError", "read_segment",
]
