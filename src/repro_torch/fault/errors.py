"""Typed failure-domain errors.

Copies of ``repro.fault.errors`` (the port imports nothing of the JAX
package).  Every degradation path resolves to one of these instead of an
opaque ``RuntimeError``, so callers (and the crash sweeps) can tell an
injected or operational fault from a programming bug:

* ``CorruptIndexError`` — a persisted index file, checkpoint, manifest or
  WAL segment failed its integrity checks (truncation, bit flips, a stale
  checksum, mid-log corruption).  An interrupted ``save()`` can never
  produce one at the *published* path — the atomic-rename protocol leaves
  the old version — so seeing this means the bytes on disk were damaged
  after publication.
* ``DegradedSearchError`` — every shard of a host-composed sharded search
  failed; there is no surviving pool to answer from
  (``MutableShardedAnnIndex.search``).
* ``MergeQuarantinedError`` — the delta segment is full while background
  merges are quarantined (the retry budget was exhausted); the mutation is
  refused as typed backpressure rather than risking a poisoned index.
  Retry after the quarantine cooldown, or call ``clear_quarantine()``.
"""
from __future__ import annotations


class CorruptIndexError(RuntimeError):
    """A persisted index failed checksum/structure verification on load."""


class DegradedSearchError(RuntimeError):
    """No shard survived a fan-out search — nothing to degrade onto."""


class MergeQuarantinedError(RuntimeError):
    """Delta full while merges are quarantined: typed mutation backpressure."""
