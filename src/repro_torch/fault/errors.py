"""Typed failure-domain errors.

A copy of ``repro.fault.errors``' ``CorruptIndexError`` (the port imports
nothing of the JAX package): ``AnnIndex.load`` raises it when a persisted
index fails its integrity checks (truncation, bit flips, a stale
checksum).  An interrupted ``save()`` can never produce one at the
*published* path, because the atomic-rename protocol leaves the old
version, so seeing this means the bytes on disk were damaged after
publication.
"""
from __future__ import annotations


class CorruptIndexError(RuntimeError):
    """A persisted index failed checksum/structure verification on load."""
