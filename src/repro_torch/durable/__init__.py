"""Crash-safe persistence of the index file (``AnnIndex.save``/``load``)."""
