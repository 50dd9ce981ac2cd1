"""Hop-loop iterations a batch (``SearchStats.iters``), mean over the
window's calls of the search."""


def read(record):
    iters = record["window"]["iters"]
    return sum(iters) / len(iters) if iters else None
