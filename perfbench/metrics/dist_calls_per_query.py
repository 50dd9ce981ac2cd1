"""Exact distance calls a query (``SearchStats.dist_calls``: the entry's,
the hop loop's and, on the SQ8 path, the stage-2 reranks), over every
query of the window."""


def read(record):
    w = record["window"]
    return w["dist_calls"] / w["queries"] if w["queries"] else None
