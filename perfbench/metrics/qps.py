"""Queries completed in the window over the window's seconds (host clock;
the window ends with its last batch)."""


def read(record):
    w = record["window"]
    return w["queries"] / w["seconds"]
