"""Seconds of ``AnnIndex.build`` (the K-NN graph: ``core/knn_graph.py``,
``core/index.py``), by the harness's clock, synchronised."""


def read(record):
    return record["spans"].get("build")
