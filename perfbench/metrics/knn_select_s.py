"""Device seconds of the K-NN build's selection (``core/knn_graph.py``:
each block's ``topk``, two stable sorts, the self drop and the gathers):
the program's total ``knn.select_s``, timed by CUDA events."""
from perfbench import counters


def read(record):
    return counters.total("knn.select_s")
