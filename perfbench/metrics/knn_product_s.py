"""Device seconds of the K-NN build's distance products
(``core/knn_graph.py``, ``met.pairwise`` of each block of rows): the
program's total ``knn.product_s``, timed by CUDA events."""
from perfbench import counters


def read(record):
    return counters.total("knn.product_s")
