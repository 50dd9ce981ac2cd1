"""Host seconds of the SQ8 set-up (``core/search.py``'s
``ensure_sq8_arrays``: the grid's fit, the encode and the upload of the
codes), inside the engine's set-up: the program's total
``engine.sq8_s``."""
from perfbench import counters


def read(record):
    return counters.total("engine.sq8_s")
