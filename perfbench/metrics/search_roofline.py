"""The search's share of the H100's memory roofline, in percent.

The least time the bytes the search needs take at the card's published
3.35 TB/s, over the device's busy time in the traced sub-window.  The
bytes come from the search's counters and the configuration's widths,
never from which kernels ran, so a later fusion or split of kernels does
not make the count stale:

    dist_calls * d * 4      fp32 rows of every exact distance (the stage-2
                            reranks are among the dist_calls)
  + sq8_calls * d           code rows of every stage-1 estimate
  + hops * M * 8            an expanded node's neighbour ids and edge
                            lengths (int32 and fp32)
  + queries * (d * 4 + k * 8)   the queries in, the ids and distances out
"""
from perfbench.peaks import HBM_BYTES_PER_S


def needed_bytes(t, cfg):
    d, M, k = cfg["dim"], cfg["graph"]["k"], cfg["search"]["k"]
    return (t["dist_calls"] * d * 4 + t["sq8_calls"] * d + t["hops"] * M * 8
            + t["queries"] * (d * 4 + k * 8))


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    least_s = needed_bytes(t, record["config"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / t["busy_s"]
