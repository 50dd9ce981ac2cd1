"""Device kernels launched a hop-loop iteration: the kernels in the traced
sub-window (copies and fills left out) over its batches' iterations."""


def read(record):
    t = record["trace"]
    if not t or not t["iters"] or not t["kernels"]:
        return None
    return t["kernels"] / t["iters"]
