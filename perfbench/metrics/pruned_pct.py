"""Share of the hop loop's distance evaluations that the CRouting prune
skipped, in percent: the lanes the router pruned over those and the lanes
that took a first-stage distance (the exact fp32 distance, or SQ8's stage
1 on the two-stage path), over every search of the run, the warm-up's
included: the program's totals ``search.pruned`` and
``search.first_stage`` (``repro_torch.trace``, added by ``search_on``).
The paper's headline number; a program without those totals gives
nothing to read."""
from perfbench import counters


def read(record):
    pruned = counters.total("search.pruned")
    first = counters.total("search.first_stage")
    if pruned is None or first is None or pruned + first <= 0:
        return None
    return 100.0 * pruned / (pruned + first)
