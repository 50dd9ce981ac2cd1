"""Live index mutation (DESIGN.md §9): delta segment + tombstones +
background merge, served without downtime.  Merge failures retry with
backoff and quarantine on exhaustion — see ``repro_torch.fault`` for the
policy pieces.  The counterpart of ``repro.mutate``."""
from repro_torch.fault import MergeQuarantinedError
from repro_torch.mutate.delta import DeltaSegment, delta_scan_compile_count
from repro_torch.mutate.index import (GRAPH_DEFAULTS, MutableAnnIndex,
                                      MutateConfig)
from repro_torch.mutate.sharded import MutableShardedAnnIndex

__all__ = [
    "DeltaSegment",
    "delta_scan_compile_count",
    "GRAPH_DEFAULTS",
    "MergeQuarantinedError",
    "MutableAnnIndex",
    "MutableShardedAnnIndex",
    "MutateConfig",
]
