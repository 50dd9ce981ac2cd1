"""Failpoints and the typed error of index persistence.

    from repro_torch import fault

    fault.arm("index.save.rename", kind="raise")
    fault.disarm()                       # everything off; hit() is free
"""
from repro_torch.fault.errors import CorruptIndexError
from repro_torch.fault.failpoints import (FaultInjected, FaultSpec, arm,
                                          disarm, fires, hit, scoped)

__all__ = [
    "FaultInjected", "FaultSpec", "arm", "disarm", "fires", "hit",
    "scoped", "CorruptIndexError",
]
