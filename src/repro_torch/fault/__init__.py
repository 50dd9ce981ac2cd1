"""Failure domains: failpoints, retry policy, typed degradation errors.

    from repro_torch import fault

    fault.arm("serve.dispatch", kind="raise", hits={3})
    fault.disarm()                       # everything off; hit() is free
    with fault.scoped({"wal.fsync": fault.FaultSpec(hits={0})}):
        ...

    policy = fault.RetryPolicy(max_attempts=6, base_s=0.01, cap_s=0.5)
    fut = policy.call(frontend.submit, queries, retry_on=QueueFull)
"""
from repro_torch.fault.errors import (CorruptIndexError, DegradedSearchError,
                                      MergeQuarantinedError)
from repro_torch.fault.failpoints import (FaultInjected, FaultSpec, arm,
                                          disarm, fires, hit, scoped)
from repro_torch.fault.retry import RetryPolicy

__all__ = [
    "FaultInjected", "FaultSpec", "arm", "disarm", "fires", "hit",
    "scoped",
    "RetryPolicy",
    "CorruptIndexError", "DegradedSearchError", "MergeQuarantinedError",
]
