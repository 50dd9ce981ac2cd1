"""Serving frontend: bucketed dynamic batching over the port's engines.

The counterpart of ``repro.serve``::

    from repro_torch.serve import ServeFrontend

    fe = ServeFrontend(index, SearchSpec(efs=64, router="crouting"))
    fut = fe.submit(queries)          # any [n<=top_bucket, d] batch
    fe.flush()                        # or fe.start() for the worker thread
    ids, dists, stats = fut.result()
    print(fe.telemetry.summary())     # p50/p95/p99, QPS, per-bucket first uses

See DESIGN.md §6 (serving frontend) and the README "Serving" section.
"""
from repro_torch.serve.backends import (MutableIndexSession,
                                        MutableShardedIndexSession,
                                        ShardedIndexSession,
                                        SingleIndexSession, make_session)
from repro_torch.serve.bucketing import (DEFAULT_BUCKETS, bucket_for,
                                         pad_to_bucket, validate_buckets)
from repro_torch.serve.frontend import (DeadlineExceeded, FrontendStopped,
                                        QueueFull, RequestRejected,
                                        ServeFrontend, WorkerFailure)
from repro_torch.serve.telemetry import BucketStats, ServeTelemetry

__all__ = [
    "ServeFrontend", "ServeTelemetry", "BucketStats",
    "RequestRejected", "QueueFull", "DeadlineExceeded", "WorkerFailure",
    "FrontendStopped",
    "DEFAULT_BUCKETS", "bucket_for", "pad_to_bucket", "validate_buckets",
    "SingleIndexSession", "ShardedIndexSession", "MutableIndexSession",
    "MutableShardedIndexSession", "make_session",
]
