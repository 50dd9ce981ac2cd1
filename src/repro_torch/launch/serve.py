"""ANNS serving launcher: a CRouting index sharded over the local cards
behind the bucketed serving frontend (DESIGN.md §6).  The counterpart of
``repro.launch.serve``, on the GPU unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-base 20000 --requests 200

Replays a seeded ragged request trace (sizes drawn log-uniform up to the
top bucket) through ``repro_torch.serve.ServeFrontend`` with the background
worker running, then prints the telemetry digest: recall, p50/p95/p99
latency, QPS, and per-bucket compile counts (first-use events) — none may
land on the request path (every bucket is warmed at startup).  By default
the index is sharded, one shard a visible card (one shard on one H100);
``--single`` serves one global ``AnnIndex`` instead.  ``--autotune
--slo-p99-ms 250`` attaches the SLO-driven controller (DESIGN.md §12): the
held-out queries + exact ground truth become the recall-proxy probe set
(so any backend works), the knob space is screened at startup, and the
controller keeps re-deciding on a background thread while the trace
replays, printing its structured decision log at the end.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.index import AnnIndex
from repro_torch.core.sharded_index import ShardedAnnIndex, shard_dataset
from repro_torch.core.spec import SearchSpec
from repro_torch.data.vectors import (exact_ground_truth, make_dataset,
                                      recall_at_k)
from repro_torch.device import resolve_device
from repro_torch.fault import RetryPolicy
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve import QueueFull, ServeFrontend


def ragged_sizes(n_requests: int, top: int, seed: int) -> np.ndarray:
    """Log-uniform request sizes in [1, top] — mostly small, some full."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(0, np.log(top + 1), n_requests)).astype(int)
    return np.clip(sizes, 1, top)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-base", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--graph", default="hnsw", choices=["hnsw", "nsg"])
    ap.add_argument("--router", default="crouting")
    ap.add_argument("--efs", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--buckets", default="1,8,32,128",
                    help="comma-separated bucket ladder")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request admission deadline (s)")
    ap.add_argument("--single", action="store_true",
                    help="serve one AnnIndex instead of sharding per card")
    ap.add_argument("--autotune", action="store_true",
                    help="attach the SLO-driven controller (DESIGN.md §12): "
                         "screen the knob space at startup, then re-decide "
                         "on a background thread while the trace replays")
    ap.add_argument("--slo-p99-ms", type=float, default=250.0,
                    help="p99 latency SLO the autotune controller enforces")
    ap.add_argument("--durable-dir", default=None,
                    help="serve a durable MutableAnnIndex (DESIGN.md §11): "
                         "recover from DIR when it already holds state, "
                         "else build fresh and start write-ahead logging "
                         "there (recall is meaningful only when the build "
                         "args match the logged corpus)")
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--efc", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a card the "
                         "default raises")
    args = ap.parse_args(argv)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"devices: {n_dev}")
    sizes = ragged_sizes(args.requests, buckets[-1], seed=1)
    ds = make_dataset(n_base=args.n_base, n_query=int(sizes.sum()),
                      dim=args.dim, seed=0)
    spec = SearchSpec(efs=args.efs, k=args.k, router=args.router,
                      max_hops=2048)

    t0 = time.time()
    if args.durable_dir is not None:
        from repro_torch.durable import has_manifest
        from repro_torch.mutate import MutableAnnIndex, MutateConfig

        mcfg = MutateConfig(graph=args.graph)
        if has_manifest(args.durable_dir):
            index = MutableAnnIndex.recover(args.durable_dir, config=mcfg,
                                            spec=spec, device=dev)
            print(f"recovered {index.n_live} live rows from "
                  f"{args.durable_dir} (epoch {index.epoch})")
        else:
            base_idx = AnnIndex.build(ds.base, graph=args.graph, m=args.m,
                                      efc=args.efc, device=dev)
            index = MutableAnnIndex(base_idx, config=mcfg, spec=spec,
                                    durable_dir=args.durable_dir)
            print(f"created durable state in {args.durable_dir}")
        profile = index._state.snapshot.index.profile
        theta = np.arccos(profile.cos_theta_star)
    elif args.single:
        index = AnnIndex.build(ds.base, graph=args.graph, m=args.m,
                               efc=args.efc, device=dev)
        theta = np.arccos(index.profile.cos_theta_star)
    else:
        arrays = shard_dataset(ds.base, n_shards=n_dev,
                               graph=args.graph, m=args.m, efc=args.efc,
                               device=dev)
        theta = np.arccos(arrays.cos_theta)
        mesh = make_local_mesh(n_dev, "shards", device=dev)
        index = ShardedAnnIndex(arrays, mesh, spec=spec)
    print(f"index built in {time.time()-t0:.1f}s (theta*={theta/np.pi:.3f}pi)")

    t0 = time.time()
    fe = ServeFrontend(index, spec, buckets=buckets,
                       default_timeout=args.timeout)
    print(f"frontend warm in {time.time()-t0:.1f}s "
          f"({fe.telemetry.summary()['compiles_total']} bucket compiles)")

    gt = exact_ground_truth(ds, k=args.k, device=dev)
    drv = None
    if args.autotune:
        # explicit probe queries + GT: works against every backend here
        # (sharded/durable indexes expose no single corpus to synthesize
        # probes from)
        from repro_torch.autotune import AutotuneDriver, Objective

        t0 = time.time()
        n_probe = min(64, len(ds.queries))
        drv = AutotuneDriver.attach(
            fe, Objective(slo_p99_ms=args.slo_p99_ms),
            probe_queries=ds.queries[:n_probe], probe_gt=gt[:n_probe],
            seed=0)
        print(f"autotune attached in {time.time()-t0:.1f}s: "
              f"incumbent {drv.controller.incumbent} "
              f"(SLO p99<={args.slo_p99_ms:.0f}ms, "
              f"{len(drv.controller.quarantined)} quarantined)")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    # QueueFull backpressure: capped exponential backoff with jitter
    # (decorrelates many clients) instead of a hand-rolled fixed-sleep spin
    backoff = RetryPolicy(max_attempts=64, base_s=0.005, cap_s=0.25, seed=1)
    with fe:                                     # background flush worker
        if drv is not None:
            drv.start(period_s=0.5)              # controller epochs
        futs = []
        for i in range(len(sizes)):
            q = ds.queries[offsets[i]:offsets[i + 1]]
            futs.append(backoff.call(fe.submit, q, retry_on=QueueFull))
        done = [f.result() for f in futs]
        if drv is not None:
            drv.stop()
    rec = recall_at_k(np.concatenate([ids for ids, _, _ in done]), gt, args.k)

    summ = fe.telemetry.summary()
    lat = summ["latency"]
    print(f"router={args.router}: recall@{args.k}={rec:.3f} "
          f"QPS={summ['qps']:.0f} p50={lat['p50_ms']:.1f}ms "
          f"p95={lat['p95_ms']:.1f}ms p99={lat['p99_ms']:.1f}ms "
          f"recompiles_after_warmup={summ['recompiles_after_warmup']}")
    if drv is not None:
        print(f"autotune: {drv.switches} switches, {drv.failures} failures, "
              f"final spec {drv.controller.incumbent}")
        print("decisions:", json.dumps(drv.decision_log()))
    print("health:", json.dumps(fe.health()))
    print(json.dumps(summ, indent=2))
    if args.durable_dir is not None:
        index.close()               # final WAL fsync + writer release


if __name__ == "__main__":
    main()
