#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``   — compile the CUDA kernels (src/repro_torch/csrc/*.cu) with
   nvcc, one process per source, into build/repro_torch/.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card: ``fused_expand`` (B=128, L in {128, 256}, d in {128, 960, 100},
   with all-pruned and all-masked rows, out-of-range ids, the pad row and
   bound2=+inf) must give a bit-equal prune mask, the same +inf pattern and
   distances within rtol 1e-5; ``pool_merge`` (P in {64, 100}, L in
   {128, 256}, exact ties, +inf/pad sentinels, id*4+flags payloads) must be
   bit-exact.
3. ``hnsw``    — the main path with its hierarchy: make_dataset(50k x 128,
   64 clusters) -> AnnIndex.build(graph="hnsw", m=16, efc=64) -> search
   1024 queries in batches of 128 with SearchSpec(k=10, efs=100,
   router="crouting", beam_width=4) and beam_width=1, each on the "fused"
   (kernel) and the "torch" (plain) engine.
4. ``knn_1m``  — the kernels at a deployment's state size: 1M x 128 (one
   Gaussian cloud) -> AnnIndex.build(graph="knn", k=32) on the card, the
   same searches.
5. ``timing``  — each kernel, its plain version and its bound on inputs
   captured from the knn_1m main path (W=4, where the router hook decides
   the prunes, and W=1, where the kernel does).

For phases 3 and 4 the fused engine must launch both kernels, and the two
engines must agree: identical ids and per-query counters on >= 99% of
queries, mean dist_calls within 0.5%, recall@10 within 0.005.  Any failed
check raises and the script exits non-zero.  The last three lines are the
kernel table (JSON), the card's name and power limit (nvidia-smi), and
``{"ok": true, "device": {...}}``.

fp32 throughout, with TF32 off for matmuls and cuDNN: the K-NN build and
the ground truth are fp32 matrix products.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SPECS = {"W4": dict(k=10, efs=100, router="crouting", beam_width=4),
         "W1": dict(k=10, efs=100, router="crouting", beam_width=1),
         # no pruning: what the graph itself reaches at this efs
         "W4_none": dict(k=10, efs=100, router="none", beam_width=4)}
BATCH = 128


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int, before=None, group: int = 25):
    """Median per-launch device time (ms) from CUDA events.

    Each group of launches is enqueued behind a ~30 ms ``torch.cuda._sleep``
    so that the device, not the host's enqueue rate, sets the time between
    the events; ``before`` runs outside the timed window before each launch
    (an L2 flush).
    """
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for g in range(0, reps, group):
        n = min(group, reps - g)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        torch.cuda._sleep(50_000_000)
        for s, e in zip(starts, ends):
            if before is not None:
                before()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return statistics.median(times)


# --- phase 2: kernels against their plain versions ---------------------------
def fused_expand_case(rng, B, L, d, n_rows, dev):
    """Inputs with every edge case the engine can hand the kernel."""
    import numpy as np
    import torch
    table = rng.normal(size=(n_rows, d)).astype(np.float32)
    table[-1] = 0.0                                   # the pad row
    nbrs = rng.integers(0, n_rows - 1, size=(B, L)).astype(np.int32)
    nbrs[:, ::17] = n_rows - 1                        # pad-row lanes
    nbrs[2, ::3] = n_rows + 5                         # out of range
    nbrs[2, 1::5] = -1
    ed = rng.uniform(0, 30, size=(B, L)).astype(np.float32)
    ed[:, ::13] = np.inf                              # adjacency pad slots
    dcq = np.repeat(rng.uniform(5, 30, size=(B, L // 32)), 32, axis=1)
    dcq = dcq.astype(np.float32)
    bound2 = np.repeat(rng.uniform(10, 900, size=(B, 1)), L, axis=1)
    bound2 = bound2.astype(np.float32)
    bound2[3] = np.inf                                # never prunes
    ev = (rng.random((B, L)) < 0.7).astype(np.int8)
    el = (rng.random((B, L)) < 0.6).astype(np.int8)
    ev[0], el[0], bound2[0] = 1, 1, 0.0               # all pruned
    ed[0] = rng.uniform(0, 30, size=L)                # (NaN never prunes)
    ev[1], el[1] = 0, 0                               # all masked
    q = rng.normal(size=(B, d)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
    return (t(nbrs), t(q), t(ed), t(dcq), t(bound2), 0.31, t(table),
            t(ev), t(el))


def check_fused_expand(rng, dev):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_expand import fused_expand_cuda
    rows = []
    for L in (128, 256):
        for d in (128, 960, 100):
            raw = fused_expand_case(rng, 128, L, d, 20_001, dev)
            args = ops.prepare_fused_expand(*raw)
            kd, kp = fused_expand_cuda(*args)
            pd, pp = ref.fused_expand_ref(*args)
            torch.cuda.synchronize()
            check(torch.equal(kp, pp), f"fused_expand L={L} d={d}: prune "
                  "mask differs from the plain version")
            check(torch.equal(torch.isinf(kd), torch.isinf(pd)),
                  f"fused_expand L={L} d={d}: +inf pattern differs")
            fin = torch.isfinite(pd)
            err = (kd[fin] - pd[fin]).abs()
            rel = float((err / pd[fin].abs().clamp_min(1e-30)).max()) \
                if fin.any() else 0.0
            check(rel <= 1e-5, f"fused_expand L={L} d={d}: rel err {rel}")
            check(bool(kp[0][args[8][0] != 0].all()) and
                  bool(torch.isinf(kd[0]).all()) and
                  bool(torch.isinf(kd[1]).all()) and not bool(kp[1].any()),
                  "fused_expand: all-pruned / all-masked rows wrong")
            ms = cuda_times(lambda: fused_expand_cuda(*args), 50)
            rows.append({"L": L, "d": d, "max_abs_err": float(err.max())
                         if err.numel() else 0.0, "max_rel_err": rel,
                         "bit_equal": bool(torch.equal(kd, pd)),
                         "pruned": int(kp.sum()),
                         "computed": int(fin.sum()), "ms": ms})
    return rows


def pool_merge_case(rng, B, P, L, n, dev):
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    # distances on a coarse grid: many exact ties
    pd = np.round(rng.uniform(0, 5, size=(B, P)), 1).astype(np.float32)
    pi = rng.integers(0, n, size=(B, P)).astype(np.int32) * 4 \
        + rng.integers(0, 2, size=(B, P)).astype(np.int32)
    nd = np.round(rng.uniform(0, 5, size=(B, L)), 1).astype(np.float32)
    ni = rng.integers(0, n, size=(B, L)).astype(np.int32) * 4 \
        + 2 * rng.integers(0, 2, size=(B, L)).astype(np.int32)
    nd[:, ::3] = np.inf                               # masked new lanes
    ni[:, ::3] = n * 4
    pd[:, P // 2:] = np.inf                           # empty pool slots
    pi[:, P // 2:] = n * 4
    pd[5], pi[5] = np.inf, n * 4                      # an empty pool
    nd[6], ni[6] = 1.0, 7 * 4                         # all-equal new tile
    t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
    # the pool must arrive sorted by (dist, id)
    sd, si = ref.pool_merge_ref(t(pd), t(pi), t(pd[:, :0]), t(pi[:, :0]))
    return sd.contiguous(), si.contiguous(), t(nd), t(ni)


def check_pool_merge(rng, dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_merge import pool_merge_cuda
    rows = []
    for P in (64, 100):
        for L in (128, 256):
            args = pool_merge_case(rng, 128, P, L, 1_000_000, dev)
            kd, ki = pool_merge_cuda(*args)
            pd, pi = ref.pool_merge_ref(*args)
            torch.cuda.synchronize()
            exact = torch.equal(kd.view(torch.int32), pd.view(torch.int32)) \
                and torch.equal(ki, pi)
            check(exact, f"pool_merge P={P} L={L}: not bit-exact")
            ms = cuda_times(lambda: pool_merge_cuda(*args), 50)
            rows.append({"P": P, "L": L, "bit_exact": exact,
                         "max_abs_err": 0.0, "ms": ms})
    return rows


# --- phases 3 and 4: the main path on both engines ---------------------------
def run_engine(idx, queries, spec):
    import numpy as np
    import torch
    from repro_torch.core.spec import SearchStats
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ids, stats = [], []
    t0 = time.perf_counter()
    for s in range(0, len(queries), BATCH):
        i, _, st = idx.search(queries[s: s + BATCH], spec)
        ids.append(i)
        stats.append(st)
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return {"ids": np.concatenate(ids), "stats": SearchStats.merge(stats),
            "iters": [int(s.iters) for s in stats], "secs": secs,
            "launches": launches,
            "max_memory_allocated": int(torch.cuda.max_memory_allocated())}


def compare_engines(phase, name, fused, plain, gt, nq, main_launches):
    import numpy as np
    from repro_torch.data.vectors import recall_at_k
    out = {"phase": phase, "spec": name}
    same = np.all(fused["ids"] == plain["ids"], axis=1)
    for c in ("dist_calls", "est_calls", "hops"):
        same &= getattr(fused["stats"], c) == getattr(plain["stats"], c)
    agree = float(same.mean())
    rec = {}
    for eng, r in (("fused", fused), ("torch", plain)):
        st = r["stats"]
        rec[eng] = recall_at_k(r["ids"], gt, 10)
        out[eng] = {"qps": nq / r["secs"], "secs": r["secs"],
                    "recall@10": rec[eng],
                    "dist_calls": float(np.mean(st.dist_calls)),
                    "est_calls": float(np.mean(st.est_calls)),
                    "hops": float(np.mean(st.hops)),
                    "iters_per_batch": float(np.mean(r["iters"])),
                    "launches": r["launches"],
                    "max_memory_allocated": r["max_memory_allocated"]}
    out["agree_share"] = agree
    dc_f, dc_p = out["fused"]["dist_calls"], out["torch"]["dist_calls"]
    out["dist_calls_rel_diff"] = abs(dc_f - dc_p) / max(dc_p, 1e-9)
    emit(out)
    for k, v in fused["launches"].items():
        check(v > 0, f"{phase}/{name}: kernel {k} never launched on the "
              "fused engine")
        main_launches[k] = main_launches.get(k, 0) + v
    check(all(v == 0 for v in plain["launches"].values()),
          f"{phase}/{name}: the torch engine launched a kernel")
    check(agree >= 0.99, f"{phase}/{name}: engines agree on {agree:.4f} of "
          "queries (< 0.99)")
    check(out["dist_calls_rel_diff"] <= 0.005,
          f"{phase}/{name}: mean dist_calls differ by "
          f"{out['dist_calls_rel_diff']:.4%}")
    check(abs(rec["fused"] - rec["torch"]) <= 0.005,
          f"{phase}/{name}: recall differs {rec}")


def search_phase(phase, idx, ds, gt, main_launches, captures=None):
    import dataclasses
    from repro_torch.core.search import build_search_fn
    from repro_torch.core.spec import SearchSpec
    for name, kw in SPECS.items():
        runs = {}
        for engine in ("fused", "torch"):
            spec = SearchSpec(engine=engine, **kw)
            # copy the graph to the card before the clock starts
            build_search_fn(idx.graph, dataclasses.replace(
                spec, use_hierarchy=idx.graph.upper_neighbors is not None),
                device=idx.device)
            capture = (captures or {}).get(name)
            if capture is not None and engine == "fused":
                with capture:
                    runs[engine] = run_engine(idx, ds.queries, spec)
            else:
                runs[engine] = run_engine(idx, ds.queries, spec)
        compare_engines(phase, name, runs["fused"], runs["torch"], gt,
                        len(ds.queries), main_launches)


class CaptureInputs:
    """Record the arguments of the N-th call of each kernel wrapper during
    a main-path run (the last call if there are fewer), for timing the
    kernels on real inputs."""

    def __init__(self, nth: int = 30):
        self.nth = nth
        self.args = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._orig = {"fused_expand": ops.fused_expand,
                      "pool_merge": ops.pool_merge}
        calls = {"fused_expand": 0, "pool_merge": 0}

        def wrap(name):
            orig = self._orig[name]

            def f(*a, **kw):
                calls[name] += 1
                if calls[name] <= self.nth:
                    self.args[name] = (
                        [x.clone() if hasattr(x, "clone") else x for x in a],
                        {k: v.clone() if hasattr(v, "clone") else v
                         for k, v in kw.items()})
                return orig(*a, **kw)
            return f
        ops.fused_expand = wrap("fused_expand")
        ops.pool_merge = wrap("pool_merge")
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.fused_expand = self._orig["fused_expand"]
        ops.pool_merge = self._orig["pool_merge"]
        return False


def timing_phase(captures, main_launches):
    """Kernel vs plain version vs bound on inputs captured from knn_1m, per
    captured spec; returns the rows of the first (the serving spec)."""
    rows = {name: time_kernels(c, main_launches)
            for name, c in captures.items()}
    emit({"phase": "timing", "kernels": rows})
    return next(iter(rows.values()))


def time_kernels(capture, main_launches):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_expand import fused_expand_cuda
    from repro_torch.kernels.pool_merge import pool_merge_cuda
    kernels = []
    a, kw = capture.args["fused_expand"]
    args = ops.prepare_fused_expand(*a, **kw)
    # 64 MB written between timed launches evicts the 50 MB L2: the hop
    # loop's row reads are first touches
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                        device=args[0].device)
    nbrs, q = args[0], args[1]
    B, L = nbrs.shape
    d = q.shape[1]
    kd, kp = fused_expand_cuda(*args)
    pd, pp = ref.fused_expand_ref(*args)
    check(torch.equal(kp, pp) and torch.equal(torch.isinf(kd),
                                              torch.isinf(pd)),
          "timing: fused_expand disagrees on captured inputs")
    fin = torch.isfinite(pd)
    err = float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0
    computed = int(fin.sum())
    # bytes: computed rows + side arrays (nbrs, ed, dcq, bound2 4 B; two
    # int8 masks) + queries in; dist2 (4 B) + prune (1 B) out
    nbytes = computed * d * 4 + B * L * (4 * 4 + 2) + B * d * 4 + B * L * 5
    flops = computed * 3 * d + B * L * 8
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    kernels.append({
        "name": "fused_expand", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_expand.cu",
        "replaces": "src/repro/kernels/fused_expand.py:106",
        "launches": main_launches["fused_expand"], "max_abs_err": err,
        "ms": cuda_times(lambda: fused_expand_cuda(*args), 200, flush.zero_),
        "plain_ms": cuda_times(lambda: ref.fused_expand_ref(*args), 50,
                               flush.zero_),
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / FP32_FLOPS else "operations",
        "library_ms": None,
        "shape": {"B": B, "L": L, "d": d, "table_rows": args[6].shape[0],
                  "computed_lanes": computed, "pruned_lanes": int(kp.sum())}})

    a, _ = capture.args["pool_merge"]
    margs = (a[0].float().contiguous(), a[1].int().contiguous(),
             a[2].float().contiguous(), a[3].int().contiguous())
    B, P = margs[0].shape
    L = margs[2].shape[1]
    kd, ki = pool_merge_cuda(*margs)
    pd, pi = ref.pool_merge_ref(*margs)
    check(torch.equal(kd.view(torch.int32), pd.view(torch.int32))
          and torch.equal(ki, pi), "timing: pool_merge not bit-exact on "
          "captured inputs")
    nbytes = B * (P + L) * 8 + B * P * 8
    kernels.append({
        "name": "pool_merge", "route": "cuda",
        "source": "src/repro_torch/csrc/pool_merge.cu",
        "replaces": "src/repro/kernels/pool_merge.py:95",
        "launches": main_launches["pool_merge"], "max_abs_err": 0.0,
        "ms": cuda_times(lambda: pool_merge_cuda(*margs), 200),
        "plain_ms": cuda_times(lambda: ref.pool_merge_ref(*margs), 50),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": {"B": B, "P": P, "L": L}})
    return kernels


def profile_batch(idx, queries, spec):
    """Device time by kernel for one batch (torch.profiler) and the share
    of the batch's wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    idx.search(queries[:BATCH], spec)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.search(queries[:BATCH], spec)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue                            # kernels only, not host ops
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    ours = {name: {"device_ms": dt / 1e3, "count": c}
            for dt, k, c in rows for name in ("fused_expand", "pool_merge")
            if f"{name}_kernel" in k}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / wall_us) if busy else None,
            "kernel_launches": sum(r[2] for r in rows), "port_kernels": ours,
            "top": [{"name": k[:60], "device_ms": dt / 1e3, "count": c}
                    for dt, k, c in rows[:8]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core.angles import sample_angle_profile
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import exact_ground_truth, make_dataset
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = nvidia_smi("name,power.limit")

    # 1. build
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in build.BUILD_LOG.items()}
    emit({"phase": "build", "secs": time.perf_counter() - t0, "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    emit({"phase": "kernels", "fused_expand": check_fused_expand(rng, dev),
          "pool_merge": check_pool_merge(rng, dev)})

    main_launches = {}
    # 3. hnsw: the main path with its hierarchy, at a reduced n
    t0 = time.perf_counter()
    ds = make_dataset(n_base=50_000, n_query=1024, dim=128, n_clusters=64,
                      seed=0)
    idx = AnnIndex.build(ds.base, graph="hnsw", m=16, efc=64)
    build_secs = time.perf_counter() - t0
    gt = exact_ground_truth(ds, k=10)
    emit({"phase": "hnsw", "n": 50_000, "dim": 128, "m": 16, "efc": 64,
          "build_secs": build_secs,
          "levels": idx.graph.build_stats["levels"],
          "theta_star": idx.profile.theta_star,
          "cuts": "n 1M->50k, m 32->16, efc 256->64 (host HNSW builder)"})
    search_phase("hnsw", idx, ds, gt, main_launches)
    hnsw_prof = profile_batch(idx, ds.queries, SearchSpec(**SPECS["W4"]))
    del idx, ds

    # 4. knn_1m: the kernels at a deployment's state size
    t0 = time.perf_counter()
    ds = make_dataset(n_base=1_000_000, n_query=1024, dim=128, n_clusters=1,
                      seed=0)
    data_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = AnnIndex.build(ds.base, graph="knn", k=32, profile=False)
    torch.cuda.synchronize()
    knn_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = sample_angle_profile(idx.graph, n_sample=64, seed=0)
    prof_secs = time.perf_counter() - t0
    idx.profile = prof
    gt = exact_ground_truth(ds, k=10)
    emit({"phase": "knn_1m", "n": 1_000_000, "dim": 128, "k": 32,
          "dataset_secs": data_secs, "knn_build_secs": knn_secs,
          "profile_secs": prof_secs, "profile_queries": 64,
          "theta_star": prof.theta_star,
          "cuts": "graph K-NN instead of HNSW (host HNSW builder); angle "
                  "profile from 64 sampled searches instead of 1000"})
    captures = {"W4": CaptureInputs(), "W1": CaptureInputs()}
    search_phase("knn_1m", idx, ds, gt, main_launches, captures=captures)
    knn_prof = profile_batch(idx, ds.queries, SearchSpec(**SPECS["W4"]))
    emit({"phase": "profile", "hnsw_W4_fused": hnsw_prof,
          "knn_1m_W4_fused": knn_prof})

    # 5. kernels on captured main-path inputs
    kernels = timing_phase(captures, main_launches)
    emit({"phase": "done", "secs": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
