#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --tree DIR   # the step profiles alone, on
                                       # DIR/src (another checkout)

Phases, each printing one JSON line:

1. ``build``   — compile the eight CUDA kernels (src/repro_torch/csrc/*.cu)
   with nvcc, one process per source started at once, into
   build/repro_torch/.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card (B=128): ``fused_expand`` (L in {32, 128, 256}, d in {128, 960,
   100}, with all-pruned and all-masked rows, out-of-range and negative ids
   handed to the kernel unmasked, the pad row and bound2=+inf; masks as
   int8, bool or absent, ``prunes=False``, dcq/bound2 as [B, L], [B] and
   [B, W, M] or expanded views, a table off 16-byte alignment; d in
   {200, 384} at L=128 besides) must be bit-equal;
   ``pool_merge`` (P in {64, 100, 200} x L in {32, 128, 256} on the warp
   variant and P + L up to 4000 on the block variant, [512, 500] +
   [512, 256] and [512, 500] + [512, 284] among them; sorted and shuffled
   pools, exact ties, +inf/pad sentinels, id*4+flags payloads) must be
   bit-exact; the row kernels and ``crouting_prune`` also at L = 284 (4 x
   71 lanes: not a multiple of 32); ``sq8_distance`` (L in {32,
   128, 256}, d in {128, 960, 100}, with all-masked rows, out-of-range and
   negative ids unmasked, the pad row and constant dimensions; the eval
   mask as int8, bool or absent, a code table off alignment; d in {200,
   384} at L=128 besides), ``gather_distance`` (M in {4, 100, 128}, d in
   {128, 960, 100}, and M in {4, 128} at d in {1536, 2050}, past one
   sweep of the query; no mask, a compute or a skip mask as bool, int8 or
   uint8, a table off 16-byte alignment; out-of-range and negative ids
   unmasked) and ``crouting_prune`` (L in {128, 256}; ed, dcq and bound2
   as [B], [B, L], transposed, expanded and [B, W, M] zero-stride views;
   valid as int8, bool or uint8; inf edge lengths, NaN estimates, bound2 =
   +inf and 0) must be bit-equal;
   ``l2_distance`` (the reference sweep's four shapes plus [1, 1M, 128]
   and [33, 257, 960], Q in {1, 2, Qs, Qs + 1} and C on both sides of the
   streaming/tiled split, d in {33, 100, 960}, an offset view x[3:] and a
   base off 16-byte alignment; l2 and ip, fp32 and bf16 inputs) must agree
   with its plain version within rtol 1e-4, atol 1e-4*d; ``segment_sum``
   (``segment_sum_cases``: one id repeated 65,536 times, 3- and 155-row
   tables at B = 4,096 and 65,536, a 14-row one at 65,536, empty
   segments, a GNN aggregation's S ~ N ~ 170k, one hot id holding half of
   65,536 rows; d in {1, 64, 128, 960}; fp32 and bf16) must be bit-equal
   to its plain version on CPU copies, the call given the ids and the call
   given their runs bit-equal, one counted launch a call; ``normalize_rows``
   (``check_normalize_rows``: d in {16, 128, 1536, 1537, 3000} with a zero
   row; B = 1, 7 and 10,000 rows at d 1536, in place and off 16-byte
   alignment) bit-equal to its plain version on CPU copies, one counted
   launch a call.
2b. ``lm``    — the LM family (``repro_torch.models.transformer``; plain
   PyTorch and cuBLAS, and ``segment_sum`` for the token embedding's
   backward; none of the six search kernels: their counts must stay 0).
   ``lm.check``: fp32 at granite-8b's widths with 2 layers: the blockwise
   attention against a naive masked softmax at B=2, S=1024, H=32, dh=128
   (forward 1e-4, gradients 1e-3), the decode step against ``forward``
   (1e-3), ``moe_dispatch_indices`` at E=32, k=8, T=1024 equal to the
   CPU's, and ``moe_layer`` there (granite-moe's widths, fp32 and bf16)
   forward and backward twice: outputs and gradients bit-equal (its
   combine gathers and sums in choice order; the ``index_add`` combine it
   replaced is run twice beside it and reported).  ``lm.repeat``: a
   granite-moe-1b-a400m smoke step on a batch of 2 x 4,096 tokens that
   repeats one token 4,096 times, twice: the embedding gradient bit-equal
   (the other leaves reported), and the ops the step runs that have no
   deterministic CUDA implementation (``nondeterministic_ops``).
   ``lm.serve``:
   granite-8b at full width and depth in bf16, prefill B=2 x 4096 and 32
   greedy decode steps (finite logits; the first
   step at cosine >= 0.99 to ``forward`` in fp32 on the same weights, the
   bf16 cosines reported; bf16 decode at cosine >= 0.999 to the bf16
   ``forward`` on the same weights rescaled to a fan-in init).  ``lm.train``: four granite-moe-1b-a400m train
   steps at full width (bf16, fp32 AdamW moments, B=2 x 512, remat; loss
   and grad norm finite; the dispatch's kept share).  ``lm.launch``:
   ``python -m repro_torch.launch.train`` (``LM_LAUNCH_ARGS``), again with
   ``--resume``, and an in-process crash at 7, resume from 5, run to 12
   (granite-8b's and granite-moe-1b-a400m's smoke configs) whose last
   three losses equal the uninterrupted run's bit for bit.
2c. ``gnn``   — the GNN family (``repro_torch.models.gnn``; plain PyTorch
   and ``segment_sum``, none of the six search kernels: their counts must
   stay 0): three AdamW train
   steps of every arch (schnet, gat-cora, egnn, gin-tu) at
   ``full_graph_sm`` (2,708 nodes, 10,556 edges, 1,433 features),
   ``molecule`` (128 graphs x 30 nodes, 64 edges each) and
   ``minibatch_lg``'s sampled bounds (169,984 nodes, 168,960 edges, 602
   features), and of gin-tu at ``ogb_products`` (2,449,029 nodes,
   61,859,140 edges), counts padded to /512 with zero masks as the
   reference's cells pad; one line each: step seconds (first and steady),
   peak memory, the edge tensors' bytes, a finite loss and grad norm,
   whether two identical steps repeat bit for bit (reported, with the
   ops left without a deterministic CUDA implementation), and on the
   first two shapes the loss and gradients against the port on the CPU
   (rtol 1e-4).  ``dlrm.train``: dlrm-mlperf at its widths with 4M rows a
   table, ``train_batch`` B=65,536, fp32 AdamW, three donated steps:
   seconds, losses, peak memory; a second init and first step must repeat
   the first bit for bit in every leaf; the row-sharded lookup over 4
   slots of the card at those tables must equal the whole tables' lookup
   bit for bit, forward and gradient.  The lm, gnn and dlrm.train paths
   must launch ``segment_sum`` (every lookup's backward and every segment
   sum) and none of the six search kernels.  ``step_profiles``: one
   gin-tu ``ogb_products`` step and one ``dlrm.train`` step under the
   profiler, each with its peak memory and the device ms of
   ``segment_sum`` and of its set-up (every kernel launched inside
   ``segment_sum.runs``).
   ``quickstart``: ``examples/quickstart_torch.py`` as a subprocess (5,000
   x 128, HNSW m=16, efc=128; routers none, crouting, finger at efs=96 on
   the fused engine): exit 0, its "CRouting skipped" line; its launches
   count with the main paths'.
2d. ``cells`` — ``models/api.build_cell``'s ANNS cell at
   ``serve_100m_gist``'s widths (dim 960, max degree 32, B 256, efs 128,
   crouting, fused engine) with its rows cut to 200,000 on one slot (an
   exact K-NN graph, k = 32, built on the card): a batch timed, its
   fused kernels launched, equal to the torch engine.  Then the dry run's
   one-H100 bound (``launch/dryrun.cell_terms``: ``step_time_lb_s``,
   ``dominant``) beside the measured seconds, at the dims each ran, of
   granite-8b prefill 2 x 4,096 and decode 2 x 4,128, granite-moe train
   2 x 512, gin-tu ``ogb_products``, ``dlrm.train`` and the ANNS cell
   (the measurements are the phases' above, not run again).
3. ``hnsw``    — the main path with its hierarchy: make_dataset(30k x 128,
   64 clusters) -> AnnIndex.build(graph="hnsw", m=16, efc=64) -> search
   1024 queries in batches of 128 with every spec of ``SPECS`` and
   ``FINGER_SPECS`` on its engines: the "torch" (plain) engine, the "fused"
   kernel engine and, for the specs in ``UNFUSED_SPECS`` and the FINGER
   specs, the "unfused" kernel engine.
4. ``nsg``     — NSG construction on the card at the paper's widths (R=70,
   C=500, L=60, knn_k=64) on the hnsw phase's data: AnnIndex.build(
   graph="nsg") (K-NN graph, candidate acquisition through ``fused_expand``
   and ``pool_merge`` at B=512, efs=500, tensor MRNG, spanning tree), its
   seconds per step and launches; the built graph's rows against the NumPy
   MRNG loop on the candidate pools the build handed its tensor MRNG for
   2,000 sampled nodes (>= 0.999 of rows equal, every differing row with
   its margin); the phase-2 checks again at the shapes this graph gives
   the kernels (``nsg_kernel_checks``: the tiles W*M at W = 4 and 1 with M
   the graph's padded degree, their merges into the efs pool, and the
   acquisition's fused_expand at B = 512 and block-variant pool_merge);
   every spec of ``SPECS`` and ``FINGER_SPECS`` on every engine, with each
   kernel held bit for bit against its plain version on inputs captured
   from each (spec, engine) run (``captured_equal``); save, ``load`` on
   the card and search ``W4`` again (ids and counters equal).
3b. ``serve`` — the serving frontend (``repro_torch.serve``) on the hnsw
   index: a bucket ladder of (1, 8, 32, 128) warmed for three sessions
   (``W4`` fused, ``W4_both`` fused, ``W4`` unfused); a seeded ragged
   stream over the 1024 queries (1..128 rows a request, k mixed over 1, 5,
   10) through ``flush()``, an armed ``serve.dispatch`` fault that must
   fail only its own batch, then the worker thread serving the same stream
   from 4 submitting threads.  Every request's ids, dists and per-query
   counters must equal a direct ``idx.search`` of its rows, no request may
   pay a first-use event after warmup (``recompiles_after_warmup == 0``),
   each dispatch must launch exactly its (engine, spec)'s kernels.
   Printed: latency percentiles, queue wait, QPS, pad overhead and first
   uses by rung, for the flush and worker parts.
4b. ``mutate`` — live mutation (``repro_torch.mutate``) on an NSG at the
   nsg phase's widths over the first 10k rows of its data (cut from 30k to
   keep the script within its time), behind the frontend (worker thread),
   with a durable directory
   (``wal_fsync="every"``): ragged requests interleaved with inserts of
   1,024 fresh rows from the same mixture in chunks of 64 and 512 uniform
   deletes, served on until a background merge (an NSG at the same
   widths, built on the card) has completed with requests in flight.  No
   result may hold an id deleted before its request, no first use on the
   request path across the swap, recall@10 >= 0.95 x that of a static NSG
   rebuild over the final live rows, ``fused`` and ``torch`` equal after
   the merge.  Then ingest rows/s for each fsync policy, and the
   kill-at-every-site sweep (``wal.append``, ``wal.fsync``,
   ``wal.rotate``, ``checkpoint.write``, ``manifest.rename``): each crash
   recovered on the card with no acknowledged mutation lost, no delete
   resurrected, and searches equal to an index that never crashed.
   Printed: the merge's seconds by step and its build's launches, request
   latency during the merge and outside it, recovery seconds.
4c. ``sharded`` — the sharded index (``repro_torch.core.sharded_index``)
   on the mutate phase's 10k rows in four HNSW shards (m=16, efc=64 each,
   ``build_shards`` + ``stack_shards``, which is ``shard_dataset``), four
   shard slots on the one card: ``W4``, ``W1`` and ``W4_both`` on
   ``fused`` and ``torch`` and ``W4`` on ``unfused`` over the 1,024
   queries in batches of 128.  Each kernel engine must equal ``torch``
   (ids, dists, every batch's totals), each batch must launch exactly its
   (engine, spec)'s kernels, each kernel must be bit-equal to its plain
   version on the shard inputs the run captured; recall@10 against exact
   ground truth over the 10k rows.  The merged top-efs must equal a host
   merge of the four shards' own ``_search_batch`` pools; ``max_hops=8``
   gives ``iters <= 8``; a bucket-padded batch's totals equal the
   unpadded batch's; ``router="finger"`` raises ``NotImplementedError``.
   ``ShardedIndexSession`` behind ``ServeFrontend`` (ladder 1, 8, 32,
   128) on the serve phase's ragged stream: each request equal to a direct
   sharded search, 0 first uses after warmup.  A durable
   ``MutableShardedAnnIndex`` over the same four shard graphs behind the
   worker: 1,024 fresh rows in chunks of 64, 512 deletes, served until a
   staggered background merge has swapped in; at most one shard merges
   at a time, 0 deleted-id leaks, 0 first uses across the swap,
   ``shard.search.1`` armed degrades to the other three shards'
   composition, ``recover`` from the parent manifest equals the live
   index.  Printed: build seconds and a 128-row batch's wall ms and idle
   share at S=4 beside a single 10k index's.
4d. ``launch`` — ``python -m repro_torch.launch.serve`` with
   ``LAUNCH_ARGS`` (5,000 x 128, 64 requests, ``--autotune``) as a
   subprocess on the card: exit 0, ``recompiles_after_warmup=0``; printed
   the screen's seconds, the controller's switches, failures and final
   spec.
5. ``router_sweep`` — every registered router on every engine on
   benchmarks/bench_engine.py's ``engine_router_sweep`` setting
   (sift-synth 4000 x 128, HNSW m=16, efc=128, k=10, efs=64): dist_calls
   within 1% and recall within 0.01 of BENCH_engine.json's.
6. ``knn_1m``  — the kernels at a deployment's state size: 1M x 128 (one
   Gaussian cloud) -> AnnIndex.build(graph="knn", k=32) on the card, the
   same searches (no FINGER: its host table build at 1M nodes).
7. ``retrieval`` — the dlrm-mlperf retrieval path
   (examples/dlrm_retrieval_torch.py): the DLRM serve step at full widths
   (vocabulary capped at 4M rows a table) on ``serve_p99``; brute force at
   ``retrieval_cand`` (1M unit-norm 128-d candidates, 1 and 32 queries)
   through ``make_retrieval_step`` and the ``l2_distance`` kernel in ip
   mode, whose top-100 must equal the step's up to ties; a CRouting-HNSW
   index with ``metric="ip"`` (m=16, efc=96) over 10k candidates drawn as
   the example draws them, searched at k=100, efs=200 with every spec of
   ``IP_SPECS`` on its engines (recall@100 against brute force).
7b. ``cosine`` — a cosine index's query batches on the card
   (``cosine_phase``): a K-NN index (k 64) under ``metric="cosine"`` over
   50,000 rows of d 1,536 and intrinsic dimension 32, searched through
   ``AnnIndex.search`` at the dbpedia500k cell's batch (10,000
   unnormalised rows, crouting W 4, efs 128) three times:
   ``normalize_rows`` launches once a call (these launches are the
   kernel table's count), ``search.normalised_rows`` grows by 10,000 a
   call, the engine's set-up holds the library before the first call, and
   recall@10 is above 0.5 and that of the engine fed host-normalised rows
   within 1e-3.
8. ``timing``  — each kernel, its plain version and its bound on inputs
   captured from the knn_1m main path: fused_expand and pool_merge at W=4
   (the router hook decides the prunes) and W=1 (the kernel does), and on
   the NSG build's acquisition ([512, 256] tiles, pool_merge's block
   variant at [512, 500] + [512, 256]),
   sq8_distance on the stage-1 tile and gather_distance on the in-loop
   [B, W] and final [B, efs] reranks of ``W4_both``, crouting_prune and
   gather_distance on the unfused W=4 tile; l2_distance in ip mode at
   [1, 1M, 128], [32, 1M, 128] and [8, 8192, 128] on the retrieval
   phase's inputs, beside one ``torch.addmm`` call (cuBLAS fp32) that
   computes the same function; pool_merge also on the ip index's [128, 200]
   pool (W=4); l2_distance's streaming and tiled kernels at [Q, C, 128]
   for Q up to 16 and C from 8192 to 1M (the crossover that
   ``choose_variant`` encodes).  Each time is the median of per-launch CUDA
   event pairs (``ms``, as in earlier runs) and of the kernel's own device
   time from the profiler (``device_ms``, with the launches the trace
   kept beside it, ``device_kept``: each profiler window is padded with
   spin-kernel launches at both ends, without which a long run's trace
   lost launches); ``event_floor`` is what the event pair alone costs,
   with that trace check.  For ``fused_expand``, ``sq8_distance``, ``gather_distance`` (at
   its three call sites) and ``crouting_prune`` the row also carries the
   whole wrapper call's device time and kernel count
   (``wrapper_device_ms``, ``wrapper_launches``), an empty kernel's time
   on the same grid (``empty_launch_ms``) and, for the row kernels, the
   kernel's time on the same inputs with every lane masked, which reads
   no row (``no_rows_device_ms``).  ``segment_sum`` at the lookups' and
   aggregations' shapes of the lm, gnn and dlrm.train paths and on a
   skewed id list, beside one ``torch.index_add`` call (atomics), the
   whole wrapper call (``wrapper_ms``: set-up and kernel), the set-up
   alone (int32 and int64 keys), the device time with the run-start
   grid's zeroing, and the chain bound (the longest run times the card's
   dependent add, ``add_chain``: a one-thread chain of 10^6 adds).
   ``normalize_rows`` at a cosine cell's query batch, [10,000, 1,536],
   behind the L2 flush, beside ``torch.nn.functional.normalize`` and the
   host's NumPy pass it replaced (``numpy_ms``, host clock) and the
   batch's pageable upload (``upload_ms``).

For phases 3, 4, 4c, 6 and the index of 7 each kernel engine must launch
exactly the kernels its (engine, spec) runs (``expected_kernels``; every
one at least once, no other), and must agree with the torch engine:
identical ids and per-query counters (dist_calls, est_calls, hops,
rerank_calls, sq8_calls and the router's own, finger_est_calls) on >= 99%
of queries, mean dist_calls within 0.5%, recall within 0.005.  Each phase resets the kernels' launch counts just before
it drives its path and reads them just after.  Any failed check raises
and the script exits non-zero.  The last three lines are the kernel table
(JSON), the card's name and power limit (nvidia-smi), and
``{"ok": true, "device": {...}}``.

fp32 throughout, with TF32 off for matmuls and cuDNN: the K-NN build and
the ground truth are fp32 matrix products.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SPECS = {"W4": dict(k=10, efs=100, router="crouting", beam_width=4),
         "W1": dict(k=10, efs=100, router="crouting", beam_width=1),
         # no pruning: what the graph itself reaches at this efs
         "W4_none": dict(k=10, efs=100, router="none", beam_width=4),
         # the serving spec with the two-stage SQ8 path behind crouting
         "W4_both": dict(k=10, efs=100, router="crouting", estimate="both",
                         beam_width=4),
         # the two-stage path alone
         "W1_sq8": dict(k=10, efs=100, router="none", estimate="sq8",
                        beam_width=1)}
UNFUSED_SPECS = ("W4", "W4_both", "W1_sq8")
# the FINGER comparison router (paper §5.7) in the hnsw and nsg phases: its
# estimate is plain PyTorch under every engine, the kernels do the rest
FINGER_SPECS = {"finger_W1": dict(k=10, efs=100, router="finger",
                                  beam_width=1),
                "finger_W4": dict(k=10, efs=100, router="finger",
                                  beam_width=4)}
# NSG at the paper's widths (§5.1: R=70, C=500, L=60), K-NN graph k=64
NSG_KW = dict(r=70, c=500, l=60, knn_k=64)
# the rows a batch of the NSG build's acquisition (build_nsg's default)
NSG_ACQUIRE_BATCH = 512
# nodes whose MRNG selection on the card is held against the NumPy loop
MRNG_SAMPLE = 2000
# the retrieval example's spec (k=100, efs=2k) and its beam forms
IP_SPECS = {"ip_W1": dict(k=100, efs=200, router="crouting"),
            "ip_W4": dict(k=100, efs=200, router="crouting", beam_width=4),
            "ip_W4_both": dict(k=100, efs=200, router="crouting",
                               beam_width=4, estimate="both"),
            # no pruning: what the graph itself reaches at this efs
            "ip_W4_none": dict(k=100, efs=200, router="none", beam_width=4)}
IP_UNFUSED_SPECS = ("ip_W4", "ip_W4_both")
# the lm phase: granite-8b prefill + greedy decode at full width and depth,
# granite-moe-1b-a400m train steps at full width, the training launcher
LM_SERVE = dict(batch=2, prompt=4096, new_tokens=32)
LM_TRAIN = dict(batch=2, seq=512, steps=4)
LM_RESUME_ARCHS = ("granite-8b", "granite-moe-1b-a400m")   # dense, MoE
LM_LAUNCH_ARGS = ("--arch", "granite-8b", "--steps", "12", "--ckpt-every",
                  "5")
# the hnsw and nsg phases' base rows (the host HNSW builder and the NSG
# build set most of the script's time)
HNSW_BASE = 30_000
COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")
BATCH = 128


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    """Print one phase line, with the seconds since the script started."""
    print(json.dumps({**obj, "script_secs": time.perf_counter() - T_START}),
          flush=True)


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


# launches of torch's one-thread spin kernel at each end of a profiler
# window: late in a long process the trace loses a fixed number of activity
# records a window (event_floor_ms's trace check), and these are what it
# loses instead of the timed launches
TRACE_PAD_LAUNCHES = 64
PAD_KERNEL = "spin_kernel"


def _pad_launches(n: int) -> None:
    import torch
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def traced_kernels(fn, reps: int, before=None,
                   pad: int = TRACE_PAD_LAUNCHES):
    """(name, device us) of every kernel torch.profiler's CUPTI trace kept
    over ``reps`` calls of ``fn`` (``before`` runs ahead of each call),
    with ``pad`` spin-kernel launches at both ends of the window, which are
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_launches(pad)
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
        _pad_launches(pad)
    return [(e.name, getattr(e, "device_time", None)
             or getattr(e, "cuda_time", 0)) for e in prof.events()
            if "CUDA" in str(e.device_type) and PAD_KERNEL not in e.name]


def kernel_device_ms(fn, key: str, reps: int = 100, before=None,
                     tries: int = 3):
    """(median device time in ms, "kept/reps") of the kernels whose name
    holds ``key`` in the profiler's trace of ``reps`` calls of ``fn``: the
    kernel's own run, without the ~5 us that a pair of CUDA events around
    one launch adds (see ``event_floor_ms``).  A window that lost launches
    is taken again, up to ``tries`` windows, and the fullest is used; its
    kept count stands beside every device time, and the median is None
    below ten."""
    us = []
    for _ in range(tries):
        got = [t for n, t in traced_kernels(fn, reps, before) if key in n]
        us = max(us, got, key=len)
        if len(us) >= reps:
            break
    return (statistics.median(us) / 1e3 if len(us) >= 10 else None,
            f"{len(us)}/{reps}")


def trace_check(pad: int, reps: int = 100):
    """Which of ``reps`` one-element adds the trace lost (by index, from
    each host op's linked kernels), with ``pad`` spin launches at both ends
    of the window; the kernel names the padding left in the trace; and the
    median lag from each add's host op to its kernel (negative: the
    kernel's converted timestamp runs ahead of the host op's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    z = torch.zeros(1, device="cuda")
    z.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_launches(pad)
        for _ in range(reps):
            z.add_(1)
        torch.cuda.synchronize()
        _pad_launches(pad)
    evs = prof.events()
    host = sorted((e for e in evs if e.name == "aten::add_"),
                  key=lambda e: e.time_range.start)
    kern = sorted((e for e in evs if "CUDA" in str(e.device_type)
                   and "elementwise" in e.name),
                  key=lambda e: e.time_range.start)
    kept = [h for h in host if h.kernels]
    lags = ([k.time_range.start - h.time_range.start
             for h, k in zip(kept, kern)] if len(kept) == len(kern) else [])
    dropped = [i for i, h in enumerate(host) if not h.kernels]
    return {"kept": f"{len(host) - len(dropped)}/{len(host)}",
            "dropped_at": dropped,
            "pad_kernels": sorted({e.name[:40] for e in evs
                                   if "CUDA" in str(e.device_type)
                                   and "elementwise" not in e.name}),
            "launch_to_kernel_us": statistics.median(lags) if lags else None}


def event_floor_ms():
    """``cuda_times`` of a one-element add: what the event pair around a
    launch costs on its own, beside the same add's device time; and the
    trace check, with and without the padding."""
    import torch
    z = torch.zeros(1, device="cuda")
    out = {"events_ms": cuda_times(lambda: z.add_(1), 200)}
    out["device_ms"], out["device_kept"] = kernel_device_ms(
        lambda: z.add_(1), "elementwise")
    out["trace_check"] = {"unpadded": trace_check(0),
                          "padded": trace_check(TRACE_PAD_LAUNCHES)}
    return out


# --- phase 2: kernels against their plain versions ---------------------------
def lane_group(L, W=None):
    """Lanes one beam slot owns in the row-kernel checks: L / W where the
    case names its beam width W (the nsg phase's tiles: W slots of the
    graph's degree), else 32, or L / 4 where L is not a multiple of 32."""
    if W:
        return L // W
    return 32 if L % 32 == 0 else L // 4


def fused_expand_case(rng, B, L, d, n_rows, dev, W=None):
    """Inputs with every edge case the engine can hand the kernel; the ids
    out of range and negative are not masked (the kernel checks them)."""
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
    g = lane_group(L, W)
    dcq = np.repeat(rng.uniform(5, 30, size=(B, L // g)), g, axis=1)
    dcq = dcq.astype(np.float32)
    bound2 = np.repeat(rng.uniform(10, 900, size=(B, 1)), L, axis=1)
    bound2 = bound2.astype(np.float32)
    bound2[3] = np.inf                                # never prunes
    ev = (rng.random((B, L)) < 0.7).astype(np.int8)
    el = (rng.random((B, L)) < 0.6).astype(np.int8)
    ev[0], el[0], bound2[0] = 1, 1, 0.0               # all pruned
    ed[0] = rng.uniform(0, 30, size=L)                # (NaN never prunes)
    ev[1], el[1] = 0, 0                               # all masked
    ev[2], el[2] = 1, 1                               # every bad id offered
    q = rng.normal(size=(B, d)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
    return (t(nbrs), t(q), t(ed), t(dcq), t(bound2), 0.31, t(table),
            t(ev), t(el))


# (L, d) of the two row kernels' cases: the widths the hnsw and knn
# searches give L, a tile of 4 x 71 lanes (not a multiple of 32), and d
# across each count of 128-element passes the kernels are built for; the
# nsg phase adds the tiles its graph gives (``nsg_kernel_checks``)
ROW_KERNEL_SHAPES = ([(L, d) for L in (32, 128, 256) for d in (128, 960, 100)]
                     + [(128, 200), (128, 384), (284, 128)])


EXPAND_FORMS = ("int8", "bool", "no_prune", "default_masks", "per_query",
                "beam_view", "unaligned")


def expand_form(raw, form, W=None):
    """``fused_expand_case``'s inputs in one of the operand forms the
    wrapper takes: (args, kwargs)."""
    import torch
    nbrs, q, ed, dcq, b2, ct, table, ev, el = raw
    B, L = nbrs.shape
    kw = dict(eval_mask=ev, prune_eligible=el)
    if form == "bool":
        kw = dict(eval_mask=ev != 0, prune_eligible=el != 0)
    elif form == "no_prune":                  # the search loop at W > 1
        kw = dict(eval_mask=ev != 0, prune_eligible=None, prunes=False)
    elif form == "default_masks":
        kw = {}
    elif form == "per_query":
        dcq, b2 = dcq[:, 0].contiguous(), b2[:, 0].contiguous()
    elif form == "beam_view":                 # [B, W] over M, bound2 [B]
        g = lane_group(L, W)
        dcq = dcq[:, ::g].contiguous()[:, :, None].expand(B, L // g, g)
        b2 = b2[:, 0].contiguous()[:, None].expand(B, L)
    elif form == "unaligned":
        flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                           device=table.device)
        flat[1:] = table.reshape(-1)
        table = flat[1:].view(table.shape)
    return (nbrs, q, ed, dcq, b2, ct, table), kw


def check_fused_expand(rng, dev, cases=None):
    """``cases``: (B, L, d, W) with W None for ``lane_group``'s default;
    by default B = 128 at ``ROW_KERNEL_SHAPES``."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_expand import fused_expand_cuda
    rows = []
    if cases is None:
        cases = [(128, L, d, None) for L, d in ROW_KERNEL_SHAPES]
    for B, L, d, W in cases:
        raw = fused_expand_case(rng, B, L, d, 20_001, dev, W)
        for form in EXPAND_FORMS:
            args, kw = expand_form(raw, form, W)
            kd, kp = fused_expand_cuda(*args, **kw)
            pd, pp = ref.fused_expand_ref(*ops.prepare_fused_expand(
                *args, **kw))
            torch.cuda.synchronize()
            check(bit_equal(kp, pp) and bit_equal(kd, pd),
                  f"fused_expand B={B} L={L} d={d} W={W} {form}: not "
                  "bit-equal with the plain version")
        args, kw = expand_form(raw, "int8", W)
        kd, kp = fused_expand_cuda(*args, **kw)
        ok = (args[0] >= 0) & (args[0] < args[6].shape[0])
        check(bool((kp[0] == ok[0]).all()) and
              bool(torch.isinf(kd[0]).all()) and
              bool(torch.isinf(kd[1]).all()) and not bool(kp[1].any())
              and bool(torch.isinf(kd[2][~ok[2]]).all())
              and not bool(kp[2][~ok[2]].any()),
              "fused_expand: all-pruned / all-masked / out-of-range "
              "lanes wrong")
        args, kw = expand_form(raw, "bool", W)
        pd, pp = ref.fused_expand_ref(*ops.prepare_fused_expand(*args, **kw))
        rows.append({"B": B, "L": L, "d": d, "lanes_a_slot": lane_group(L, W),
                     "forms": list(EXPAND_FORMS),
                     "bit_equal": True, "max_abs_err": 0.0,
                     "pruned": int(pp.sum()),
                     "computed": int(torch.isfinite(pd).sum()),
                     "ms": cuda_times(
                         lambda: fused_expand_cuda(*args, **kw), 50)})
    return rows


def pool_merge_case(rng, B, P, L, n, dev, pool_sorted=True):
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
    if not pool_sorted:
        # any order, sentinels included: a stage-2 rerank leaves the pool
        # unsorted, and the kernel may assume nothing
        perm = np.argsort(rng.random((B, P)), axis=1)
        pd = np.take_along_axis(pd, perm, axis=1)
        pi = np.take_along_axis(pi, perm, axis=1)
        return t(pd), t(pi), t(nd), t(ni)
    sd, si = ref.pool_merge_ref(t(pd), t(pi), t(pd[:, :0]), t(pi[:, :0]))
    return sd.contiguous(), si.contiguous(), t(nd), t(ni)


# (B, P, L): the search paths' shapes (P = efs 100 or 200; L = W*M 32, 128
# or 256), then the block variant (P + L past WARP_MAX_NET, up to MAX_NET):
# the NSG build's candidate acquisition (B = 512, P = C = 500, L = 4 x 64)
# and a tile of 4 x 71 lanes beside it; the nsg phase adds the shapes its
# graph gives (``nsg_kernel_checks``)
POOL_SHAPES = tuple((128, P, L) for P in (64, 100, 200)
                    for L in (32, 128, 256)) \
    + ((128, 300, 400), (512, 500, 256), (512, 500, 284),
       (128, 1000, 1000), (128, 2000, 2000))


def check_pool_merge(rng, dev, shapes=POOL_SHAPES):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_merge import choose_variant, pool_merge_cuda
    rows = []
    for B, P, L in shapes:
        for pool_sorted in (True, False):
            args = pool_merge_case(rng, B, P, L, 1_000_000, dev,
                                   pool_sorted)
            kd, ki = pool_merge_cuda(*args)
            pd, pi = ref.pool_merge_ref(*args)
            torch.cuda.synchronize()
            exact = bit_equal(kd, pd) and bit_equal(ki, pi)
            check(exact, f"pool_merge B={B} P={P} L={L} "
                  f"sorted={pool_sorted}: not bit-exact")
            rows.append({"B": B, "P": P, "L": L, "pool_sorted": pool_sorted,
                         "variant": choose_variant(P, L)[0],
                         "bit_exact": exact, "max_abs_err": 0.0,
                         "ms": cuda_times(lambda: pool_merge_cuda(*args),
                                          50)})
    return rows


def bit_equal(a, b):
    """Same bits (NaN and the sign of zero included) and same shape."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def sq8_case(rng, B, L, d, n_rows, dev):
    """Stage-1 inputs with every edge case the engine can hand the kernel:
    the pad row, out-of-range and negative ids (unmasked: the kernel checks
    them), an all-masked row and constant dimensions (scale 1e-12)."""
    import numpy as np
    import torch
    from repro_torch.quant import sq8 as SQ
    x = rng.normal(size=(n_rows - 1, d)).astype(np.float32)
    x[:, ::7] = 0.75                                  # constant dimensions
    qp = SQ.sq8_train(x)
    codes = SQ.sq8_encode(np.concatenate([x, np.zeros((1, d), np.float32)]),
                          qp)
    nbrs = rng.integers(0, n_rows - 1, size=(B, L)).astype(np.int32)
    nbrs[:, ::17] = n_rows - 1                        # pad-row lanes
    nbrs[2, ::3] = n_rows + 5                         # out of range
    nbrs[2, 1::5] = -1
    ev = (rng.random((B, L)) < 0.7).astype(np.int8)
    ev[1] = 0                                         # all masked
    ev[2] = 1                                         # every bad id offered
    ev[3] = 1                                         # all evaluated
    q = rng.normal(size=(B, d)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
    return t(nbrs), t(q), t(ev), t(codes), t(qp.lo), t(qp.scale), t(qp.eps)


SQ8_FORMS = ("int8", "bool", "no_mask", "unaligned")


def sq8_form(raw, form):
    """``sq8_case``'s inputs with the eval mask as int8, bool or None, or
    the code table one byte off alignment."""
    import torch
    nbrs, q, ev, codes, lo, scale, eps = raw
    if form == "bool":
        ev = ev != 0
    elif form == "no_mask":
        ev = None
    elif form == "unaligned":
        flat = torch.empty(codes.numel() + 1, dtype=codes.dtype,
                           device=codes.device)
        flat[1:] = codes.reshape(-1)
        codes = flat[1:].view(codes.shape)
    return nbrs, q, ev, codes, lo, scale, eps


def check_sq8_distance(rng, dev, cases=None):
    """``cases``: (B, L, d); by default B = 128 at ``ROW_KERNEL_SHAPES``."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sq8_distance import sq8_distance_cuda
    rows = []
    if cases is None:
        cases = [(128, L, d) for L, d in ROW_KERNEL_SHAPES]
    for B, L, d in cases:
        raw = sq8_case(rng, B, L, d, 20_001, dev)
        for form in SQ8_FORMS:
            args = sq8_form(raw, form)
            ka, kl = sq8_distance_cuda(*args)
            pa, pl = ref.sq8_estimate_ref(*ops.prepare_sq8_estimate(*args))
            torch.cuda.synchronize()
            check(bit_equal(ka, pa) and bit_equal(kl, pl),
                  f"sq8_distance B={B} L={L} d={d} {form}: not bit-equal "
                  "with the plain version")
        bad = (raw[0][2] < 0) | (raw[0][2] >= raw[3].shape[0])
        check(bool(torch.isinf(ka[1]).all()) and
              bool(torch.isfinite(ka[3]).all()) and
              bool(torch.isinf(ka[2][bad]).all()) and
              bool(torch.isfinite(ka[2][~bad]).all()),
              "sq8_distance: masked / evaluated / out-of-range rows wrong")
        args = sq8_form(raw, "bool")
        pa, pl = ref.sq8_estimate_ref(*ops.prepare_sq8_estimate(*args))
        rows.append({"B": B, "L": L, "d": d, "forms": list(SQ8_FORMS),
                     "bit_equal": True, "max_abs_err": 0.0,
                     "evaluated": int(torch.isfinite(pa).sum()),
                     "ms": cuda_times(lambda: sq8_distance_cuda(*args), 50)})
    return rows


# (M, d) of the gather checks: the call sites' widths across d, d past
# 1024, where the row is swept 1024 elements at a time (float4 and scalar),
# and a tile of 4 x 71 lanes; the nsg phase adds the widths its graph gives
# (``nsg_kernel_checks``)
GATHER_SHAPES = ([(M, d) for M in (4, 100, 128) for d in (128, 960, 100)]
                 + [(M, d) for M in (4, 128) for d in (1536, 2050)]
                 + [(284, 128)])
GATHER_FORMS = ("none", "compute_bool", "compute_int8", "compute_uint8",
                "skip_bool", "skip_int8", "skip_uint8", "unaligned")


def gather_form(idx, q, table, skip, form):
    """(idx, queries, table, mask, computes) in one of the forms the gather
    wrappers take (no mask; a compute or skip mask as bool, int8 or uint8;
    a table off 16-byte alignment under a bool compute mask); the mask
    marks the same lanes in every polarity."""
    import torch
    if form == "none":
        return idx, q, table, None, False
    if form == "unaligned":
        flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                           device=table.device)
        flat[1:] = table.reshape(-1)
        return idx, q, flat[1:].view(table.shape), skip == 0, True
    polarity, dt = form.split("_")
    mask = (skip == 0) if polarity == "compute" else (skip != 0)
    return idx, q, table, mask.to(getattr(torch, dt)), polarity == "compute"


def gather_plain(idx, q, table, mask, computes):
    """The plain version on the arguments of a gather form."""
    from repro_torch.kernels import ops, ref
    return ref.gather_distance_ref(*ops.prepare_gather_distance(
        idx, q, table, mask, computes))


def check_gather_distance(rng, dev, shapes=GATHER_SHAPES):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_distance import gather_distance_cuda
    rows = []
    n_rows = 20_001
    for M, d in shapes:
        table = rng.normal(size=(n_rows, d)).astype(np.float32)
        table[-1] = 0.0
        idx = rng.integers(0, n_rows, size=(128, M)).astype(np.int32)
        idx[2, ::3] = n_rows + 5                  # out of range
        idx[2, 1::3] = -1                         # negative
        skip = (rng.random((128, M)) < 0.4).astype(np.int8)
        skip[1] = 1                               # all skipped
        skip[2] = 0                               # bad ids offered
        q = rng.normal(size=(128, d)).astype(np.float32)
        raw = [torch.as_tensor(a, device=dev)
               for a in (idx, q, table, skip)]
        for form in GATHER_FORMS:
            args = gather_form(*raw, form)
            kd = gather_distance_cuda(*ops.cuda_args_gather_distance(*args))
            pd = gather_plain(*args)
            torch.cuda.synchronize()
            check(bit_equal(kd, pd), f"gather_distance M={M} d={d} "
                  f"{form}: not bit-equal with the plain version")
            check(bool(torch.isinf(kd[2][::3]).all()) and
                  bool(torch.isinf(kd[2][1::3]).all()) and
                  bool(torch.isinf(kd[1]).all()) == (form != "none"),
                  f"gather_distance {form}: skipped / out-of-range "
                  "lanes wrong")
        args = ops.cuda_args_gather_distance(
            *gather_form(*raw, "compute_bool"))
        rows.append({"M": M, "d": d, "forms": list(GATHER_FORMS),
                     "bit_equal": True, "max_abs_err": 0.0,
                     "ms": cuda_times(
                         lambda: gather_distance_cuda(*args), 50)})
    return rows


PRUNE_FORMS = ("BL", "B", "BWM_view", "BL_expanded", "ed_BWM", "transposed",
               "valid_bool", "valid_uint8")


def prune_form(ed, dcq, b2, valid, form, W=4):
    """(ed, dcq, bound2, valid) in one of the forms ``crouting_prune``
    takes: [B], [B, L] (dense, transposed or a [B] bound expanded over L, as
    the l2 engine hands bound2 over), [B, W, M] (a zero-stride view of a
    [B, W] tensor, as the unfused engine hands dcq over), and bool, int8 or
    uint8 masks."""
    import torch
    B, L = valid.shape
    if form == "B":
        dcq, b2 = dcq[:, 0].contiguous(), b2[:, 0].contiguous()
    elif form == "BWM_view":
        dcq = dcq.reshape(B, W, L // W)[:, :, 0].contiguous()[:, :, None] \
            .expand(B, W, L // W)
        b2 = b2[:, 0].contiguous()[:, None].expand(B, L)
    elif form == "BL_expanded":
        b2 = b2[:, 0].contiguous()[:, None].expand(B, L)
    elif form == "ed_BWM":
        ed = ed.reshape(B, W, L // W)
    elif form == "transposed":
        ed, dcq = ed.t().contiguous().t(), dcq.t().contiguous().t()
    elif form == "valid_bool":
        valid = valid != 0
    elif form == "valid_uint8":
        valid = valid.to(torch.uint8)
    return ed, dcq, b2, valid


# (L, W) of the prune checks: the hnsw and knn searches' unfused tiles and
# a tile of 4 x 71 lanes; the nsg phase adds the tiles its graph gives
# (``nsg_kernel_checks``)
PRUNE_TILES = ((128, 4), (256, 4), (284, 4))


def check_crouting_prune(rng, dev, tiles=PRUNE_TILES):
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.crouting_prune import crouting_prune_cuda
    rows = []
    for L, W in tiles:
        B = 128
        ed = rng.uniform(0, 30, size=(B, L)).astype(np.float32)
        ed[:, ::13] = np.inf                          # adjacency pad slots
        dcq = rng.uniform(5, 30, size=(B, L)).astype(np.float32)
        dcq[3] = 0.0                                  # NaN estimates
        b2 = rng.uniform(10, 900, size=(B, L)).astype(np.float32)
        b2[0] = np.inf                                # never prunes
        b2[1] = 0.0                                   # prunes every valid lane
        valid = (rng.random((B, L)) < 0.8).astype(np.int8)
        raw = [torch.as_tensor(a, device=dev) for a in (ed, dcq, b2, valid)]
        for form in PRUNE_FORMS:
            args = prune_form(*raw, form, W)
            ke, kp = crouting_prune_cuda(*ops.cuda_args_crouting_prune(
                *args, 0.31))
            pe, pp = ref.crouting_prune_ref(*ops.prepare_crouting_prune(
                *args, 0.31))
            torch.cuda.synchronize()
            check(kp.dtype == torch.bool and bit_equal(kp, pp)
                  and bit_equal(ke, pe), f"crouting_prune L={L} W={W} "
                  f"{form}: not bit-equal with the plain version")
            nan = torch.isnan(ke)
            check(not bool(kp[0].any()) and
                  bool(kp[1].eq((raw[3][1] != 0) & ~nan[1]).all()),
                  f"crouting_prune {form}: bound2 = +inf / 0 rows wrong")
        args = ops.cuda_args_crouting_prune(
            *prune_form(*raw, "BWM_view", W), 0.31)
        rows.append({"L": L, "W": W, "forms": list(PRUNE_FORMS),
                     "bit_equal": True,
                     "max_abs_err": 0.0, "pruned": int(kp.sum()),
                     "nan_estimates": int(nan.sum()),
                     "ms": cuda_times(lambda: crouting_prune_cuda(*args),
                                      50)})
    return rows


# the reference sweep (tests/test_kernels.py) plus retrieval_cand and GIST's d
L2_SHAPES = ((8, 16, 32), (70, 130, 96), (128, 256, 128), (33, 257, 200),
             (1, 1_000_000, 128), (33, 257, 960))


# C values whose x[3:] view and unaligned base are checked as well
L2_VIEW_C = (65_537, 131_075)


def l2_stream_shapes():
    """Both sides of the streaming/tiled split (Q in {1, 2, Qs, Qs + 1};
    Qs at a C above and below its threshold) and ragged d (33: unaligned
    rows, tiled; 100: aligned in fp32 only; 960: GIST)."""
    from repro_torch.kernels.l2_distance import STREAM_MAX_Q as QS
    return ((1, 65_537, 128), (2, 65_537, 128), (QS, 131_075, 128),
            (QS + 1, 131_075, 128), (QS, 20_011, 128), (1, 3_001, 33),
            (2, 20_000, 100), (4, 4_099, 960), (QS, 4_099, 960))


def l2_errors(got, exp, d):
    """Max abs error and the worst ratio of |got - exp| to the tolerance
    atol + rtol*|exp| (rtol 1e-4, atol 1e-4*d: the reference sweep's fp32
    tolerance; in l2 mode the error scales with |q|^2 + |x|^2, not with
    the output)."""
    err = (got - exp).abs()
    ratio = err / (1e-4 * d + 1e-4 * exp.abs())
    return float(err.max()), float(ratio.max())


def check_l2_distance(dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2_distance import choose_variant, \
        l2_distance_cuda
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def one(q, x, mode, what):
        got = l2_distance_cuda(q, x, mode)
        exp = ref.l2_distance_ref(q, x, mode)
        torch.cuda.synchronize()
        Q, d = q.shape
        err, ratio = l2_errors(got, exp, d)
        check(got.shape == exp.shape and ratio <= 1.0,
              f"l2_distance {what} Q={Q} C={x.shape[0]} d={d} {q.dtype} "
              f"{mode}: max abs err {err} beyond rtol 1e-4, atol 1e-4*d")
        rows.append({"Q": Q, "C": x.shape[0], "d": d, "dtype": str(q.dtype),
                     "mode": mode, "x": what,
                     "variant": choose_variant(Q, x.shape[0], d,
                                               q.element_size(),
                                               x.data_ptr()),
                     "max_abs_err": err, "err_over_tol": ratio,
                     "ms": cuda_times(lambda: l2_distance_cuda(q, x, mode),
                                      20)})

    for Q, C, d in L2_SHAPES + l2_stream_shapes():
        q32 = torch.randn((Q, d), generator=gen, device=dev)
        x32 = torch.randn((C + 3, d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, xs = q32.to(dtype), x32.to(dtype)
            for mode in ("l2", "ip"):
                one(q, xs[:C].contiguous(), mode, "contiguous")
            if C in L2_VIEW_C:
                # an offset view (x[3:] is contiguous and is not copied) and
                # a base two elements off 16-byte alignment (the tiled kernel)
                one(q, xs[3:], "ip", "view x[3:]")
                flat = xs.reshape(-1)[2:2 + C * d].view(C, d)
                one(q, flat, "l2", "base not 16-byte aligned")
    return rows


# --- segment_sum: the fixed-order sum behind every lookup's gradient --------
# the small tables' vocabularies of dlrm-mlperf (3 to 155 rows; padded to
# /16 as DlrmConfig.table_rows pads them)
SEG_VOCABS = (3, 155)
SEG_BATCHES = (4096, 65536)
SEG_DIMS = (1, 64, 128, 960)
SEG_HOT_ID = 4321          # the skewed cases' hot id


def segment_sum_cases():
    """(what, N, S, id range) of the kernel check: one id repeated 65,536
    times; 3- and 155-row tables at B = 4,096 and 65,536, and a 14-row one
    at 65,536 (runs of ~4,700 rows); empty segments (ids on every third
    segment of 3,000, and a segment count past every id); a GNN
    aggregation's shape (S ~ N ~ 170k, gin-tu at ``minibatch_lg``); a
    skewed list (one id holds half of 65,536 rows, the rest uniform over
    100k ids, as hot ids in real DLRM traffic)."""
    cases = [("one id x 65536", 65536, 1, 1)]
    cases += [(f"{v}-row table, B={b}", b, -(-v // 16) * 16, v)
              for v in SEG_VOCABS for b in SEG_BATCHES]
    cases += [("14-row table, B=65536", 65536, 16, 14),
              ("every third segment of 3000", 4096, 3000, 1000),
              ("segments past every id", 4096, 20000, 500),
              ("gnn-like, S ~ N ~ 170k", 168960, 169984, 169984),
              ("skewed: one id holds half", 65536, 100000, 100000)]
    return cases


def segment_sum_ids(rng, what, N, span):
    """The ids of one ``segment_sum_cases`` case."""
    ids = rng.integers(0, span, N)
    if what.startswith("every third"):
        ids = ids * 3
    if what.startswith("skewed"):
        ids[rng.permutation(N)[: N // 2]] = SEG_HOT_ID
    return ids


def check_segment_sum(dev):
    """The kernel against its plain version on CPU copies, bit for bit, for
    every case of ``segment_sum_cases`` at d in ``SEG_DIMS`` in fp32 and
    bf16; the call given the ids and the call given their runs
    (``segment_sum.runs``) bit-equal; one counted launch a wrapper call."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as K
    rng = np.random.default_rng(7)
    rows = []
    for what, N, S, span in segment_sum_cases():
        ids_c = torch.as_tensor(segment_sum_ids(rng, what, N, span))
        for d in SEG_DIMS:
            base = torch.as_tensor(rng.standard_normal((N, d))
                                   .astype(np.float32))
            for dt in (torch.float32, torch.bfloat16):
                data_c = base.to(dt)
                want = ref.segment_sum_ref(data_c, ids_c, S)
                data, ids_d = data_c.to(dev), ids_c.to(dev)
                runs = K.runs(ids_d, S)
                before = K.LAUNCHES["segment_sum"]
                got = [K.segment_sum(data, ids_d, S),
                       K.segment_sum(data, runs, S)]
                torch.cuda.synchronize()
                launches = K.LAUNCHES["segment_sum"] - before
                same = bit_equal(got[0].cpu(), want)
                check(same and bit_equal(got[0], got[1]) and launches == 2,
                      f"segment_sum {what} d={d} {dt}: plain-equal {same}, "
                      f"repeat {bit_equal(got[0], got[1])}, {launches} "
                      "launches for 2 calls")
                rows.append({"case": what, "N": N, "S": S, "d": d,
                             "dtype": str(dt).removeprefix("torch."),
                             "bit_equal": True, "repeat_bit_equal": True,
                             "launches_a_call": launches / 2})
    return {"cases": len(rows), "all_bit_equal": True,
            "rows": rows[:: len(SEG_DIMS) * 2]}


# --- normalize_rows: a cosine index's query rows, normalised on the card ----
NORM_DIMS = (16, 128, 1536, 1537, 3000)   # 1537 and 3000: two sweeps


def norm_rows(rng, n, d):
    """Rows whose norms span six decades; row 1 is zero."""
    import numpy as np
    import torch
    x = rng.standard_normal((n, d)) * np.logspace(-3, 3, n)[:, None]
    x[1] = 0.0
    return torch.as_tensor(x.astype(np.float32))


def check_normalize_rows(dev):
    """The kernel against its plain version on CPU copies, bit for bit, at
    B = 700 for d in ``NORM_DIMS``; at d 1536, rows of a 10,000-row batch
    equal alone (B = 1), in 7s, in place and off a 16-byte boundary (the
    scalar loads); one counted launch a call."""
    import numpy as np
    import torch
    from repro_torch.kernels import normalize_rows as K
    from repro_torch.kernels import ref
    rng = np.random.default_rng(9)
    rows = []
    for d in NORM_DIMS:
        x = norm_rows(rng, 700, d)
        before = K.LAUNCHES["normalize_rows"]
        got = K.normalize_rows(x.to(dev))
        torch.cuda.synchronize()
        launches = K.LAUNCHES["normalize_rows"] - before
        same = bit_equal(got.cpu(), ref.normalize_rows_ref(x))
        check(same and launches == 1, f"normalize_rows d={d}: plain-equal "
              f"{same}, {launches} launches for 1 call")
        rows.append({"B": 700, "d": d, "bit_equal": True, "launches": 1})
    big = norm_rows(rng, 10_000, 1536).to(dev)
    full = K.normalize_rows(big)
    same_rows = all(bit_equal(K.normalize_rows(big[i:i + b].clone()),
                              full[i:i + b])
                    for i, b in ((0, 1), (4321, 1), (3, 7), (9993, 7)))
    flat = torch.empty(big.numel() + 1, device=dev)
    off = flat[1:].view(big.shape)
    off.copy_(big)
    same_off = bit_equal(K.normalize_rows(off, out=off), full)
    inplace = big.clone()
    same_in = bit_equal(K.normalize_rows(inplace, out=inplace), full)
    torch.cuda.synchronize()
    check(same_rows and same_off and same_in,
          f"normalize_rows at B=10000, d=1536: rows alone equal {same_rows}, "
          f"off 16 bytes {same_off}, in place {same_in}")
    return {"cases": len(rows) + 3, "all_bit_equal": True, "rows": rows}


def nondeterministic_ops(fn):
    """Run ``fn`` once under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the distinct warnings it raised (each names an op
    with no deterministic CUDA implementation), and the mode set back."""
    import warnings
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    return sorted({str(w.message).splitlines()[0][:200] for w in caught
                   if "determinis" in str(w.message)})


# --- phases 3, 4 and 6: the main path on every engine -----------------------
def run_engine(idx, queries, spec):
    import numpy as np
    import torch
    from repro_torch.core.spec import SearchStats
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ids, stats = [], []
    t0_ns = time.perf_counter_ns()
    t0 = time.perf_counter()
    for s in range(0, len(queries), BATCH):
        i, _, st = idx.search(queries[s: s + BATCH], spec)
        ids.append(i)
        stats.append(st)
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return {"ids": np.concatenate(ids), "stats": SearchStats.merge(stats),
            "iters": [int(s.iters) for s in stats], "secs": secs,
            "launches": launches, "graph": graph_engagement(t0_ns),
            "max_memory_allocated": int(torch.cuda.max_memory_allocated())}


def graph_engagement(t0_ns):
    """The hop graph's engagement over the engine calls since ``t0_ns``
    (``trace.calls``): iterations, replays, calls, first uses, and the
    later calls that ran an iteration eagerly (each should replay all)."""
    from repro_torch import trace
    calls = [c for c in trace.calls() if c.start_ns >= t0_ns]
    return {"iters": sum(c.iters for c in calls),
            "graph_iters": sum(c.graph_iters for c in calls),
            "calls": len(calls),
            "first_uses": sum(c.first_use for c in calls),
            "later_calls_not_all_replays": sum(
                not c.first_use and c.graph_iters != c.iters
                for c in calls)}


def expected_kernels(engine, kw):
    """The kernels an (engine, spec) run must launch, and no other: the
    fused engine runs fused_expand on the exact path; the sq8 path runs
    sq8_distance and gather_distance (the reranks) instead; the unfused
    engine adds gather_distance on the exact path and crouting_prune where
    the router's estimate is the kernels' edge-angle form
    (``kernel_estimate``: not ``none``, not ``finger``); every kernel
    engine merges with pool_merge.  The torch engine launches none, and no
    search launches l2_distance."""
    from repro_torch.core.routers import get_router
    if engine == "torch":
        return set()
    sq8 = kw.get("estimate", "exact") in ("sq8", "both")
    want = {"pool_merge"}
    if sq8:
        want |= {"sq8_distance", "gather_distance"}
    elif engine == "fused":
        want.add("fused_expand")
    if engine == "unfused":
        want.add("gather_distance")
        if get_router(kw["router"]).kernel_estimate:
            want.add("crouting_prune")
    return want


def compare_engines(phase, name, kw, runs, gt, nq, main_launches, k=10,
                    n_base=None):
    """Check each kernel engine's run against the torch engine's and its
    launches against ``expected_kernels``; emit one line per spec (with
    dist_calls a query as a share of ``n_base`` where given).  The router's
    own counters (``SearchStats.extra``, finger's ``finger_est_calls``)
    count among the counters that must agree."""
    import numpy as np
    from repro_torch.data.vectors import recall_at_k
    out = {"phase": phase, "spec": name}
    plain = runs["torch"]
    rk = f"recall@{k}"
    for eng, r in runs.items():
        st = r["stats"]
        row = {"qps": nq / r["secs"], "secs": r["secs"],
               rk: recall_at_k(r["ids"], gt, k),
               "iters_per_batch": float(np.mean(r["iters"])),
               "launches": r["launches"], "graph": r["graph"],
               "max_memory_allocated": r["max_memory_allocated"]}
        row.update({c: float(np.mean(getattr(st, c))) for c in COUNTERS})
        row.update({c: float(np.mean(v)) for c, v in st.extra.items()})
        if n_base:
            row["dist_call_share"] = row["dist_calls"] / n_base
        if eng != "torch":
            check(set(st.extra) == set(plain["stats"].extra),
                  f"{phase}/{name}: {eng} router counters "
                  f"{sorted(st.extra)} vs torch {sorted(plain['stats'].extra)}")
            same = np.all(r["ids"] == plain["ids"], axis=1)
            for c in COUNTERS:
                same &= getattr(st, c) == getattr(plain["stats"], c)
            for c, v in st.extra.items():
                same &= v == plain["stats"].extra[c]
            row["agree_share"] = float(same.mean())
        out[eng] = row
    emit(out)
    ref = out["torch"]
    for eng, r in runs.items():
        g = r["graph"]
        check(g["calls"] == len(r["iters"])
              and g["later_calls_not_all_replays"] == 0,
              f"{phase}/{name}: the {eng} engine's hop graph: {g}")
        got = {k for k, v in r["launches"].items() if v > 0}
        want = expected_kernels(eng, kw)
        check(got == want, f"{phase}/{name}: the {eng} engine launched "
              f"{sorted(got)}, expected {sorted(want)}")
        if eng == "torch":
            continue
        for k, v in r["launches"].items():
            main_launches[k] = main_launches.get(k, 0) + v
        row = out[eng]
        check(row["agree_share"] >= 0.99, f"{phase}/{name}: {eng} and torch "
              f"agree on {row['agree_share']:.4f} of queries (< 0.99)")
        rel = abs(row["dist_calls"] - ref["dist_calls"]) / max(
            ref["dist_calls"], 1e-9)
        check(rel <= 0.005, f"{phase}/{name}: {eng} mean dist_calls differ "
              f"by {rel:.4%}")
        check(abs(row[rk] - ref[rk]) <= 0.005,
              f"{phase}/{name}: {eng} recall {row[rk]} vs torch {ref[rk]}")


def search_phase(phase, idx, queries, gt, main_launches, captures=None,
                 specs=SPECS, unfused_specs=UNFUSED_SPECS, k=10):
    """Every spec of ``specs`` on its engines; ``captures`` maps (spec,
    engine) to a CaptureInputs run around an eager pass of its first
    batch, before the counted run."""
    import dataclasses
    from repro_torch.core.search import build_search_fn
    from repro_torch.core.spec import SearchSpec
    for name, kw in specs.items():
        engines = ["fused"] + (["unfused"] if name in unfused_specs else [])
        runs = {}
        for engine in engines + ["torch"]:
            spec = SearchSpec(engine=engine, **kw)
            # copy the graph (and its SQ8 tables) to the card before the
            # clock starts, under the spec AnnIndex.search will resolve
            build_search_fn(idx.graph, dataclasses.replace(
                spec, efs=max(spec.efs, spec.k), metric=idx.graph.metric,
                use_hierarchy=idx.graph.upper_neighbors is not None),
                device=idx.device)
            capture = (captures or {}).get((name, engine))
            if capture is not None:
                with capture, eager_twin(kw) as twin:
                    idx.search(queries[:BATCH],
                               SearchSpec(engine=engine, **twin))
            runs[engine] = run_engine(idx, queries, spec)
        compare_engines(phase, name, kw, runs, gt, len(queries),
                        main_launches, k=k, n_base=idx.graph.n)


# --- phases 4 and 5: NSG construction and searches, the router sweep --------
class PoolRecorder:
    """Record the candidate pools the NSG build hands its MRNG selection
    for a set of nodes: ``core.nsg.candidate_pool`` wrapped for the
    duration of a ``with`` block."""

    def __init__(self, nodes):
        self.nodes = {int(p) for p in nodes}
        self.pools = {}

    def __enter__(self):
        from repro_torch.core import nsg as N
        self._orig = N.candidate_pool

        def f(p, *a, **kw):
            out = self._orig(p, *a, **kw)
            if int(p) in self.nodes:
                self.pools[int(p)] = out
            return out
        N.candidate_pool = f
        return self

    def __exit__(self, *exc):
        from repro_torch.core import nsg as N
        N.candidate_pool = self._orig
        return False


def mrng_check(g, pools):
    """The built graph's rows against the NumPy copy of the reference's
    MRNG loop (``_mrng_select``) on the candidate pools the build handed
    its tensor MRNG (``pools``, recorded by ``PoolRecorder``): each sampled
    row's leading entries (the spanning tree appends its edges after them)
    must be the loop's kept ids.  Returns the share of equal rows and, for
    each differing row, the first pool position where the two differ with
    its margin: the least |pw - rank| over the loop's kept candidates
    before it (a comparison that close can flip with the fp32 product's
    rounding)."""
    import numpy as np
    from repro_torch.core import distances as D
    from repro_torch.core import nsg as N
    differ, kept = [], []
    for p, (cids, crank) in sorted(pools.items()):
        want, _ = N._mrng_select(p, cids, crank, g.vectors, g.metric,
                                 NSG_KW["r"])
        kept.append(len(want))
        got = g.neighbors[p][: len(want)]
        if np.array_equal(got, want):
            continue
        pos = next((j for j in range(len(cids))
                    if (cids[j] in got) != (cids[j] in want)), None)
        before = [] if pos is None else [j for j in range(pos)
                                         if cids[j] in want]
        margin = None
        if before:
            cv = g.vectors[cids]
            pw = D.pairwise_np(cv[pos: pos + 1], cv[before], g.metric)[0]
            margin = float(np.abs(pw - crank[pos]).min())
        differ.append({"node": int(p), "position": pos, "margin": margin})
    return {"nodes": len(pools),
            "pool_width": max(len(c) for c, _ in pools.values()),
            "equal_share": 1.0 - len(differ) / len(pools),
            "kept_mean": float(np.mean(kept)), "differing": differ}


def nsg_kernel_checks(rng, dev, M, acq_M, d):
    """The kernel checks at the shapes the NSG graph gives the kernels
    (its padded degree ``M``): the searches' tiles W*M at W = 4 and 1
    (fused_expand, sq8_distance, gather_distance, crouting_prune) and their
    merges into the efs pool, and the build's acquisition on the K-NN graph
    (degree ``acq_M``): fused_expand at B = 512, W = 4 and the block
    variant of pool_merge at P = C."""
    efs = SPECS["W4"]["efs"]
    tiles = ((4 * M, 4), (M, 1))
    acq_L = 4 * acq_M
    return {"M": M, "acquisition_M": acq_M,
            "fused_expand": check_fused_expand(
                rng, dev, [(128, L, d, W) for L, W in tiles]
                + [(512, acq_L, d, 4)]),
            "sq8_distance": check_sq8_distance(
                rng, dev, [(128, L, d) for L, _ in tiles]),
            "gather_distance": check_gather_distance(
                rng, dev, [(L, d) for L, _ in tiles]),
            "crouting_prune": check_crouting_prune(rng, dev, tiles),
            "pool_merge": check_pool_merge(
                rng, dev, [(128, efs, L) for L, _ in tiles]
                + [(512, NSG_KW["c"], acq_L)])}


# the kernel each captured wrapper launches
KERNEL_OF = {"fused_expand": "fused_expand", "pool_merge": "pool_merge",
             "sq8_estimate": "sq8_distance",
             "gather_distance_where": "gather_distance",
             "crouting_prune": "crouting_prune"}


def captured_equal(capture):
    """Each kernel against its plain version, bit for bit, on the inputs a
    main-path run handed its wrapper (``CaptureInputs``: one call per
    wrapper and lane width).  Returns the checked kernels and shapes."""
    from repro_torch.kernels import crouting_prune as CP
    from repro_torch.kernels import fused_expand as FE
    from repro_torch.kernels import gather_distance as GD
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sq8_distance as SK
    from repro_torch.kernels.pool_merge import pool_merge_cuda
    done = []
    for (name, width), (a, kw) in sorted(capture.args.items()):
        if name == "fused_expand":
            got = FE.fused_expand_cuda(*ops.cuda_args_fused_expand(*a, **kw))
            want = ref.fused_expand_ref(*ops.prepare_fused_expand(*a, **kw))
        elif name == "pool_merge":
            margs = (a[0].float().contiguous(), a[1].int().contiguous(),
                     a[2].float().contiguous(), a[3].int().contiguous())
            got, want = pool_merge_cuda(*margs), ref.pool_merge_ref(*margs)
        elif name == "sq8_estimate":
            got = SK.sq8_distance_cuda(*ops.cuda_args_sq8_estimate(*a, **kw))
            want = ref.sq8_estimate_ref(*ops.prepare_sq8_estimate(*a, **kw))
        elif name == "gather_distance_where":
            ids, compute, q, table = a
            got = (GD.gather_distance_cuda(*ops.cuda_args_gather_distance(
                ids, q, table, compute, True)),)
            want = (gather_plain(ids, q, table, compute, True),)
        else:
            got = CP.crouting_prune_cuda(*ops.cuda_args_crouting_prune(
                *a, **kw))
            want = ref.crouting_prune_ref(*ops.prepare_crouting_prune(
                *a, **kw))
        shape = [list(a[0].shape)] + ([list(a[2].shape)]
                                      if name == "pool_merge" else [])
        check(all(bit_equal(x, y) for x, y in zip(got, want)),
              f"{name} {shape}: not bit-equal with the plain version on "
              "captured inputs")
        done.append({"kernel": KERNEL_OF[name], "shape": shape})
    return done


def nsg_phase(ds, gt, main_launches, capture, rng):
    """NSG at the paper's widths on the hnsw phase's data through
    ``AnnIndex.build(graph="nsg")`` on the card (``capture`` around it:
    the acquisition's kernel inputs for the timing phase), the built rows
    against the NumPy MRNG loop, the kernels at the shapes the graph gives
    them, every spec on every engine with each kernel held bit for bit
    against its plain version on the inputs the searches handed it, and a
    save/load round trip searched again."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.core.nsg import acquire_candidates, acquisition_spec
    from repro_torch.core.spec import SearchSpec
    from repro_torch.kernels import ops
    sample = np.random.default_rng(7).choice(len(ds.base), MRNG_SAMPLE,
                                             replace=False)
    # the acquisition's kernel inputs: its first batch searched eagerly on
    # the build's own K-NN graph, under the build's spec and pool
    knn = build_knn_graph(ds.base, k=NSG_KW["knn_k"], metric="l2")
    pool = max(NSG_KW["l"], min(NSG_KW["c"], knn.n - 1))
    with capture, eager_twin(dict(router="none", beam_width=4)) as twin:
        acquire_candidates(knn, ds.base[:NSG_ACQUIRE_BATCH], acquisition_spec(
            SearchSpec(**twin), pool, "l2"), NSG_ACQUIRE_BATCH)
    del knn
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0_ns = time.perf_counter_ns()
    t0 = time.perf_counter()
    with PoolRecorder(sample) as pools:
        idx = AnnIndex.build(ds.base, graph="nsg", **NSG_KW)
    torch.cuda.synchronize()
    build_secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    graph = graph_engagement(t0_ns)
    got = {k for k, v in launches.items() if v}
    check(got == {"fused_expand", "pool_merge"},
          f"nsg: the build launched {launches}")
    check(graph["calls"] == -(-len(ds.base) // NSG_ACQUIRE_BATCH)
          and graph["later_calls_not_all_replays"] == 0,
          f"nsg: the acquisition's hop graph: {graph}")
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v
    g = idx.graph
    deg = (g.neighbors < g.n).sum(1)
    st = g.build_stats
    check(len(pools.pools) == MRNG_SAMPLE,
          f"nsg: {len(pools.pools)} sampled pools recorded")
    mrng = mrng_check(g, pools.pools)
    emit({"phase": "nsg", "part": "build", "n": g.n, "dim": g.dim,
          **NSG_KW, "acquisition": "W=4, router none, engine fused, "
                                   "batches of 512",
          "build_secs": build_secs,
          "step_secs": {k: st[f"{k}_secs"] for k in
                        ("knn", "acquire", "mrng", "tree")},
          "orphans": st["orphans"], "max_degree": int(deg.max()),
          "mean_degree": float(deg.mean()), "padded_degree": g.max_degree,
          "build_launches": launches, "build_graph": graph,
          "theta_star": idx.profile.theta_star, "mrng": mrng,
          "cuts": "n 1M (the paper's SIFT) -> 30k (50k until the lm "
                  "phase came), the hnsw phase's dataset, so both graphs "
                  "answer the same queries; "
                  "R, C, L, knn_k and d at the paper's widths"})
    check(mrng["equal_share"] >= 0.999,
          f"nsg: the built rows equal the NumPy MRNG loop on only "
          f"{mrng['equal_share']:.4f} of {mrng['nodes']} rows")
    emit({"phase": "nsg", "part": "kernels", **nsg_kernel_checks(
        rng, idx.device, g.max_degree, NSG_KW["knn_k"], g.dim)})
    specs = {**SPECS, **FINGER_SPECS}
    captures = {(name, engine): CaptureInputs() for name in specs
                for engine in ("fused", "unfused")}
    search_phase("nsg", idx, ds.queries, gt, main_launches,
                 captures=captures, specs=specs, unfused_specs=tuple(specs))
    checked = {}
    for (name, engine), c in captures.items():
        checked[f"{name}/{engine}"] = done = captured_equal(c)
        want = expected_kernels(engine, specs[name])
        check({x["kernel"] for x in done} == want,
              f"nsg {name}/{engine}: captured {done}, the run launches "
              f"{sorted(want)}")
    emit({"phase": "nsg", "part": "captured_kernels", "checked": checked})
    del captures

    # save, load on the card, search W4 again: ids and counters unchanged
    spec = SearchSpec(**SPECS["W4"])
    first = run_engine(idx, ds.queries, spec)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nsg.npz")
        t0 = time.perf_counter()
        idx.save(path)
        save_secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = AnnIndex.load(path)
        load_secs = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
    again = run_engine(back, ds.queries, spec)
    for k, v in again["launches"].items():
        main_launches[k] = main_launches.get(k, 0) + v
    same = bool(np.array_equal(first["ids"], again["ids"])) and all(
        np.array_equal(getattr(first["stats"], c), getattr(again["stats"], c))
        for c in COUNTERS)
    emit({"phase": "nsg", "part": "save_load", "bytes": nbytes,
          "save_secs": save_secs, "load_secs": load_secs,
          "device": str(back.device), "ids_and_counters_equal": same})
    check(same and back.device.type == "cuda",
          "nsg: the loaded index searched differently on the card")
    return idx


# --- phases 3b and 4b: serving and live mutation ------------------------------
SERVE_BUCKETS = (1, 8, 32, 128)
# the serve phase's sessions: (SPECS name, engine)
SERVE_SESSIONS = (("W4", "fused"), ("W4_both", "fused"), ("W4", "unfused"))
K_MIX = (1, 5, 10)
# the mutate phase: fresh rows inserted in chunks, uniform deletes
INSERT_ROWS, INSERT_CHUNK, DELETES, DELTA_CAPACITY = 1024, 64, 512, 1024
# the mutate phase's base: the first rows of the nsg phase's data (its NSG
# merge and the static rebuild run at this size)
MUTATE_BASE = 10_000
# requests the mutate phase keeps in flight, back to back, across the
# merge and after it (the serve phase's 4 submitting threads)
IN_FLIGHT = 4
# requests served after the swap at that load: latency without a merge
AFTER_MERGE = 32
CHAOS_SITES = ("wal.append", "wal.fsync", "wal.rotate", "checkpoint.write",
               "manifest.rename")


def ragged_stream(n_queries, seed, top=SERVE_BUCKETS[-1]):
    """A seeded ragged request stream: (lo, hi, k) spans covering
    ``n_queries`` rows, 1..``top`` rows a request, k from ``K_MIX``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out, lo = [], 0
    while lo < n_queries:
        n = int(min(rng.integers(1, top + 1), n_queries - lo))
        out.append((lo, lo + n, int(rng.choice(K_MIX))))
        lo += n
    return out


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def record_dispatches(fe, sessions, records):
    """Wrap the frontend's session of each ``sessions`` entry ("name/engine"
    -> SearchSpec) so that every dispatch appends ("name/engine", the
    kernels it launched) to ``records``.  It reads the calling thread's
    own launches (``ops.thread_launch_counts``), so a merge thread's
    launches beside it do not count."""
    from repro_torch.kernels import ops
    for key, spec in sessions.items():
        sess = fe._session(spec)
        orig = sess.engine.search_padded

        def wrapped(*a, _orig=orig, _key=key):
            before = ops.thread_launch_counts()
            out = _orig(*a)
            after = ops.thread_launch_counts()
            records.append((_key, {k for k in after
                                   if after[k] > before[k]}))
            return out
        sess.engine.search_padded = wrapped


def check_dispatch_kernels(phase, records):
    """Each dispatch launched exactly the kernel set of its session's
    (engine, spec) (``expected_kernels``); returns the dispatches by
    session."""
    counts = {}
    for key, got in records:
        name, engine = key.split("/")
        want = expected_kernels(engine, SPECS[name])
        check(got == want, f"{phase}: a {key} dispatch launched "
              f"{sorted(got)}, expected {sorted(want)}")
        counts[key] = counts.get(key, 0) + 1
    return counts


def same_result(a, b):
    """(ids, dists, stats) of a served request against a direct search of
    its rows: ids, dists and every per-query counter equal (``iters`` is a
    batch count and is left out)."""
    import numpy as np
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        return False
    sa, sb = a[2], b[2]
    return (all(np.array_equal(getattr(sa, c), getattr(sb, c))
                for c in COUNTERS) and set(sa.extra) == set(sb.extra)
            and all(np.array_equal(sa.extra[c], sb.extra[c])
                    for c in sa.extra))


def serve_digest(summ):
    """The serving line's numbers from a telemetry summary."""
    return {"latency": summ["latency"], "queue_wait": summ["queue_wait"],
            "qps": summ["qps"], "requests": summ["requests"],
            "recompiles_after_warmup": summ["recompiles_after_warmup"],
            "buckets": {b: {k: v for k, v in r.items()
                            if k in ("dispatches", "compiles", "rows",
                                     "pad_overhead", "p50_ms", "p99_ms")}
                        for b, r in summ["buckets"].items()}}


def serve_phase(idx, queries, main_launches):
    """The serving frontend on the hnsw index: a ladder of (1, 8, 32, 128)
    warmed for three sessions, a seeded ragged stream over every query
    (1..128 rows a request, k mixed over 1, 5, 10) driven through
    ``flush()``, then the worker thread serving the same stream from 4
    submitting threads.  Each request equals a direct ``idx.search`` of its
    rows, no request pays a first-use event after warmup, each dispatch
    launches exactly its session's kernels, every future resolves, and an
    armed ``serve.dispatch`` fault fails only its own batch."""
    import threading
    from repro_torch import fault
    from repro_torch.core.spec import SearchSpec
    from repro_torch.fault import RetryPolicy
    from repro_torch.kernels import ops
    from repro_torch.serve import QueueFull, ServeFrontend
    dev = idx.device
    specs = {f"{n}/{e}": SearchSpec(engine=e, **SPECS[n])
             for n, e in SERVE_SESSIONS}
    base = specs["W4/fused"]
    t0 = time.perf_counter()
    fe = ServeFrontend(idx, base, buckets=SERVE_BUCKETS)
    for spec in list(specs.values())[1:] + [base]:
        fe.activate_spec(spec)                 # warm every session's rungs
    warm_secs = time.perf_counter() - t0
    check(fe.active_spec.canonical() == fe._session(base).spec.canonical(),
          "serve: the base session is not active after warmup")
    warm = {key: fe._session(s).engine.compile_count()
            for key, s in specs.items()}
    records = []
    record_dispatches(fe, specs, records)
    stream = ragged_stream(len(queries), seed=11)

    # 1) every session's stream through flush(), counts from 0
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    futs = {}
    for key, spec in specs.items():
        for i, (lo, hi, k) in enumerate(stream):
            futs[key, i] = fe.submit(queries[lo:hi], spec=spec, k=k)
            if i % 3 == 2:
                fe.flush()
        fe.flush()
    flushed = {kk: f.result(timeout=600) for kk, f in futs.items()}
    sync(dev)
    flush_secs = time.perf_counter() - t0
    launches = {"flush": dict(ops.LAUNCHES)}
    flush_summary = serve_digest(fe.telemetry.summary())
    flush_dispatches = check_dispatch_kernels("serve", records)
    records.clear()

    # 2) a serve.dispatch fault fails its own batch only: three requests
    # in three cos_theta groups make three dispatches, the second faulted;
    # on the card each cos_theta the bucket has not run captures its hop
    # graph on the request path, a first use
    ops.reset_launch_counts()
    before_fault = {key: fe._session(s).engine.compile_count()
                    for key, s in specs.items()}
    fault_futs = [fe.submit(queries[:3], cos_theta=ct)
                  for ct in (0.9, 0.8, 0.7)]
    fault.arm("serve.dispatch", kind="raise", hits={1})
    try:
        n_fault_dispatches = fe.flush()
    finally:
        fault.disarm()
    outcome = []
    for f in fault_futs:
        try:
            f.result(timeout=600)
            outcome.append("ok")
        except fault.FaultInjected:
            outcome.append("fault")
    check(n_fault_dispatches == 3 and outcome == ["ok", "fault", "ok"],
          f"serve: the armed dispatch fault gave {outcome} over "
          f"{n_fault_dispatches} dispatches")
    fault_uses = {key: fe._session(s).engine.compile_count()
                  - before_fault[key] for key, s in specs.items()}
    check(fault_uses == {key: 2 if s is base else 0
                         for key, s in specs.items()},
          f"serve: the two cos_theta values searched made {fault_uses} "
          "first uses (one capture each, in the active session)")
    records.clear()
    sync(dev)
    launches["dispatch_fault"] = dict(ops.LAUNCHES)

    # 3) the worker thread, 4 threads submitting the same stream; a full
    # queue (QueueFull) is retried under a seeded backoff
    ops.reset_launch_counts()
    snap0 = fe.telemetry.window_snapshot()
    fe.start(poll_s=0.001)
    worker_futs, errors = {}, []

    def submit(w):
        backoff = RetryPolicy(max_attempts=1000, base_s=0.002, cap_s=0.05,
                              seed=w)
        try:
            for i in range(w, len(stream), 4):
                lo, hi, k = stream[i]
                for key, spec in specs.items():
                    worker_futs[key, i] = backoff.call(
                        fe.submit, queries[lo:hi], spec=spec, k=k,
                        retry_on=QueueFull)
        except Exception as e:   # noqa: BLE001 — checked on the main thread
            errors.append(repr(e))

    threads = [threading.Thread(target=submit, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        check(not th.is_alive(), "serve: a submitting thread hung")
    check(not errors, f"serve: submitting threads failed: {errors}")
    served = {kk: f.result(timeout=600) for kk, f in worker_futs.items()}
    fe.stop()
    sync(dev)
    launches["worker"] = dict(ops.LAUNCHES)
    for part in launches.values():
        for k, v in part.items():
            main_launches[k] = main_launches.get(k, 0) + v
    worker = fe.telemetry.window_delta(snap0, fe.telemetry.window_snapshot())
    worker_dispatches = check_dispatch_kernels("serve", records)

    after = {key: fe._session(s).engine.compile_count()
             for key, s in specs.items()}
    summ = fe.telemetry.summary()
    # every request against a direct search of its own rows (whose odd
    # batch shapes are first uses of the same engines: after the reads)
    direct = {(key, i): idx.search(queries[lo:hi], spec.replace(k=k))
              for key, spec in specs.items()
              for i, (lo, hi, k) in enumerate(stream)}
    bad_flush = [kk for kk in direct if not same_result(flushed[kk],
                                                        direct[kk])]
    bad_worker = [kk for kk in direct if not same_result(served[kk],
                                                         direct[kk])]
    emit({"phase": "serve", "n": idx.graph.n, "dim": idx.graph.dim,
          "buckets": list(SERVE_BUCKETS), "requests": len(stream),
          "rows": len(queries), "k_mix": list(K_MIX),
          "sessions": list(specs), "warmup_secs": warm_secs,
          "first_uses_at_warmup": warm, "first_uses_after": after,
          "flush": {"secs": flush_secs, "dispatches": flush_dispatches,
                    **flush_summary},
          "worker": {"submitting_threads": 4, "dispatches": worker_dispatches,
                     **worker},
          "launches": launches, "dispatch_fault": outcome,
          "requests_unequal_to_direct": {"flush": bad_flush[:5],
                                         "worker": bad_worker[:5]},
          "recompiles_after_warmup": summ["recompiles_after_warmup"],
          "dispatch_fault_first_uses": fault_uses})
    check(not bad_flush and not bad_worker,
          f"serve: {len(bad_flush)} flushed and {len(bad_worker)} worker "
          "requests differ from a direct search of their rows")
    # the ragged streams pay none: the only first uses after warmup are
    # the fault part's two captures
    check(summ["recompiles_after_warmup"] == sum(fault_uses.values())
          and all(after[key] - fault_uses[key] == warm[key] for key in warm),
          f"serve: first uses on the request path ({warm} -> {after}, "
          f"{fault_uses} of them the fault part's)")
    check(summ["requests"]["served"] == 2 * len(direct) + 2
          and summ["requests"]["failed"] == 1, f"serve: {summ['requests']}")


def fresh_rows(dim):
    """``INSERT_ROWS`` rows from the hnsw phase's mixture: the same
    centers (seed 0), drawn apart from its base rows."""
    from repro_torch.data.vectors import make_dataset
    return make_dataset(n_base=INSERT_ROWS, n_query=1, dim=dim,
                        n_clusters=64, seed=0).base


def search_all(mi, queries, spec):
    """``mi.search`` over ``queries`` in batches of ``BATCH``; returns
    (ids, dists, merged stats)."""
    import numpy as np
    from repro_torch.core.spec import SearchStats
    outs = [mi.search(queries[s: s + BATCH], spec)
            for s in range(0, len(queries), BATCH)]
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]),
            SearchStats.merge([o[2] for o in outs]))


def mutate_traffic(mi, fe, queries, fresh, rng, started, merging, wait):
    """Ragged requests through the worker thread, interleaved with inserts
    of ``fresh`` in chunks and uniform deletes, then served back to back
    with ``IN_FLIGHT`` requests in flight until a background merge has
    completed, and ``AFTER_MERGE`` more at that load.  ``started()``,
    ``merging()`` and ``wait()`` read and join the index's background
    merge.  Returns (futures with their submit time and the ids deleted
    before it, done times, the external ids and live mask of base + fresh
    rows, the merge's window)."""
    from collections import deque
    import numpy as np
    from repro_torch.fault import RetryPolicy
    from repro_torch.serve import QueueFull
    backoff = RetryPolicy(max_attempts=1000, base_s=0.002, cap_s=0.05,
                          seed=0)
    n0 = mi.n_live
    live = np.zeros(n0 + len(fresh), bool)
    live[:n0] = True
    dead, futs, done = set(), [], {}
    sizes = ragged_stream(10 ** 6, seed=13)     # an endless seeded stream

    def submit():
        lo, hi, k = sizes[len(futs)]
        rows = rng.integers(0, len(queries), hi - lo)
        # backpressure (QueueFull) is retried under a seeded backoff
        fut = backoff.call(fe.submit, queries[rows], k=k, retry_on=QueueFull)
        i = len(futs)
        fut.add_done_callback(lambda f, i=i: done.setdefault(
            i, time.perf_counter()))
        futs.append((fut, time.perf_counter(), sorted(dead)))

    def serve(more):
        """Keep ``IN_FLIGHT`` requests in flight while ``more()``."""
        pending = deque()
        while more():
            while len(pending) < IN_FLIGHT:
                submit()
                pending.append(futs[-1][0])
            pending.popleft().result(timeout=600)
        for f in pending:
            f.result(timeout=600)

    window = [None, None]
    chunks = INSERT_ROWS // INSERT_CHUNK
    for step in range(chunks):
        submit()
        submit()
        ids = mi.insert(fresh[step * INSERT_CHUNK:(step + 1) * INSERT_CHUNK])
        live[ids] = True
        kill = rng.choice(np.flatnonzero(live), DELETES // chunks,
                          replace=False)
        mi.delete(kill)
        live[kill] = False
        dead.update(int(x) for x in kill)
        if window[0] is None and started():
            window[0] = time.perf_counter()
    check(window[0] is not None, "mutate: no background merge started")
    # then the same load until the merge has swapped in, and after it:
    # latency beside the merge against latency without it
    serve(merging)
    window[1] = time.perf_counter()
    wait()
    n = len(futs)
    serve(lambda: len(futs) < n + AFTER_MERGE)
    return futs, done, live, window


def mutate_phase(ds, main_launches):
    """Live mutation on an NSG at the nsg phase's widths over the first
    ``MUTATE_BASE`` rows of its data, behind the serving frontend, with a
    durable directory: ragged requests while 1,024 fresh rows are
    inserted in chunks of 64 and 512 ids deleted, served across a
    background NSG merge (built on the card, its acquisition through
    fused_expand and pool_merge).  Checks: no deleted id returned, no
    first use on the request path across the swap, recall@10 >= 0.95 x a
    static NSG rebuild's over the final live rows, fused and torch equal
    after the merge.  Then ingest rows/s per fsync policy and the
    kill-at-every-site sweep: each crash recovered on the card, no acked
    mutation lost, no delete resurrected, searches equal to an index that
    never crashed."""
    import os
    import tempfile
    import numpy as np
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import (VectorDataset, exact_ground_truth,
                                          recall_at_k)
    from repro_torch.kernels import ops
    from repro_torch.mutate import MutableAnnIndex, MutateConfig
    from repro_torch.serve import ServeFrontend
    t0 = time.perf_counter()
    nsg_idx = AnnIndex.build(ds.base[:MUTATE_BASE], graph="nsg", **NSG_KW)
    base_secs = time.perf_counter() - t0
    dev = nsg_idx.device
    spec = SearchSpec(**SPECS["W4"])
    cfg = MutateConfig(graph="nsg", graph_kw=dict(NSG_KW),
                       delta_capacity=DELTA_CAPACITY,
                       auto_merge="background", wal_fsync="every")
    fresh = fresh_rows(ds.base.shape[1])
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mutate_") as tmp:
        t0 = time.perf_counter()
        mi = MutableAnnIndex(nsg_idx, config=cfg, spec=spec,
                             durable_dir=os.path.join(tmp, "live"))
        create_secs = time.perf_counter() - t0
        durable_fs = fs_type(tmp)
        fe = ServeFrontend(mi, spec, buckets=SERVE_BUCKETS)
        warm = mi.compile_count()
        records = []
        record_dispatches(fe, {"W4/fused": spec}, records)
        sync(dev)
        ops.reset_launch_counts()
        fe.start(poll_s=0.001)
        t0 = time.perf_counter()
        futs, done, live, window = mutate_traffic(
            mi, fe, ds.queries, fresh, rng,
            started=lambda: mi._merge_thread is not None,
            merging=lambda: (mi.merges_completed == 0
                             and mi._merge_thread.is_alive()),
            wait=mi.wait_for_merge)
        fe.stop()
        results = [f.result(timeout=600) for f, _, _ in futs]
        sync(dev)
        traffic_secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        dispatches = check_dispatch_kernels("mutate", records)
        leaks = sum(int(np.isin(r[0], d).sum())
                    for r, (_, _, d) in zip(results, futs))
        in_merge = [i for i, (_, t_sub, _) in enumerate(futs)
                    if t_sub < window[1] and done[i] > window[0]]
        lat = np.asarray([done[i] - t for i, (_, t, _) in enumerate(futs)])
        during = np.zeros(len(futs), bool)
        during[in_merge] = True
        summ = fe.telemetry.summary()
        first_uses_after = mi.compile_count()
        merge = dict(mi.last_merge)

        # final state: recall against a static rebuild over the live rows
        all_rows = np.concatenate([ds.base[:MUTATE_BASE], fresh])
        ext_of_row = np.flatnonzero(live)
        check(np.array_equal(mi.live_ids(), ext_of_row),
              "mutate: the index's live ids differ from the trace's")
        gt_rows = exact_ground_truth(VectorDataset(
            "live", all_rows[live], ds.queries), k=10, device=dev)
        gt = ext_of_row[gt_rows]
        fused = search_all(mi, ds.queries, spec)
        plain = search_all(mi, ds.queries, spec.replace(engine="torch"))
        t0 = time.perf_counter()
        static = AnnIndex.build(all_rows[live], graph="nsg", device=dev,
                                **NSG_KW)
        static_secs = time.perf_counter() - t0
        s_rows = np.concatenate([static.search(ds.queries[s: s + BATCH],
                                               spec)[0]
                                 for s in range(0, len(ds.queries), BATCH)])
        s_ids = np.where(s_rows >= 0, ext_of_row[np.maximum(s_rows, 0)], -1)
        recall_mut = recall_at_k(fused[0], gt, 10)
        recall_static = recall_at_k(s_ids, gt, 10)
        del static
        equal_engines = bool(np.array_equal(fused[0], plain[0])) and all(
            np.array_equal(getattr(fused[2], c), getattr(plain[2], c))
            for c in COUNTERS)
        ingest = ingest_rates(mi._state.snapshot.index, fresh, tmp)
        # again in the checkout, which may sit on a disk where the temp
        # directory is a tmpfs
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_ingest_",
                                         dir=ROOT) as local:
            ingest_checkout = ingest_rates(mi._state.snapshot.index, fresh,
                                           local)
        sweep = crash_sweep(mi._state.snapshot.index, fresh, ds.queries,
                            spec, tmp)
        mi.close()
    pct = {}
    for name, sel in (("during_merge", during), ("outside_merge", ~during)):
        ms = lat[sel] * 1e3
        pct[name] = ({"requests": int(sel.sum()),
                      "p50_ms": float(np.percentile(ms, 50)),
                      "p99_ms": float(np.percentile(ms, 99))}
                     if sel.any() else {"requests": 0})
    emit({"phase": "mutate", "n_start": nsg_idx.graph.n,
          "base_build_secs": base_secs,
          "inserted": INSERT_ROWS, "insert_chunk": INSERT_CHUNK,
          "deleted": DELETES, "n_live": int(live.sum()),
          **NSG_KW, "delta_capacity": DELTA_CAPACITY,
          "wal_fsync": "every", "durable_fs": durable_fs,
          "durable_create_secs": create_secs,
          "traffic_secs": traffic_secs, "requests": len(futs),
          "in_flight": IN_FLIGHT, "after_merge": AFTER_MERGE,
          "requests_completed_in_merge": len(in_merge),
          "merge_window_secs": window[1] - window[0],
          "latency_by_merge": pct, "merges": mi.merges_completed,
          "epoch": mi.epoch, "merge": merge, "dispatches": dispatches,
          "deleted_leaks": leaks,
          "recompiles_after_warmup": summ["recompiles_after_warmup"],
          "first_uses_warm": warm, "first_uses_after": first_uses_after,
          "serve": serve_digest(summ), "launches": launches,
          "recall_at_10": recall_mut, "recall_static_rebuild": recall_static,
          "recall_ratio": recall_mut / max(recall_static, 1e-9),
          "static_rebuild_secs": static_secs,
          "fused_equals_torch": equal_engines, "ingest": ingest,
          "ingest_in_checkout": ingest_checkout,
          "crash_sweep": sweep,
          "cuts": "n 1M (the paper's SIFT) -> 10k, the first 10k rows of "
                  "the nsg phase's 30k (at 50k the merge beside live "
                  "traffic took 168 s and the script ran past 15 minutes; "
                  "20k until the lm phase came); "
                  "R, C, L, knn_k and d at the paper's widths"})
    check(mi.merges_completed >= 1 and in_merge,
          "mutate: no background merge completed with requests in flight")
    check(set(merge["build_launches"]) == {"fused_expand", "pool_merge"},
          f"mutate: the merge's NSG build launched {merge['build_launches']}")
    check(leaks == 0, f"mutate: {leaks} results held deleted ids")
    check(summ["recompiles_after_warmup"] == 0 and first_uses_after == warm,
          f"mutate: first uses on the request path across the swap "
          f"({warm} -> {first_uses_after})")
    check(recall_mut >= 0.95 * recall_static,
          f"mutate: recall@10 {recall_mut} < 0.95 x the static rebuild's "
          f"{recall_static}")
    check(equal_engines, "mutate: fused and torch differ after the merge")


def fs_type(path):
    """The filesystem type of the mount that holds ``path`` (from
    /proc/mounts; ``None`` where that cannot be read)."""
    import os
    path = os.path.realpath(path)
    best, kind = "", None
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt = parts[1].replace("\\040", " ")
                under = path == mnt or path.startswith(mnt.rstrip("/") + "/")
                if under and len(mnt) >= len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        return None
    return kind


def ingest_rates(index, fresh, tmp):
    """Rows/s of acked inserts (chunks of ``INSERT_CHUNK``) into a durable
    index for each fsync policy, in ``tmp``; the rates say what an fsync
    costs only where ``tmp`` is on a disk (its ``fs`` is printed)."""
    import os
    import shutil
    from repro_torch.mutate import MutableAnnIndex, MutateConfig
    out = {"fs": fs_type(tmp)}
    for policy in ("every", "interval", "off"):
        d = os.path.join(tmp, f"ingest-{policy}")
        mi = MutableAnnIndex(index, config=MutateConfig(
            graph="nsg", graph_kw=dict(NSG_KW), delta_capacity=INSERT_ROWS,
            auto_merge="off", wal_fsync=policy), durable_dir=d)
        t0 = time.perf_counter()
        for s in range(0, INSERT_ROWS, INSERT_CHUNK):
            mi.insert(fresh[s: s + INSERT_CHUNK])
        secs = time.perf_counter() - t0
        mi.close()
        shutil.rmtree(d)
        out[policy] = {"rows": INSERT_ROWS, "secs": secs,
                       "rows_per_s": INSERT_ROWS / secs}
    return out


def crash_sweep(index, fresh, queries, spec, tmp):
    """The kill-at-every-site sweep of the JAX package's recovery
    benchmark on the card: acked inserts and deletes, a crash at one site
    (an insert's WAL append or fsync, or a checkpoint's rotate, write or
    manifest publish), ``recover`` on the card; no acked mutation lost, no
    delete resurrected, and searches equal to an index given the same
    mutations that never crashed."""
    import os
    import shutil
    import numpy as np
    from repro_torch import fault
    from repro_torch.durable import WalFailedError
    from repro_torch.mutate import MutableAnnIndex, MutateConfig
    cfg = MutateConfig(graph="nsg", graph_kw=dict(NSG_KW),
                       delta_capacity=INSERT_ROWS, auto_merge="off",
                       wal_fsync="every")
    a, b = fresh[:INSERT_CHUNK], fresh[INSERT_CHUNK: 2 * INSERT_CHUNK]
    out = {}
    for site in CHAOS_SITES:
        d = os.path.join(tmp, site)
        mi = MutableAnnIndex(index, config=cfg, durable_dir=d)
        ids = mi.insert(a)                              # acked
        deleted = [int(ids[1]), int(ids[7]), 11]
        mi.delete(deleted)                              # acked
        acked = mi.live_ids()
        fault.arm(site, kind="raise", hits={0})
        crashed_on = None
        try:
            try:
                mi.insert(b)
            except (fault.FaultInjected, WalFailedError):
                crashed_on = "insert"
            if crashed_on is None:
                acked = mi.live_ids()                   # that insert acked
                try:
                    mi.checkpoint()
                except (fault.FaultInjected, WalFailedError):
                    crashed_on = "checkpoint"
        finally:
            fault.disarm()
        check(crashed_on is not None, f"crash sweep: {site} never fired")
        mi.close()
        t0 = time.perf_counter()
        back = MutableAnnIndex.recover(d, config=cfg, device=index.device)
        recover_secs = time.perf_counter() - t0
        got = set(map(int, back.live_ids()))
        lost = set(map(int, acked)) - got
        resurrected = got & set(deleted)
        # the index that never crashed: the same mutations, and the second
        # insert where it was acked or reached the log before the crash
        twin = MutableAnnIndex(index, config=cfg)
        twin.insert(a)
        twin.delete(deleted)
        extra = got - set(map(int, acked))
        if crashed_on == "checkpoint" or extra:
            twin.insert(b)
        twin_ids = set(map(int, twin.live_ids()))
        r1, r2 = (search_all(m, queries, spec) for m in (back, twin))
        equal = (got == twin_ids and np.array_equal(r1[0], r2[0])
                 and np.array_equal(r1[1], r2[1]))
        out[site] = {"crashed_on": crashed_on, "acked_lost": len(lost),
                     "resurrected": len(resurrected),
                     "unacked_recovered": len(extra),
                     "recover_secs": recover_secs,
                     "searches_equal_uncrashed": bool(equal)}
        back.close()
        shutil.rmtree(d)
        check(not lost and not resurrected and equal,
              f"crash sweep {site}: {out[site]}")
    return out


# --- phases 4c and 4d: the sharded index, the serving launcher ---------------
# the sharded phase: the mutate phase's 10k rows in four shards, four shard
# slots on the one card; (spec, engine) runs, the kernel engines first
SHARDS = 4
SHARDED_RUNS = (("W4", "fused"), ("W4", "unfused"), ("W4", "torch"),
                ("W1", "fused"), ("W1", "torch"),
                ("W4_both", "fused"), ("W4_both", "torch"))
# its live part: a shard merges once its delta holds this share of
# DELTA_CAPACITY (about 200 of the ~256 fresh rows each shard takes)
SHARD_MERGE_THRESHOLD = 0.2
# the launch phase: the reference CLI's entry point on the card
LAUNCH_ARGS = ("--n-base", "5000", "--dim", "128", "--requests", "64",
               "--m", "16", "--efc", "64", "--autotune")


def batched(search, queries, spec, **kw):
    """``search`` over ``queries`` in batches of ``BATCH``: (ids, dists,
    each batch's stats, the kernel set each batch launched on this
    thread)."""
    import numpy as np
    from repro_torch.kernels import ops
    ids, dists, stats, kernels = [], [], [], []
    for s in range(0, len(queries), BATCH):
        before = ops.thread_launch_counts()
        i, d, st = search(queries[s: s + BATCH], spec, **kw)
        after = ops.thread_launch_counts()
        ids.append(i)
        dists.append(d)
        stats.append(st)
        kernels.append({k for k in after if after[k] > before[k]})
    return np.concatenate(ids), np.concatenate(dists), stats, kernels


def stats_tuple(st):
    """Every field of a batch-total SearchStats, for equality checks."""
    return (int(st.dist_calls), int(st.est_calls), int(st.rerank_calls),
            int(st.sq8_calls), int(st.hops), int(st.iters), st.router,
            tuple(sorted((k, int(v)) for k, v in st.extra.items())),
            int(st.shards_failed), bool(st.degraded))


def host_merge(parts, k):
    """The stable host top-k of per-shard (ids, dists) pools."""
    import numpy as np
    all_ids = np.concatenate([p[0] for p in parts], axis=1)
    all_d = np.concatenate([p[1] for p in parts], axis=1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(all_ids, order, axis=1),
            np.take_along_axis(all_d, order, axis=1))


def sharded_runs(idx, queries, gt, main_launches):
    """Every (spec, engine) of ``SHARDED_RUNS`` over ``queries``, counts
    from 0 around each; each kernel engine equal to torch (ids, dists,
    every batch's counters), each batch exactly its kernels, each kernel
    bit-equal to its plain version on the inputs the run captured."""
    import numpy as np
    import torch
    from repro_torch import trace
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import recall_at_k
    from repro_torch.kernels import ops
    out, runs, checked = {}, {}, []
    shards = len(idx.mesh.devices)
    for name, engine in SHARDED_RUNS:
        spec = SearchSpec(engine=engine, **SPECS[name])
        idx.search(queries[:BATCH], spec)       # the step's setup, off the clock
        capture = CaptureInputs()
        if engine != "torch":
            with capture, eager_twin(SPECS[name]) as twin:
                idx.search(queries[:BATCH],
                           SearchSpec(engine=engine, **twin))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # one call record over every shard's hop loops (trace.hop_loop)
        with trace.call() as rec:
            ids, dists, stats, kernels = batched(idx.search, queries, spec)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = expected_kernels(engine, SPECS[name])
        check(all(k == want for k in kernels),
              f"sharded/{name}: a {engine} batch launched "
              f"{sorted(set().union(*kernels))}, expected {sorted(want)}")
        # every loop replays but a shard's first on the last, shorter batch
        eager = rec.iters - rec.graph_iters
        check(eager <= shards * (len(queries) % BATCH != 0),
              f"sharded/{name}: {engine} ran {eager} of {rec.iters} hop "
              "iterations eagerly")
        if engine != "torch":
            for k, v in launches.items():
                main_launches[k] = main_launches.get(k, 0) + v
            checked += [dict(c, spec=name, engine=engine)
                        for c in captured_equal(capture)]
        runs[name, engine] = (ids, dists, [stats_tuple(s) for s in stats])
        out[f"{name}/{engine}"] = {
            "secs": secs, "qps": len(queries) / secs,
            "recall@10": recall_at_k(ids, gt, 10),
            "iters_per_batch": float(np.mean([s.iters for s in stats])),
            "dist_calls_per_query": sum(int(s.dist_calls) for s in stats)
            / len(queries), "launches": launches,
            "graph": {"iters": rec.iters, "graph_iters": rec.graph_iters}}
    for (name, engine), (ids, dists, st) in runs.items():
        if engine == "torch":
            continue
        p_ids, p_d, p_st = runs[name, "torch"]
        same = (np.array_equal(ids, p_ids) and np.array_equal(dists, p_d)
                and st == p_st)
        out[f"{name}/{engine}"]["equals_torch"] = same
        check(same, f"sharded/{name}: {engine} differs from torch (ids, "
              "dists or a batch's counters)")
    return out, checked


def sharded_edges(idx, arrays, queries, dev):
    """The merge against a host merge of the four shards' own pools, the
    hop budget, a bucket-padded batch's totals and the finger rejection."""
    import numpy as np
    import torch
    from repro_torch.core.search import _search_batch
    from repro_torch.core.spec import SearchSpec
    spec = SearchSpec(engine="fused", **SPECS["W4"])
    q = queries[:BATCH]
    efs = spec.efs
    ids, dists, _ = idx.search(q, spec.replace(k=efs))
    cfg = spec.replace(metric=arrays.metric, use_hierarchy=False)
    qt = torch.as_tensor(q, device=dev)
    parts = []
    for s, shard in enumerate(idx._placed):
        res = _search_batch(shard, qt, np.float32(arrays.cos_theta), cfg)
        loc = res.ids.cpu().numpy()
        parts.append((np.where(loc < arrays.ns, loc + shard["offset"], -1),
                      res.dists.cpu().numpy()))
    h_ids, h_d = host_merge(parts, efs)
    merge_equal = bool(np.array_equal(ids, h_ids)
                       and np.array_equal(dists, h_d))
    _, _, st8 = idx.search(q, spec.replace(max_hops=8))
    n = 100
    padded = np.zeros_like(q)
    padded[:n] = q[:n]
    p_ids, p_d, p_st = idx.search(padded, spec, valid=np.arange(BATCH) < n)
    r_ids, r_d, r_st = idx.search(q[:n], spec)
    pad_equal = (np.array_equal(p_ids[:n], r_ids)
                 and stats_tuple(p_st) == stats_tuple(r_st))
    try:
        idx.search(q[:2], SearchSpec(router="finger", engine="fused"))
        finger = "accepted"
    except NotImplementedError:
        finger = "NotImplementedError"
    out = {"merge_equals_host_merge": merge_equal,
           "max_hops_8_iters": int(st8.iters),
           "padded_totals_equal": pad_equal, "finger": finger}
    check(merge_equal, "sharded: the merge differs from a host merge of "
          "the shards' pools")
    check(st8.iters <= 8, f"sharded: max_hops=8 ran {st8.iters} iterations")
    check(pad_equal, "sharded: a padded batch's totals differ from the "
          "unpadded batch's")
    check(finger == "NotImplementedError",
          "sharded: router='finger' was not rejected")
    return out


def sharded_serve(idx, queries, main_launches):
    """``ShardedIndexSession`` behind the frontend on the serve phase's
    ragged stream: each request equal to a direct sharded search of its
    rows, each dispatch exactly its kernels, no first use after warmup."""
    import numpy as np
    import torch
    from repro_torch.core.spec import SearchSpec
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeFrontend
    spec = SearchSpec(engine="fused", **SPECS["W4"])
    t0 = time.perf_counter()
    fe = ServeFrontend(idx, spec, buckets=SERVE_BUCKETS)
    warm_secs = time.perf_counter() - t0
    warm = fe._base.engine.compile_count()
    records = []
    record_dispatches(fe, {"W4/fused": spec}, records)
    stream = ragged_stream(len(queries), seed=11)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    futs = []
    for i, (lo, hi, k) in enumerate(stream):
        futs.append(fe.submit(queries[lo:hi], k=k))
        if i % 3 == 2:
            fe.flush()
    fe.flush()
    got = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v
    dispatches = check_dispatch_kernels("sharded serve", records)
    after = fe._base.engine.compile_count()
    summ = fe.telemetry.summary()
    # a request's rows search independently of the other rows of its
    # dispatch: each equals a direct search of its own rows
    bad = [i for i, ((lo, hi, k), r) in enumerate(zip(stream, got))
           if not all(np.array_equal(a, b) for a, b in zip(
               r[:2], idx.search(queries[lo:hi], spec.replace(k=k))[:2]))]
    out = {"stream_requests": len(stream), "warmup_secs": warm_secs,
           "secs": secs,
           "dispatches": dispatches, "first_uses_warm": warm,
           "first_uses_after": after, "requests_unequal_to_direct": bad[:5],
           "launches": launches, **serve_digest(summ)}
    check(not bad, f"sharded serve: {len(bad)} requests differ from a "
          "direct sharded search")
    check(summ["recompiles_after_warmup"] == 0 and after == warm,
          f"sharded serve: first uses on the request path ({warm} -> "
          f"{after})")
    return out


def sharded_mutate(graphs, profiles, queries, fresh, main_launches, tmp,
                   dev):
    """A durable ``MutableShardedAnnIndex`` over the four shard graphs
    behind the worker: ``INSERT_ROWS`` fresh rows in chunks, ``DELETES``
    deletes, served until a staggered background merge has swapped in;
    at most one shard merges at a time, no deleted id returned, no first
    use across the swap, ``shard.search.1`` armed degrades to the other
    shards' composition, and ``recover`` equals the live index."""
    import os
    import threading
    import numpy as np
    import torch
    from repro_torch import fault
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.spec import SearchSpec
    from repro_torch.kernels import ops
    from repro_torch.mutate import MutableShardedAnnIndex, MutateConfig
    from repro_torch.serve import ServeFrontend
    spec = SearchSpec(engine="fused", **SPECS["W4"])
    cfg = MutateConfig(graph="hnsw", graph_kw=dict(m=16, efc=64),
                       delta_capacity=DELTA_CAPACITY,
                       merge_threshold=SHARD_MERGE_THRESHOLD,
                       auto_merge="background", wal_fsync="every")
    d = os.path.join(tmp, "sharded")
    t0 = time.perf_counter()
    mi = MutableShardedAnnIndex(
        [AnnIndex(graph=g, profile=p, device=dev)
         for g, p in zip(graphs, profiles)],
        config=cfg, spec=spec, durable_dir=d)
    create_secs = time.perf_counter() - t0
    fe = ServeFrontend(mi, spec, buckets=SERVE_BUCKETS)
    warm = mi.compile_count()
    records = []
    record_dispatches(fe, {"W4/fused": spec}, records)
    # a watcher samples how many shard merges run at once
    most, stop = [0], threading.Event()

    def watch():
        while not stop.is_set():
            most[0] = max(most[0], sum(t.is_alive() for t in
                                       list(mi._merge_threads.values())))
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fe.start(poll_s=0.001)
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    futs, done, live, window = mutate_traffic(
        mi, fe, queries, fresh, rng, started=lambda: bool(mi._merge_threads),
        merging=lambda: sum(mi.epochs) == 0 and any(
            t.is_alive() for t in list(mi._merge_threads.values())),
        wait=mi.wait_for_merges)
    fe.stop()
    results = [f.result(timeout=600) for f, _, _ in futs]
    stop.set()
    watcher.join(timeout=10)
    torch.cuda.synchronize()
    traffic_secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v
    dispatches = check_dispatch_kernels("sharded mutate", records)
    leaks = sum(int(np.isin(r[0], dead).sum())
                for r, (_, _, dead) in zip(results, futs))
    first_uses_after = mi.compile_count()
    summ = fe.telemetry.summary()
    check(np.array_equal(np.sort(np.concatenate([sh.live_ids()
                                                 for sh in mi.shards])),
                         np.flatnonzero(live)),
          "sharded mutate: the index's live ids differ from the trace's")

    # shard 1 fails: the other three shards' composition, degraded
    q = queries[:BATCH]
    fault.arm("shard.search.1", kind="raise")
    try:
        ids, dists, st = mi.search(q, spec)
    finally:
        fault.disarm()
    others = host_merge([mi.shards[s].search(q, spec)[:2]
                         for s in range(SHARDS) if s != 1], spec.k)
    degraded_equal = (st.degraded and st.shards_failed == 1
                      and np.array_equal(ids, np.where(
                          np.isfinite(others[1]), others[0], -1))
                      and np.array_equal(dists, others[1]))
    # recover from the parent manifest: equal routing, live ids, searches
    live_r = batched(mi.search, queries, spec)
    mi.close()
    t0 = time.perf_counter()
    back = MutableShardedAnnIndex.recover(d, config=cfg, spec=spec,
                                          device=dev)
    recover_secs = time.perf_counter() - t0
    back_r = batched(back.search, queries, spec)
    recovered_equal = (
        all(np.array_equal(a.live_ids(), b.live_ids())
            for a, b in zip(mi.shards, back.shards))
        and np.array_equal(live_r[0], back_r[0])
        and np.array_equal(live_r[1], back_r[1]))
    back.close()
    out = {"n_start": int(sum(g.n for g in graphs)),
           "inserted": INSERT_ROWS, "insert_chunk": INSERT_CHUNK,
           "deleted": DELETES, "delta_capacity": DELTA_CAPACITY,
           "merge_threshold": SHARD_MERGE_THRESHOLD, "wal_fsync": "every",
           "durable_create_secs": create_secs, "traffic_secs": traffic_secs,
           "requests": len(futs), "merge_window_secs": window[1] - window[0],
           "epochs": list(mi.epochs), "most_merging_at_once": most[0],
           "merge": {s: sh.last_merge for s, sh in enumerate(mi.shards)
                     if sh.last_merge},
           "dispatches": dispatches, "deleted_leaks": leaks,
           "first_uses_warm": warm, "first_uses_after": first_uses_after,
           "serve": serve_digest(summ), "launches": launches,
           "degraded_equals_three_shards": bool(degraded_equal),
           "recover_secs": recover_secs,
           "recovered_equals_live": bool(recovered_equal)}
    check(sum(mi.epochs) >= 1, "sharded mutate: no merge swapped in")
    check(most[0] <= 1, f"sharded mutate: {most[0]} shards merged at once")
    check(leaks == 0, f"sharded mutate: {leaks} results held deleted ids")
    check(summ["recompiles_after_warmup"] == 0 and first_uses_after == warm,
          f"sharded mutate: first uses on the request path across the swap "
          f"({warm} -> {first_uses_after})")
    check(degraded_equal, "sharded mutate: shard.search.1 did not degrade "
          "to the other shards' composition")
    check(recovered_equal, "sharded mutate: the recovered index differs "
          "from the live one")
    return out


def sharded_phase(ds, main_launches):
    """The sharded index on the card: the first ``MUTATE_BASE`` rows of
    the hnsw phase's data in ``SHARDS`` shards (HNSW m=16, efc=64 each),
    four shard slots on the one H100; its searches, edge cases, serving
    and a durable mutable sharded index (see the module docstring)."""
    import tempfile
    import numpy as np
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.sharded_index import (ShardedAnnIndex,
                                                build_shards, stack_shards)
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import VectorDataset, exact_ground_truth
    from repro_torch.launch.mesh import make_local_mesh
    base = ds.base[:MUTATE_BASE]
    t0 = time.perf_counter()
    # shard_dataset is stack_shards(*build_shards(...)): the graphs are kept
    # for the mutable index over the same four blocks
    graphs, profiles = build_shards(base, SHARDS, graph="hnsw", m=16, efc=64)
    arrays = stack_shards(graphs, profiles)
    build_secs = time.perf_counter() - t0
    mesh = make_local_mesh(SHARDS, "shards")
    idx = ShardedAnnIndex(arrays, mesh, spec=SearchSpec(**SPECS["W4"]))
    dev = mesh.devices[0]
    gt = exact_ground_truth(VectorDataset("first10k", base, ds.queries),
                            k=10, device=dev)
    runs, checked = sharded_runs(idx, ds.queries, gt, main_launches)
    edges = sharded_edges(idx, arrays, ds.queries, dev)
    serve = sharded_serve(idx, ds.queries, main_launches)
    t0 = time.perf_counter()
    single = AnnIndex.build(base, graph="hnsw", m=16, efc=64)
    single_secs = time.perf_counter() - t0
    spec = SearchSpec(engine="fused", **SPECS["W4"])
    prof = {"sharded_S4": profile_batch(idx, ds.queries, spec),
            "single_10k": profile_batch(single, ds.queries, spec)}
    del single
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        mutate = sharded_mutate(graphs, profiles, ds.queries,
                                fresh_rows(ds.base.shape[1]), main_launches,
                                tmp, dev)
    emit({"phase": "sharded", "n": MUTATE_BASE, "dim": base.shape[1],
          "shards": SHARDS, "ns": arrays.ns, "m": 16, "efc": 64,
          "slots": [str(x) for x in mesh.devices],
          "build_secs": build_secs, "single_build_secs": single_secs,
          "theta_star": float(np.degrees(np.arccos(arrays.cos_theta))),
          "runs": runs, "kernels_bit_equal": checked, "edges": edges,
          "serve": serve, "batch_profile": {
              k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms",
                                       "device_idle_share",
                                       "kernel_launches", "port_kernels")}
              for k, v in prof.items()},
          "mutate": mutate,
          "cuts": "n 1M -> 10k (the mutate phase's rows; 20k until the "
                  "lm phase came) in 4 shards of 2.5k on one card; m 32 -> "
                  "16, efc 256 -> 64 (host HNSW "
                  "builder)"})


def launch_phase():
    """``python -m repro_torch.launch.serve`` (``LAUNCH_ARGS``) as a
    subprocess on the card: exit 0, ``recompiles_after_warmup=0``, the
    controller's switches, failures, final spec and screen seconds."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_ARGS],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    secs = time.perf_counter() - t0
    out = proc.stdout

    def grab(pattern):
        m = re.search(pattern, out, re.M)
        return m.groups() if m else None

    result = grab(r"^router=crouting: recall@10=([\d.]+) QPS=(\d+) "
                  r"p50=([\d.]+)ms p95=([\d.]+)ms p99=([\d.]+)ms "
                  r"recompiles_after_warmup=(\d+)$")
    tuned = grab(r"^autotune: (\d+) switches, (\d+) failures, final spec "
                 r"(\S+)$")
    screen = grab(r"^autotune attached in ([\d.]+)s: incumbent (\S+) "
                  r".*, (\d+) quarantined\)$")
    emit({"phase": "launch", "args": list(LAUNCH_ARGS), "rc": proc.returncode,
          "secs": secs,
          "recall@10": float(result[0]) if result else None,
          "qps": int(result[1]) if result else None,
          "p50_ms": float(result[2]) if result else None,
          "p99_ms": float(result[4]) if result else None,
          "recompiles_after_warmup": int(result[5]) if result else None,
          "screen_secs": float(screen[0]) if screen else None,
          "screen_incumbent": screen[1] if screen else None,
          "quarantined": int(screen[2]) if screen else None,
          "switches": int(tuned[0]) if tuned else None,
          "failures": int(tuned[1]) if tuned else None,
          "final_spec": tuned[2] if tuned else None,
          "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""})
    check(proc.returncode == 0, f"launch: exit {proc.returncode}")
    check(result is not None and int(result[5]) == 0,
          "launch: recompiles_after_warmup is not 0")
    check(tuned is not None, "launch: no autotune line")


def lm_check(dev):
    """``lm.check``: fp32 at granite-8b's widths, 2 layers, on the card.
    The blockwise attention against a naive masked softmax at B=2, S=1024,
    H=32 (8 kv heads), dh=128 with the config's blocks (forward 1e-4, its
    autograd.Function's gradients 1e-3, each relative to the largest
    entry); the decode step's logits at position S against ``forward``'s
    (rtol = atol = 1e-3); ``moe_dispatch_indices`` for granite-moe's E=32,
    k=8 at T=1024 on the card against the CPU, exactly; ``moe_layer``
    there repeats bit for bit (``moe_combine_repeats``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch("granite-8b").model_cfg, n_layers=2,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, Hkv, dh = 2, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q, k, v = (torch.randn(B, S, h, dh, generator=gen, device=dev,
                           requires_grad=True) for h in (H, Hkv, Hkv))
    do = torch.randn(B, S, H, dh, generator=gen, device=dev)
    o = L.blockwise_causal_attention(q, k, v, block_q=cfg.block_q,
                                     block_k=cfg.block_k)
    grads = torch.autograd.grad(o, (q, k, v), do)
    G = H // Hkv
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(G, dim=2))
    s = (s / np.sqrt(dh)).masked_fill(
        ~torch.ones(S, S, dtype=torch.bool, device=dev).tril(), -np.inf)
    ref = torch.einsum("bhst,bthd->bshd", s.softmax(-1),
                       v.repeat_interleave(G, dim=2))
    ref_grads = torch.autograd.grad(ref, (q, k, v), do)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    attn_err = rel(o.detach(), ref.detach())
    grad_errs = [rel(a, b) for a, b in zip(grads, ref_grads)]
    check(attn_err <= 1e-4, f"lm.check: attention {attn_err} from naive")
    check(max(grad_errs) <= 1e-3,
          f"lm.check: attention gradients {grad_errs} from naive")
    del q, k, v, do, o, grads, s, ref, ref_grads

    params = T.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=dev)
    _, cache = T.make_prefill_step(cfg)(params, toks[:, :S])
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 32))
             for n, c in cache.items()}
    logits, _ = T.make_serve_step(cfg)(params, cache, toks[:, S:], S)
    with torch.no_grad():
        h = T.forward(params, toks, cfg)
        fwd = (h[:, S] @ params["lm_head"]).float()[:, :cfg.vocab]
    decode_err = float((logits - fwd).abs().max())
    check(torch.allclose(logits, fwd, rtol=1e-3, atol=1e-3),
          f"lm.check: decode logits differ from forward by {decode_err}")
    del params, cache, h

    moe = get_arch("granite-moe-1b-a400m").model_cfg.moe
    T_tok = 1024
    cap = max(8, int(moe.capacity_factor * moe.top_k * T_tok
                     / moe.n_experts))
    _, top = torch.topk(torch.randn(T_tok, moe.n_experts, generator=gen,
                                    device=dev), moe.top_k, dim=-1)
    on_card = L.moe_dispatch_indices(top, moe.n_experts, cap)
    on_cpu = L.moe_dispatch_indices(top.cpu(), moe.n_experts, cap)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
          "lm.check: moe_dispatch_indices differ between card and CPU")
    combine = moe_combine_repeats(dev, gen, T_tok)
    torch.cuda.empty_cache()
    return {"phase": "lm.check", "widths": "granite-8b, 2 layers, fp32",
            "attn_shape": [B, S, H, Hkv, dh],
            "blocks": [cfg.block_q, cfg.block_k],
            "attn_rel_err": attn_err, "attn_grad_rel_err": grad_errs,
            "decode_vs_forward_max_abs_err": decode_err,
            "moe_dispatch": {"T": T_tok, "E": moe.n_experts, "k": moe.top_k,
                             "capacity": cap, "equal_to_cpu": True,
                             "kept_share": float(on_cpu[1].float().mean())},
            "moe_combine": combine,
            "secs": time.perf_counter() - t_phase}


def moe_combine_repeats(dev, gen, T_tok):
    """``moe_layer`` (its fixed-order combine) at granite-moe's widths and
    E=32, k=8 on ``T_tok`` tokens, forward and backward twice on the same
    inputs, in fp32 and bf16: the outputs and all five gradients must be
    bit-equal.  Beside it, for the record only, the slot-indexed
    ``index_add`` combine it replaced, run twice the same way: whether
    its atomics happened to repeat."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    cfg = get_arch("granite-moe-1b-a400m").model_cfg
    E, k, D, Fd = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.d_ff
    mcfg = L.MoeConfig(E, k, cfg.moe.capacity_factor)

    def index_add_combine(x, gate_w, w_gate, w_up, w_down):
        cap = max(8, int(mcfg.capacity_factor * k * T_tok / E))
        top_val, top_idx = torch.topk((x @ gate_w).float(), k, dim=-1)
        probs = torch.softmax(top_val, dim=-1).to(x.dtype)
        dest, keep, src = L.moe_dispatch_indices(top_idx, E, cap)
        xe = F.embedding(src.reshape(E, cap),
                         torch.cat([x, x.new_zeros(1, D)]))
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate)) \
            * torch.einsum("ecd,edf->ecf", xe, w_up)
        ye = torch.einsum("ecf,efd->ecd", h, w_down)
        slot = torch.where(keep.reshape(-1), dest.reshape(-1), E * cap)
        wslot = ye.new_zeros(E * cap + 1).index_put(
            (slot,), (probs * keep).reshape(-1).to(ye.dtype))
        upd = ye.reshape(E * cap, D) * wslot[:-1, None]
        return ye.new_zeros(T_tok + 1, D).index_add(0, src, upd)[:T_tok]

    out = {"T": T_tok, "E": E, "k": k, "d_model": D, "d_ff": Fd}
    for dt in (torch.float32, torch.bfloat16):
        args = [torch.randn(shape, generator=gen, device=dev).mul_(sc).to(dt)
                .requires_grad_(True) for shape, sc in (
                    ((T_tok, D), 1.0), ((D, E), 0.05), ((E, D, Fd), 0.03),
                    ((E, D, Fd), 0.03), ((E, Fd, D), 0.04))]
        cot = torch.randn((T_tok, D), generator=gen, device=dev).to(dt)
        runs = {"fixed_order": lambda *a: L.moe_layer(*a, mcfg),
                "index_add": index_add_combine}
        row = {}
        for name, fn in runs.items():
            res = []
            for _ in range(2):
                y = fn(*args)
                res.append([y.detach()] + list(
                    torch.autograd.grad(y, args, cot)))
            row[name + "_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(*res))
            if name == "fixed_order":
                dest, keep, _ = L.moe_dispatch_indices(
                    torch.topk((args[0] @ args[1]).float(), k, dim=-1)[1], E,
                    max(8, int(mcfg.capacity_factor * k * T_tok / E)))
                row["tokens_with_duplicate_slots"] = int(
                    (keep.sum(dim=1) >= 2).sum())
                row["kept_share"] = float(keep.float().mean())
        check(row["fixed_order_bit_equal"],
              f"lm.check: moe_layer ({dt}) forward/backward do not repeat "
              "bit for bit")
        out[str(dt).replace("torch.", "")] = row
    return out


def lm_serve(dev):
    """``lm.serve``: granite-8b at full width and depth in bf16, parameters
    drawn on the card; prefill B=2 x S=4096 (blocks 256 x 1024), then a
    greedy decode of ``LM_SERVE["new_tokens"]`` tokens into a cache of
    S + 32 slots; every logit finite.  The first decode step against
    ``forward`` over the prompt plus that token: in fp32 on the same
    weights (cast up) at cosine >= 0.99 a row.  In bf16 at full depth the
    cosine is reported beside the bf16 forward's own cosine to the fp32
    one: at this init (stacked weights drawn with fan_in = n_layers,
    attention scores near one-hot) bf16 rounding moves the last logits by
    tens of percent at 16 layers and more at 36, on either path, and by a
    few percent at one layer on some seeds.  So bf16 decode is held to the
    bf16 forward at full width and depth on the same weights rescaled to a
    fan-in init: cosine >= 0.999 a row, fp32 logits and a bf16 cache."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    cfg = get_arch("granite-8b").model_cfg
    B, S, n_new = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["new_tokens"]
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_secs = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    prefill, serve = T.make_prefill_step(cfg), T.make_serve_step(cfg)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    prefill(params, toks[:, :256])                 # first use: cuBLAS, kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)
    torch.cuda.synchronize()
    prefill_secs = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    T_cache = S + n_new
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n_new))
             for n, c in cache.items()}
    tok = logits.argmax(-1, keepdim=True)
    first_tok, step_ms, out = tok, [], []
    for i in range(n_new):
        t0 = time.perf_counter()
        logits, cache = serve(params, cache, tok, S + i)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(logits).all()
        if i == 0:
            first_logits = logits
        out.append(tok)
    peak = int(torch.cuda.max_memory_allocated())
    check(bool(finite), "lm.serve: a logit is not finite")
    del cache
    prompt = torch.cat([toks, first_tok], dim=1)

    def forward_logits(p, c):
        with torch.no_grad():
            return (T.forward(p, prompt, c)[:, S] @ p["lm_head"]
                    ).float()[:, :c.vocab]

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            a.double(), b.double(), dim=-1).tolist()

    fwd = forward_logits(params, cfg)
    # the same weights in fp32: the decode step and the forward again
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    _, cache = T.make_prefill_step(cfg32)(p32, toks)
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
             for n, c in cache.items()}
    dec32, _ = T.make_serve_step(cfg32)(p32, cache, first_tok, S)
    del cache
    fwd32 = forward_logits(p32, cfg32)
    cos32 = cosine(dec32, fwd32)
    check(min(cos32) >= 0.99,
          f"lm.serve: fp32 first decode step at cosine {cos32} to forward")
    del p32
    # bf16 decode against the bf16 forward on the same weights rescaled to
    # a fan-in init (each stacked matrix to std 1/sqrt(its input width), so
    # attention scores have std ~1): the reference's init leaves the scores
    # near one-hot, where one bf16 rounding of q or k flips a softmax
    for leaf in params["layers"].values():
        if leaf.dim() == 3:
            leaf.mul_(math.sqrt(cfg.n_layers / leaf.shape[1]))
    _, cache = prefill(params, toks)
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
             for n, c in cache.items()}
    dec16, cache = serve(params, cache, first_tok, S)
    check(dec16.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
          and cache["v"].dtype == torch.bfloat16,
          f"lm.serve: bf16 decode gave {dec16.dtype} logits and a "
          f"{cache['k'].dtype} cache")
    del cache
    cos16 = cosine(dec16, forward_logits(params, cfg))
    check(min(cos16) >= 0.999,
          f"lm.serve: bf16 first decode step at cosine {cos16} to the bf16 "
          f"forward (fan-in weights)")
    del params
    torch.cuda.empty_cache()
    return {"phase": "lm.serve", "arch": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "param_count": n_params, "param_gb": n_params * 2 / 1e9,
            "init_secs": init_secs, "batch": B, "prompt": S,
            "blocks": [cfg.block_q, cfg.block_k], "cache_slots": T_cache,
            "prefill_secs": prefill_secs,
            "prefill_tokens_per_s": B * S / prefill_secs,
            "decode_tokens": n_new,
            "decode_ms_per_token_mean": sum(step_ms) / n_new,
            "decode_ms_per_token_median": statistics.median(step_ms),
            "decode_ms_first": step_ms[0],
            "first_step_cosine_fp32": cos32,
            "first_step_cosine_bf16_fan_in": cos16,
            "first_step_cosine_bf16": cosine(first_logits, fwd),
            "bf16_decode_vs_fp32_forward": cosine(first_logits, fwd32),
            "bf16_forward_vs_fp32_forward": cosine(fwd, fwd32),
            "greedy_tokens_row0": torch.cat(out, 1)[0, :8].tolist(),
            "max_memory_allocated_bf16_serve": peak,
            "cuts": "prefill_32k B=32 x 32,768 -> B=2 x 4,096; decode_32k "
                    "B=128 x a 32,768 cache -> B=2 x 4,128 slots, 32 greedy "
                    "steps",
            "secs": time.perf_counter() - t_phase}


def moe_kept_share(params, tokens, cfg):
    """Each layer's dispatch kept share (``keep.mean()``) on ``tokens``,
    read from the model's own ``forward``: ``moe_dispatch_indices`` is
    wrapped for that one call to record what each MoE layer kept."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    dispatch, kept = L.moe_dispatch_indices, []

    def recording(top_idx, n_experts, capacity):
        dest, keep, src = dispatch(top_idx, n_experts, capacity)
        kept.append((keep.float().mean(), capacity))
        return dest, keep, src

    L.moe_dispatch_indices = recording
    try:
        with torch.no_grad():
            T.forward(params, tokens, cfg)
    finally:
        L.moe_dispatch_indices = dispatch
    check(len(kept) == cfg.n_layers,
          f"lm.train: {len(kept)} dispatches in a {cfg.n_layers}-layer forward")
    return [float(k) for k, _ in kept], kept[0][1]


def lm_train(dev):
    """``lm.train``: granite-moe-1b-a400m at full width in bf16, fp32 AdamW
    moments, B=2 x S=512, remat on, ``LM_TRAIN["steps"]`` steps of
    ``make_train_step``: loss and grad norm finite at every step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_arch("granite-moe-1b-a400m").model_cfg
    B, S, n_steps = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"]
    ocfg = opt.AdamWConfig(state_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, dev)
    state = opt.adamw_init(params, ocfg)
    torch.cuda.synchronize()
    init_secs = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    stream = LMStream(cfg.vocab, B, S, seed=0)
    step = T.make_train_step(cfg, ocfg)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs, kept = [], [], [], None
    for i in range(n_steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.next().items()}
        if i == 0:
            kept, cap = moe_kept_share(params, batch["tokens"], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    peak = int(torch.cuda.max_memory_allocated())
    check(all(map(math.isfinite, losses + gnorms)),
          f"lm.train: loss {losses} / grad norm {gnorms} not finite")
    del params, state
    torch.cuda.empty_cache()
    return {"phase": "lm.train", "arch": cfg.name, "dtype": cfg.dtype,
            "state_dtype": ocfg.state_dtype, "remat": cfg.remat,
            "param_count": n_params, "padded_vocab": cfg.padded_vocab,
            "batch": B, "seq": S, "init_secs": init_secs, "losses": losses,
            "grad_norms": gnorms, "step_secs": secs,
            "moe_capacity": cap, "kept_share_by_layer": kept,
            "kept_share_mean": sum(kept) / len(kept),
            "max_memory_allocated": peak,
            "cuts": "train_4k B=256 x 4,096 -> B=2 x 512, 4 steps, no "
                    "checkpoint (about 14 GB to a 9p temp directory)",
            "secs": time.perf_counter() - t_phase}


def lm_launch(dev):
    """``lm.launch``: ``python -m repro_torch.launch.train`` with
    ``LM_LAUNCH_ARGS`` (the smoke config) as a subprocess on the card, then
    again with ``--resume``: both exit 0.  In-process, the crash and resume
    of tests/test_checkpoint.py::test_crash_resume_bitexact on the card at
    the launcher's settings, for the smoke configs of ``LM_RESUME_ARCHS``
    (dense and MoE): crash at 7, resume from 5, run to 12; the last three
    losses against the uninterrupted run's, bit for bit (the MoE combine
    sums in a fixed order)."""
    import os
    import re
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    try:
        for extra in ((), ("--resume",)):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train",
                 *LM_LAUNCH_ARGS, "--ckpt-dir", os.path.join(tmp, "launch"),
                 *extra], capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=300)
            done = re.search(r"^done: .*$", proc.stdout, re.M)
            resumed = re.search(r"^resumed from step (\d+)$", proc.stdout,
                                re.M)
            runs.append({"args": list(LM_LAUNCH_ARGS) + list(extra),
                         "rc": proc.returncode,
                         "secs": time.perf_counter() - t0,
                         "done": done.group(0) if done else None,
                         "resumed_from": int(resumed.group(1))
                         if resumed else None,
                         "stderr_tail": proc.stderr[-2000:]
                         if proc.returncode else ""})
            check(proc.returncode == 0 and done is not None,
                  f"lm.launch: {runs[-1]}")
        check(runs[1]["resumed_from"] == 12,
              f"lm.launch: --resume did not resume from step 12: {runs[1]}")

        ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=12)

        def make_trainer(arch, name):
            cfg = get_arch(arch).smoke_cfg
            params = T.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            return Trainer(
                TrainerConfig(total_steps=12, ckpt_every=5,
                              ckpt_dir=os.path.join(tmp, arch, name),
                              log_every=100),
                T.make_train_step(cfg, ocfg), params,
                opt.adamw_init(params, ocfg), LMStream(cfg.vocab, 8, 128))

        crash = {}
        for arch in LM_RESUME_ARCHS:
            ref = make_trainer(arch, "ref").run()["history"]
            try:
                make_trainer(arch, "crash").run(crash_at=7)
            except RuntimeError:
                pass
            t2 = make_trainer(arch, "crash")
            check(t2.maybe_resume() and t2.step == 5,
                  f"lm.launch: {arch} resumed at step {t2.step}, not 5")
            got = t2.run()["history"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got[-3:], ref[-3:]))
            check(got[-3:] == ref[-3:], f"lm.launch: {arch} resumed losses "
                  f"{got[-3:]} vs {ref[-3:]}")
            crash[arch] = {"crash_at": 7, "resumed_at": 5, "last3": got[-3:],
                           "last3_ref": ref[-3:],
                           "bit_equal": got[-3:] == ref[-3:],
                           "max_rel_diff": rel}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "lm.launch", "runs": runs, "crash_resume": crash,
            "secs": time.perf_counter() - t_phase}


LM_REPEAT = dict(batch=2, seq=4096, token=7)    # every other token is 7


def lm_repeat(dev):
    """``lm.repeat``: a granite-moe-1b-a400m smoke step (fp32; the full
    config's attention blocks and loss chunk, for speed) on a batch in
    which one token fills every other position (4,096 lookups of one
    embedding row), its loss and gradients taken twice: the embedding
    gradient must repeat bit for bit (``lookup.embedding``'s fixed-order
    backward, the ``segment_sum`` kernel); the other leaves are reported.
    Then the same step once under ``torch.use_deterministic_algorithms(
    True, warn_only=True)``: the ops that have no deterministic CUDA
    implementation on this path."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import segment_sum as K
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_flatten_with_path, value_and_grad
    t_phase = time.perf_counter()
    full = get_arch("granite-moe-1b-a400m").model_cfg
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").smoke_cfg,
                              block_q=full.block_q, block_k=full.block_k,
                              loss_chunk=full.loss_chunk)
    B, S, tok = LM_REPEAT["batch"], LM_REPEAT["seq"], LM_REPEAT["token"]
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1))
    tokens[:, ::2] = tok
    batch = {"tokens": torch.as_tensor(tokens[:, :-1], device=dev),
             "labels": torch.as_tensor(tokens[:, 1:], device=dev)}
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    before = K.LAUNCHES["segment_sum"]
    runs = [value_and_grad(T.loss_fn, params, batch, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    (l1, g1), (l2, g2) = runs
    leaves = [(p, bit_equal(a, b)) for (p, a), (_, b) in zip(
        tree_flatten_with_path(g1), tree_flatten_with_path(g2))]
    embed_equal = bit_equal(g1["embed"], g2["embed"])
    check(embed_equal, "lm.repeat: the embedding gradient of a batch "
          f"repeating token {tok} {int((tokens[:, :-1] == tok).sum())} times "
          "differs between two identical steps")
    nondet = nondeterministic_ops(
        lambda: value_and_grad(T.loss_fn, params, batch, cfg))
    return {"phase": "lm.repeat", "arch": cfg.name, "batch": B, "seq": S,
            "blocks": [cfg.block_q, cfg.block_k],
            "token_repeats": int((tokens[:, :-1] == tok).sum()),
            "embed_grad_bit_equal": embed_equal,
            "loss_bit_equal": bit_equal(l1, l2),
            "leaves_differing": [p for p, same in leaves if not same],
            "segment_sum_launches": K.LAUNCHES["segment_sum"] - before,
            "nondeterministic_ops": nondet,
            "secs": time.perf_counter() - t_phase}


def lm_phase(dev):
    """The LM family (phase 2b): ``lm.check``, ``lm.repeat``,
    ``lm.serve``, ``lm.train``, ``lm.launch``.  Its path reaches none of
    the six search kernels (the reference's LM is plain JAX): their counts
    are reset before it and must read 0 after; the token embedding's
    backward must have launched ``segment_sum``.  Returns the rows by
    phase and ``segment_sum``'s launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as K
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    K.reset_launch_counts()
    rows = {}
    for part in (lm_check, lm_repeat, lm_serve, lm_train, lm_launch):
        row = part(dev)
        rows[row["phase"]] = row
        emit(row)
    launches = dict(ops.LAUNCHES)
    seg = K.LAUNCHES["segment_sum"]
    check(not any(launches.values()),
          f"lm: the LM path launched a search kernel: {launches}")
    check(seg > 0, "lm: the token embedding's backward never launched "
          "segment_sum")
    emit({"phase": "lm", "port_kernel_launches": launches,
          "segment_sum_launches": seg,
          "secs": time.perf_counter() - t0})
    return rows, seg


# --- phase 2c: the GNN family, DLRM training, the quickstart -----------------
GNN_ARCHS = ("schnet", "gat-cora", "egnn", "gin-tu")     # the reference's order
# every arch at these shapes; the first two also against the port on the CPU
GNN_RUN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_CPU_SHAPES = ("full_graph_sm", "molecule")
# full-batch-large: gin-tu only (schnet's [E, 300] RBF tensor alone would be
# ~74 GB there, egnn's [E, 129] edge inputs ~32 GB a layer, gat ~50-60 GB)
GNN_LARGE = (("gin-tu", "ogb_products"),)
GNN_STEPS = 3
# the most the CPU run's own spread may widen the card-vs-CPU rtol by, /2
GNN_SPREAD_CAP = 5e-4
DLRM_TRAIN_STEPS = 3


def gnn_dims(shape):
    """(nodes, edges, padded nodes, padded edges, features, classes,
    graphs) of a GNN shape, as the reference's cell counts them
    (``repro.models.api._gnn_dims``: the sampled bounds of minibatch_lg,
    128 molecules, counts padded to /512)."""
    d = shape.dims
    if shape.shape_id == "minibatch_lg":
        n, e, f, c, g = (d["sub_nodes"], d["sub_edges"], d["d_feat"],
                         d.get("n_classes", 16), 1)
    elif shape.shape_id == "molecule":
        n, e = d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"]
        f, c, g = d["d_feat"], 16, d["batch"]
    else:
        n, e, f, c, g = (d["n_nodes"], d["n_edges"], d["d_feat"],
                         d.get("n_classes", 16), 1)
    return n, e, -(-n // 512) * 512, -(-e // 512) * 512, f, c, g


def graph_batch_on(dev, gen, n, e, n_pad, e_pad, f, c, g, task):
    """``random_graph_batch``'s layout drawn on the card (ogb_products'
    62M edges would take the host tens of seconds); pad nodes and edges
    carry zero masks, and a pad edge indexes node 0."""
    import torch
    real_n = torch.arange(n_pad, device=dev) < n
    real_e = torch.arange(e_pad, device=dev) < e

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev)

    node_mask = real_n.float()
    return {
        "node_feat": torch.randn((n_pad, f), generator=gen, device=dev),
        "pos": torch.randn((n_pad, 3), generator=gen, device=dev) * 3.0,
        "atom_z": ints(1, 20, n_pad),
        "edge_src": ints(0, n, e_pad) * real_e,
        "edge_dst": ints(0, n, e_pad) * real_e,
        "node_mask": node_mask, "edge_mask": real_e.float(),
        "labels": ints(0, c, n_pad), "label_mask": node_mask.clone(),
        "graph_ids": torch.sort(ints(0, g, n_pad)).values,
        "g_labels": (ints(0, c, g) if task == "graph_class"
                     else torch.randn((g,), generator=gen, device=dev))}


def leaf_rel_errs(got, want):
    """Over the leaves of two trees (``got`` on the card, ``want`` on the
    CPU): the largest relative Frobenius error of a leaf, and the largest
    of a leaf's max |got - want| over its max |want|."""
    from repro_torch.tree import tree_leaves
    fro, peak = 0.0, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = a.cpu() - b
        fro = max(fro, float(d.norm() / b.norm().clamp_min(1e-30)))
        peak = max(peak, float(d.abs().max() / b.abs().max().clamp_min(
            1e-30)))
    return fro, peak


def gnn_cell(arch, shape_id, dev, gen):
    """``GNN_STEPS`` train steps of one (arch, shape) on the card (AdamW,
    the reference cell's defaults), each on the same parameters and batch:
    the first step's seconds, the steady mean, the peak memory, and
    whether steps 1 and 2 (identical inputs) repeat bit for bit (reported;
    at ``full_graph_sm``, and wherever a cell does not repeat, the ops the
    step runs that have no deterministic CUDA implementation).  On ``GNN_CPU_SHAPES`` the card's
    loss and gradients against the port on the CPU on the same weights and
    batch: the loss within rtol 1e-4, each gradient leaf within 1e-4 in
    relative Frobenius norm (as tests/test_torch_lm.py holds gradient
    leaves; each leaf's largest error over its largest entry is printed
    beside it), each limit widened by twice the CPU run's own spread on
    it (its change when the parameters are perturbed by 2^-23 relative
    noise, about one fp32 rounding, over three seeds), capped at
    ``GNN_SPREAD_CAP``, as tests/test_torch_gnn.py widens its limits."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as G
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    spec = get_arch(arch)
    n, e, n_pad, e_pad, f, c, g = gnn_dims(spec.shape(shape_id))
    task = spec.model_cfg.task
    if shape_id == "molecule" and task == "node_class":
        task = "graph_class"
    cfg = dataclasses.replace(spec.model_cfg, n_classes=c, task=task)
    batch = graph_batch_on(dev, gen, n, e, n_pad, e_pad, f, c, g, task)
    params = G.init_gnn(cfg, f, gen, dev)
    ocfg = opt.AdamWConfig()
    state = opt.adamw_init(params, ocfg)
    step = G.make_gnn_train_step(cfg, ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, outs = [], []
    for i in range(GNN_STEPS):
        t0 = time.perf_counter()
        out = step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i < 2:
            outs.append(out)
    peak = torch.cuda.max_memory_allocated()
    (p1, s1, m1), (p2, s2, m2) = outs
    loss, gnorm = float(m1["loss"]), float(m1["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"gnn/{arch}/{shape_id}: loss {loss}, grad norm {gnorm}")
    row = {"phase": "gnn", "arch": arch, "shape": shape_id, "task": task,
           "nodes": n, "edges": e, "padded": [n_pad, e_pad], "d_feat": f,
           "classes": c, "graphs": g,
           "edge_bytes": sum(batch[k].numel() * batch[k].element_size()
                             for k in ("edge_src", "edge_dst", "edge_mask")),
           "first_step_s": secs[0],
           "steady_step_s": sum(secs[1:]) / len(secs[1:]),
           "max_memory_allocated": peak, "loss": loss, "grad_norm": gnorm,
           "repeat_bit_equal": bit_equal(m1["loss"], m2["loss"]) and all(
               bit_equal(a, b) for a, b in zip(
                   tree_leaves((p1, s1.mu, s1.nu)),
                   tree_leaves((p2, s2.mu, s2.nu))))}
    if shape_id == "full_graph_sm" or not row["repeat_bit_equal"]:
        row["nondeterministic_ops"] = nondeterministic_ops(
            lambda: step(params, state, batch))
    if shape_id in GNN_CPU_SHAPES:
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        cpu = value_and_grad(G.gnn_loss, cpu_params, cpu_batch, cfg)
        card = value_and_grad(G.gnn_loss, params, batch, cfg)

        def loss_err(a, b):
            return float(abs(a.cpu() - b) / abs(b))

        spread = [0.0, 0.0]
        for seed in range(3):
            noise = torch.Generator().manual_seed(seed)
            moved = value_and_grad(G.gnn_loss, tree_map(
                lambda t: t * (1 + torch.randn(t.shape, generator=noise)
                               * 2.0 ** -23), cpu_params), cpu_batch, cfg)
            spread = [max(spread[0], loss_err(moved[0], cpu[0])),
                      max(spread[1], leaf_rel_errs(moved[1], cpu[1])[0])]
        limits = [1e-4 + 2 * min(x, GNN_SPREAD_CAP) for x in spread]
        row["cpu_loss_rel_err"] = loss_err(card[0], cpu[0])
        row["cpu_grad_rel_err"], row["cpu_grad_max_err_over_max"] = \
            leaf_rel_errs(card[1], cpu[1])
        row["cpu_spread"], row["cpu_limits"] = spread, limits
        check(row["cpu_loss_rel_err"] <= limits[0]
              and row["cpu_grad_rel_err"] <= limits[1],
              f"gnn/{arch}/{shape_id}: the card's loss and gradients differ "
              f"from the CPU's: {row['cpu_loss_rel_err']}, "
              f"{row['cpu_grad_rel_err']} (limits {limits})")
    return row


def gnn_phase(dev):
    """The GNN family (phase 2c): every arch at ``GNN_RUN_SHAPES``, then
    ``GNN_LARGE``; one line an (arch, shape), with whether two identical
    steps repeat bit for bit.  Its path reaches none of the six search
    kernels (the reference's GNN is plain JAX): their counts are reset
    before it and must read 0 after, and its gathers' backwards and
    segment sums must have launched ``segment_sum``.  Returns the rows by
    (arch, shape) and ``segment_sum``'s launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as K
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(4)
    ops.reset_launch_counts()
    K.reset_launch_counts()
    cells = [(a, s) for a in GNN_ARCHS for s in GNN_RUN_SHAPES] + \
        list(GNN_LARGE)
    rows = {}
    for arch, shape_id in cells:
        rows[(arch, shape_id)] = row = gnn_cell(arch, shape_id, dev, gen)
        emit(row)
        torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    seg = K.LAUNCHES["segment_sum"]
    check(not any(launches.values()),
          f"gnn: the GNN path launched a search kernel: {launches}")
    check(seg > 0, "gnn: no segment sum or gather went through segment_sum")
    emit({"phase": "gnn", "cells": len(cells),
          "repeat_bit_equal": {f"{a}/{s}": r["repeat_bit_equal"]
                               for (a, s), r in rows.items()},
          "port_kernel_launches": launches, "segment_sum_launches": seg,
          "secs": time.perf_counter() - t0})
    return rows, seg


def bits_checksum(t):
    """Two int64 sums (wrapping) over a tensor's 32-bit words and their
    squares: equal for equal bits, and moved by any one changed word."""
    import torch
    words = t.detach().reshape(-1).view(torch.int32)
    s1 = s2 = 0
    for chunk in words.split(1 << 26):
        c = chunk.to(torch.int64)
        s1 += int(c.sum())
        s2 += int((c * c).sum())
    return [s1 % 2 ** 64, s2 % 2 ** 64]


def dlrm_train(dev):
    """``dlrm.train``: dlrm-mlperf at its widths with ``VOCAB_CAP`` rows a
    table (12.3 GB of tables), ``train_batch`` B=65,536, fp32 AdamW with
    its moments, ``DLRM_TRAIN_STEPS`` donated steps (parameters and moments
    updated in place); the step seconds, losses and peak memory.  Then the
    same init and first step again: the loss, parameters and moments must
    repeat bit for bit (``bits_checksum`` of every leaf; the lookups'
    backward is the ``segment_sum`` kernel), and the step once more under
    deterministic-algorithms mode (the ops left without a deterministic
    CUDA implementation).  The six search kernels' counts must read 0,
    ``segment_sum``'s must not.  Last, ``dlrm_row_sharded``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as K
    from repro_torch.models import dlrm as M
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_flatten_with_path
    t_phase = time.perf_counter()
    arch = get_arch("dlrm-mlperf")
    cfg = dataclasses.replace(arch.model_cfg, vocab_cap=VOCAB_CAP)
    B = arch.shape("train_batch").dims["batch"]
    ocfg = opt.AdamWConfig()
    step = M.make_dlrm_train_step(cfg, ocfg, donate=True)
    nb = dlrm_batch(cfg.n_dense, [min(v, VOCAB_CAP) for v in cfg.vocab_sizes],
                    B, seed=3)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in nb.items()}

    def fresh():
        params = M.init_dlrm(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        return params, opt.adamw_init(params, ocfg)

    def fingerprint(loss, params, state):
        return {"loss": float(loss), **{
            path: bits_checksum(t) for path, t in tree_flatten_with_path(
                {"params": params, "mu": state.mu, "nu": state.nu})}}

    ops.reset_launch_counts()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = fresh()
    torch.cuda.synchronize()
    init_secs = time.perf_counter() - t0
    secs, losses = [], []
    for i in range(DLRM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i == 0:
            first = fingerprint(m["loss"], params, state)
            gnorm = float(m["grad_norm"])
    peak = torch.cuda.max_memory_allocated()
    del params, state, m
    torch.cuda.empty_cache()
    params, state = fresh()
    params, state, m = step(params, state, batch)
    again = fingerprint(m["loss"], params, state)
    nondet = nondeterministic_ops(lambda: step(params, state, batch))
    del params, state, m
    torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    seg = K.LAUNCHES["segment_sum"]
    check(all(math.isfinite(x) for x in losses + [gnorm]),
          f"dlrm.train: losses {losses}, grad norm {gnorm}")
    check(not any(launches.values()),
          f"dlrm.train: the DLRM path launched a search kernel: {launches}")
    check(seg > 0, "dlrm.train: the lookups' backward never launched "
          "segment_sum")
    differs = [k for k in first if first[k] != again[k]]
    check(not differs, f"dlrm.train: a second init and first step differ "
          f"from the first in {differs}")
    sharded = dlrm_row_sharded(dev, cfg, batch["sparse_ids"])
    return {"phase": "dlrm.train", "batch": B,
            "table_rows": sum(cfg.table_rows()),
            "table_gb": sum(cfg.table_rows()) * cfg.embed_dim * 4 / 1e9,
            "param_count": cfg.param_count(), "init_secs": init_secs,
            "step_secs": secs, "losses": losses, "grad_norm": gnorm,
            "max_memory_allocated": peak,
            "repeat_bit_equal": first == again,
            "repeat_differs_in": differs,
            "nondeterministic_ops": nondet,
            "port_kernel_launches": launches, "segment_sum_launches": seg,
            "row_sharded": sharded,
            "cuts": f"vocab_cap {VOCAB_CAP} a table (the full Criteo "
                    "vocabulary's 96 GB of tables do not fit one card, "
                    "before gradients and moments)",
            "secs": time.perf_counter() - t_phase}


# kernel classes of a profiled step by name, besides the set-up
STEP_CLASSES = (("segment_sum", ("segment_sum_kernel",)),
                ("searchsorted", ("searchsorted",)),
                ("sort", ("sort", "Sort", "radix", "Radix")),
                ("memset", ("Memset",)))
SETUP_RANGE = "segment_sum.runs"


def _step_class(name: str) -> str:
    return next((c for c, keys in STEP_CLASSES
                 if any(k in name for k in keys)), "other")


def step_device_profile(step):
    """One call of ``step`` (warmed by one call before) under
    torch.profiler, with every call of ``segment_sum.runs`` (the set-up,
    whether a lookup or the wrapper makes it) inside a ``SETUP_RANGE``
    range: wall ms, device busy ms, the step's peak memory, ``setup``: the
    device ms and count of every kernel launched inside those ranges (the
    cast, sort, searchsorted and the long-run list's small ops; by class
    in ``setup_by_class``), and each ``STEP_CLASSES`` class (by kernel
    name) and the rest, outside the set-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import segment_sum as K
    step()
    torch.cuda.synchronize()
    setup_fn, calls = K.runs, [0]

    def runs(*args, **kw):
        calls[0] += 1
        with record_function(SETUP_RANGE):
            return setup_fn(*args, **kw)
    torch.cuda.reset_peak_memory_stats()
    K.runs = runs
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _pad_launches(TRACE_PAD_LAUNCHES)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            _pad_launches(TRACE_PAD_LAUNCHES)
    finally:
        K.runs = setup_fn
    peak = torch.cuda.max_memory_allocated() / 1e9
    names = [c for c, _ in STEP_CLASSES] + ["other"]
    by = {c: {"device_ms": 0.0, "count": 0} for c in names}
    setup_by = {c: {"device_ms": 0.0, "count": 0} for c in names}
    events = prof.events()
    for e in events:
        if ("CUDA" not in str(e.device_type) or PAD_KERNEL in e.name
                or e.name == SETUP_RANGE
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        cls = by[_step_class(e.name)]
        cls["device_ms"] += us / 1e3
        cls["count"] += 1

    def under(e):                   # the event and every op inside it
        yield e
        for c in e.cpu_children:
            yield from under(c)
    ranges = [e for e in events if e.name == SETUP_RANGE
              and "CPU" in str(e.device_type)]
    for e in ranges:
        for op in under(e):
            for k in op.kernels:         # moved from its class to setup_by
                if PAD_KERNEL in k.name:
                    continue
                c, ms = _step_class(k.name), k.duration / 1e3
                setup_by[c]["device_ms"] += ms
                setup_by[c]["count"] += 1
                by[c]["device_ms"] -= ms
                by[c]["count"] -= 1
    setup = {"device_ms": sum(v["device_ms"] for v in setup_by.values()),
             "count": sum(v["count"] for v in setup_by.values())}
    check(calls[0] == 0 or setup["count"] > 0,
          f"step profile: {calls[0]} set-up calls, but no kernel was "
          f"found inside the {SETUP_RANGE} ranges ({len(ranges)} kept)")
    busy = sum(v["device_ms"] for v in by.values()) + setup["device_ms"]
    return {"wall_ms": wall, "device_busy_ms": busy, "peak_gb": peak,
            "setup_calls": calls[0], "setup": setup,
            "setup_by_class": setup_by, **by}


def segment_sum_step_profiles(dev):
    """One gin-tu ``ogb_products`` train step and one ``dlrm.train`` step
    (as the ``gnn`` and ``dlrm.train`` phases build them) under the
    profiler (``step_device_profile``): how much of each is the segment
    sum's kernel and how much its set-up (``segment_sum.runs``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.models import dlrm as M
    from repro_torch.models import gnn as G
    from repro_torch.train import optimizer as opt
    out = {}
    gen = torch.Generator(device=dev).manual_seed(4)
    spec = get_arch("gin-tu")
    n, e, n_pad, e_pad, f, c, g = gnn_dims(spec.shape("ogb_products"))
    cfg = dataclasses.replace(spec.model_cfg, n_classes=c)
    batch = graph_batch_on(dev, gen, n, e, n_pad, e_pad, f, c, g,
                           cfg.task)
    params = G.init_gnn(cfg, f, gen, dev)
    ocfg = opt.AdamWConfig()
    state = opt.adamw_init(params, ocfg)
    step = G.make_gnn_train_step(cfg, ocfg)
    out["gin-tu/ogb_products"] = step_device_profile(
        lambda: step(params, state, batch))
    del batch, params, state
    torch.cuda.empty_cache()
    arch = get_arch("dlrm-mlperf")
    dcfg = dataclasses.replace(arch.model_cfg, vocab_cap=VOCAB_CAP)
    B = arch.shape("train_batch").dims["batch"]
    nb = dlrm_batch(dcfg.n_dense, [min(v, VOCAB_CAP)
                                   for v in dcfg.vocab_sizes], B, seed=3)
    dbatch = {k: torch.as_tensor(v, device=dev) for k, v in nb.items()}
    dparams = M.init_dlrm(dcfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    dstate = opt.adamw_init(dparams, ocfg)
    dstep = M.make_dlrm_train_step(dcfg, ocfg, donate=True)
    held = {}

    def one():
        held["p"], held["s"], _ = dstep(held.get("p", dparams),
                                        held.get("s", dstate), dbatch)
    out["dlrm.train"] = step_device_profile(one)
    del dparams, dstate, held, dbatch
    torch.cuda.empty_cache()
    return out


DLRM_SLOTS = 4


def dlrm_row_sharded(dev, cfg, ids):
    """The row-sharded lookup (``dlrm.shard_tables`` over ``DLRM_SLOTS``
    slots of the one card, ``table_parallel_lookup``) at ``cfg``'s tables
    (4M rows) against the lookup of the whole tables (one slot): the 26
    embeddings [B, 128] and every table's gradient under one random
    output gradient must be bit-equal."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dlrm as M
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = M.init_dlrm(cfg, gen, device=dev)["tables"]
    g = [torch.randn((ids.shape[0], cfg.embed_dim), generator=gen,
                     device=dev) for _ in tables]

    def run(leaves):
        out = M.table_parallel_lookup(leaves, ids)
        torch.autograd.backward(out, g)
        return [o.detach() for o in out]

    whole = [t.requires_grad_() for t in tables]
    want = run(whole)
    placed = M.shard_tables([t.detach() for t in tables],
                            make_local_mesh(DLRM_SLOTS, device=dev))
    blocks = [tuple(b.detach().requires_grad_() for b in t) for t in placed]
    check(all(isinstance(t, tuple) for t in placed),
          "dlrm.row_sharded: every padded table should split into row "
          "blocks")
    got = run(blocks)
    torch.cuda.synchronize()
    fwd = all(bit_equal(a, b) for a, b in zip(got, want))
    bwd = all(bit_equal(b.grad, w.grad[s * b.shape[0]:(s + 1) * b.shape[0]])
              for t, w in zip(blocks, whole) for s, b in enumerate(t))
    check(fwd and bwd, f"dlrm.row_sharded: forward bit-equal {fwd}, "
          f"gradients bit-equal {bwd} at {DLRM_SLOTS} slots")
    del tables, whole, placed, blocks, got, want, g
    torch.cuda.empty_cache()
    return {"slots": DLRM_SLOTS, "table_rows": sum(cfg.table_rows()),
            "forward_bit_equal": fwd, "gradients_bit_equal": bwd,
            "secs": time.perf_counter() - t0}


def quickstart_phase(main_launches):
    """``examples/quickstart_torch.py`` as a subprocess on the card: exit
    0, its "CRouting skipped" line, and its fused engine's launches (its
    last line), which count in ``main_launches``."""
    import os
    import re
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    skipped = re.search(r"^CRouting skipped .*$", proc.stdout, re.M)
    counts = re.search(r"^kernel launches: (\{.*\})$", proc.stdout, re.M)
    launches = json.loads(counts.group(1)) if counts else {}
    row = {"phase": "quickstart", "rc": proc.returncode,
           "secs": time.perf_counter() - t0,
           "stdout": proc.stdout.strip().splitlines(),
           "stderr_tail": proc.stderr[-2000:] if proc.returncode else "",
           "launches": launches}
    emit(row)
    check(proc.returncode == 0 and skipped is not None,
          f"quickstart: rc {proc.returncode}, no 'CRouting skipped' line")
    check({k for k, v in launches.items() if v} ==
          {"fused_expand", "pool_merge"},
          f"quickstart: the fused engine launched {launches}")
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v


def router_sweep(main_launches):
    """The port's counterpart of ``benchmarks/bench_engine.py``'s
    ``engine_router_sweep``: every registered router on every engine at
    efs=64 on the same data and graph; each router's means beside the
    reference's in BENCH_engine.json (read as data): dist_calls within 1%,
    recall within 0.01 (a host BLAS can move a few HNSW edges)."""
    import torch
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.routers import available_routers
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import (exact_ground_truth, make_dataset,
                                          recall_at_k)
    from repro_torch.kernels import ops
    ref = json.loads((ROOT / "BENCH_engine.json").read_text())[
        "engine_router_sweep"]
    ds = make_dataset("sift-synth", n_base=4000, n_query=100, dim=128,
                      n_clusters=64, seed=0)
    t0 = time.perf_counter()
    idx = AnnIndex.build(ds.base, graph="hnsw", m=16, efc=128)
    build_secs = time.perf_counter() - t0
    gt = exact_ground_truth(ds, k=10)
    rows = {}
    for name in available_routers():
        kw = dict(k=10, efs=64, router=name)
        for engine in ("fused", "unfused", "torch"):
            spec = SearchSpec(engine=engine, **kw)
            idx.search(ds.queries, spec)           # tables to the card
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            ids, _, st = idx.search(ds.queries, spec)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            got = {k for k, v in launches.items() if v}
            check(got == expected_kernels(engine, kw),
                  f"router_sweep/{name}: the {engine} engine launched "
                  f"{sorted(got)}")
            if engine != "torch":
                for k, v in launches.items():
                    main_launches[k] = main_launches.get(k, 0) + v
            row = dict(st.summary(), recall=recall_at_k(ids, gt, 10))
            want = ref[name]
            row["reference"] = {k: want[k] for k in
                                ("dist_calls", "recall", "iters")}
            rows[f"{name}/{engine}"] = row
            rel = abs(row["dist_calls"] - want["dist_calls"]) / max(
                want["dist_calls"], 1e-9)
            check(rel <= 0.01 and abs(row["recall"] - want["recall"]) <= 0.01,
                  f"router_sweep/{name}/{engine}: dist_calls "
                  f"{row['dist_calls']} recall {row['recall']} vs "
                  f"BENCH_engine.json {want['dist_calls']} {want['recall']}")
    emit({"phase": "router_sweep", "n": 4000, "dim": 128, "m": 16,
          "efc": 128, "queries": 100, "efs": 64, "build_secs": build_secs,
          "theta_star": idx.profile.theta_star, "routers": rows})
    return rows


# --- phase 7: the dlrm-mlperf retrieval path ---------------------------------
VOCAB_CAP = 4_000_000     # 24.07M table rows, 12.3 GB fp32 (full: 96 GB)
# the example's n_cand is 100k; on the H100 machine's host its index took
# 657 s to build and the whole script 994 s, so the index was cut to 50k;
# at 50k it took 209 s of a 1,064 s script once the sharded and launch
# phases came, so it was cut to 25k; at 25k it took 120 s of a 1,239 s
# script once the lm phase came, so it is cut to 10k
ANN_CANDIDATES = 10_000
ANN_QUERIES = 1024


def serve_check(dev):
    """The DLRM serve step at full widths on ``serve_p99``; 16 rows held
    against the same function on the CPU with the table rows they touch
    copied over (ids remapped), rtol 1e-4."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm as M
    arch = get_arch("dlrm-mlperf")
    cfg = dataclasses.replace(arch.model_cfg, vocab_cap=VOCAB_CAP)
    B = arch.shape("serve_p99").dims["batch"]
    t0 = time.perf_counter()
    params = M.init_dlrm(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_secs = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    vocab = [min(v, cfg.vocab_cap) for v in cfg.vocab_sizes]
    sparse = np.stack([rng.integers(0, v, size=B) for v in vocab], axis=1)
    batch = {"dense": torch.as_tensor(dense, device=dev),
             "sparse_ids": torch.as_tensor(sparse, device=dev)}
    serve = M.make_dlrm_serve_step(cfg)
    scores = serve(params, batch)
    torch.cuda.synchronize()
    check(scores.shape == (B,) and bool(torch.isfinite(scores).all())
          and bool(((scores > 0) & (scores < 1)).all()),
          "retrieval/serve: scores not finite in (0, 1)")
    n = 16
    cols = [np.unique(sparse[:n, i], return_inverse=True)
            for i in range(cfg.n_sparse)]
    cpu_params = {
        "tables": [t[torch.as_tensor(u, device=dev)].cpu()
                   for t, (u, _) in zip(params["tables"], cols)],
        **{k: [{kk: v.cpu() for kk, v in layer.items()}
               for layer in params[k]] for k in ("bot", "top")}}
    cpu_scores = serve(cpu_params, {
        "dense": torch.as_tensor(dense[:n]),
        "sparse_ids": torch.as_tensor(np.stack([inv for _, inv in cols],
                                               axis=1))})
    err = float((scores[:n].cpu() - cpu_scores).abs().max())
    check(torch.allclose(scores[:n].cpu(), cpu_scores, rtol=1e-4, atol=0.0),
          f"retrieval/serve: 16 rows differ from the CPU by up to {err}")
    row = {"batch": B, "table_rows": sum(cfg.table_rows()),
           "table_gb": sum(cfg.table_rows()) * cfg.embed_dim * 4 / 1e9,
           "param_count": cfg.param_count(), "init_secs": init_secs,
           "score_mean": float(scores.mean()), "cpu_max_abs_err": err,
           "serve_ms": cuda_times(lambda: serve(params, batch), 20),
           "cuts": f"vocab_cap {VOCAB_CAP} a table (187.8M rows, 96 GB at "
                   "the full Criteo vocabulary do not fit one 80 GB card)"}
    del params
    torch.cuda.empty_cache()
    return row


def topk_agrees(ker_ids, ref_ids, ref_scores, q, cands, tol=1e-6):
    """Each row's top-k id set from the kernel equals the retrieval step's,
    except for ids whose exact (float64) score is within ``tol`` of the
    step's k-th score (ties).  Returns (ids swapped, worst gap)."""
    swapped, worst = 0, 0.0
    for r in range(ker_ids.shape[0]):
        diff = sorted(set(ker_ids[r].tolist()) ^ set(ref_ids[r].tolist()))
        if diff:
            s = cands[diff].double() @ q[r].double()
            worst = max(worst, float((s - ref_scores[r, -1].double())
                                     .abs().max()))
            swapped += len(diff)
    check(worst <= tol, f"retrieval: kernel top-k differs from the retrieval "
          f"step beyond ties (score gap {worst})")
    return swapped, worst


def unit_rows_on(dev, gen, n, d=128):
    import torch
    x = torch.randn((n, d), generator=gen, device=dev)
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def retrieval_phase(dev, main_launches, captures):
    """Serve, brute force and the ip index of the retrieval path (with
    ``captures`` around its searches, as in ``search_phase``); returns the
    brute-force inputs for the timing phase."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.index import AnnIndex
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm as M
    arch = get_arch("dlrm-mlperf")
    n_cand = arch.shape("retrieval_cand").dims["n_candidates"]
    k = 100
    step = M.make_retrieval_step(arch.model_cfg, k=k)
    gen = torch.Generator(device=dev).manual_seed(2)
    cands = unit_rows_on(dev, gen, n_cand)                 # 512 MB
    queries = unit_rows_on(dev, gen, 32)

    # the path: serve, brute force at retrieval_cand (1 query, the
    # example's 32), and the example's 8 x 8192 block
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    serve = serve_check(dev)
    brute = []
    for nq in (1, 32):
        q = queries[:nq]
        ref_scores, ref_ids = step(q, cands)
        _, ker_ids = torch.topk(ops.l2_distance(q, cands, mode="ip"), k,
                                dim=1, largest=False)
        swapped, gap = topk_agrees(ker_ids.cpu(), ref_ids.cpu(), ref_scores,
                                   q, cands)
        brute.append({"queries": nq, "candidates": n_cand, "k": k,
                      "ids_swapped_by_ties": swapped, "worst_tie_gap": gap})
    block = ops.l2_distance(queries[:8], cands[:8192], mode="ip")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["l2_distance"] > 0 and
          {n for n, v in launches.items() if v} == {"l2_distance"},
          f"retrieval: the path launched {launches}")
    main_launches["l2_distance"] = (main_launches.get("l2_distance", 0)
                                    + launches["l2_distance"])
    emit({"phase": "retrieval", "part": "serve_and_brute_force",
          "serve_p99": serve, "brute_force": brute,
          "block": list(block.shape), "launches": launches})

    # the example's index: metric="ip", HNSW m=16, efc=96
    rng = np.random.default_rng(0)
    base = rng.normal(size=(ANN_CANDIDATES, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    qs = rng.normal(size=(ANN_QUERIES, 128)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    t0 = time.perf_counter()
    idx = AnnIndex.build(base, graph="hnsw", metric="ip", m=16, efc=96,
                         device=dev)
    build_secs = time.perf_counter() - t0
    _, gt = step(torch.as_tensor(qs, device=dev),
                 torch.as_tensor(base, device=dev))
    emit({"phase": "retrieval", "part": "ann_index", "n": ANN_CANDIDATES,
          "dim": 128, "metric": "ip", "m": 16, "efc": 96,
          "build_secs": build_secs,
          "levels": idx.graph.build_stats["levels"],
          "theta_star": idx.profile.theta_star, "queries": ANN_QUERIES,
          "cuts": "n 100k (the example) -> 10k (50k until the sharded "
                  "and launch phases came, 25k until the lm phase came), "
                  "and not retrieval_cand's 1M: the host HNSW builder"})
    search_phase("retrieval", idx, qs, gt.cpu().numpy(), main_launches,
                 captures=captures, specs=IP_SPECS,
                 unfused_specs=IP_UNFUSED_SPECS, k=k)
    return cands, queries, idx, qs


# --- the cosine phase: a cosine index's query batches through search_on -------
COS_BASE, COS_QUERIES, COS_DIM, COS_CALLS = 50_000, 10_000, 1536, 3


def cosine_phase(dev, main_launches):
    """A K-NN cosine index at the dbpedia500k cell's width (d 1,536; its
    rows cut to ``COS_BASE``; rows of intrinsic dimension 32, as
    embeddings have few, so that the search finds their neighbours) searched through ``AnnIndex.search`` (so
    ``search_on``) at the cell's batch, [10,000, 1,536] unnormalised
    float32, ``COS_CALLS`` times: ``normalize_rows`` must launch once a
    call and ``search.normalised_rows`` grow by the batch's rows; the
    engine's library load falls in set-up (the library is held before the
    first call); the ids' recall@10 is above 0.5 and equals, within 1e-3,
    that of the same engine fed the rows normalised on the host."""
    import numpy as np
    import torch
    from repro_torch import trace
    from repro_torch.core import distances as D
    from repro_torch.core.angles import sample_angle_profile
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.search import build_search_fn
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import recall_at_k
    from repro_torch.kernels import build
    from repro_torch.kernels import normalize_rows as K
    rng = np.random.default_rng(30)
    mix = rng.standard_normal((32, COS_DIM)).astype(np.float32)
    base = rng.standard_normal((COS_BASE, 32)).astype(np.float32) @ mix
    queries = rng.standard_normal((COS_QUERIES, 32)).astype(np.float32) @ mix
    t0 = time.perf_counter()
    idx = AnnIndex.build(base, graph="knn", k=64, metric="cosine",
                         profile=False, device=dev)
    idx.profile = sample_angle_profile(idx.graph, n_sample=64, seed=0)
    torch.cuda.synchronize()
    build_secs = time.perf_counter() - t0
    unit = torch.as_tensor(D.preprocess_vectors(base, "cosine"), device=dev)
    unit_q = D.preprocess_vectors(queries, "cosine")
    gt = torch.topk(torch.as_tensor(unit_q, device=dev) @ unit.T, 10,
                    dim=1).indices.cpu().numpy()
    del unit
    spec = SearchSpec(k=10, efs=128, router="crouting", beam_width=4)
    _, fn = build_search_fn(idx.graph, idx.engine_spec(spec), device=dev)
    with build._lock:
        loaded = "normalize_rows" in build._LIBS
    check(loaded, "cosine: setting up a CUDA cosine engine did not load "
          "normalize_rows")
    idx.search(queries, spec)                       # the warm call
    torch.cuda.synchronize()
    K.reset_launch_counts()
    rows0 = trace.totals().get("search.normalised_rows", 0)
    secs = []
    for _ in range(COS_CALLS):
        t0 = time.perf_counter()
        ids, _, _ = idx.search(queries, spec)
        secs.append(time.perf_counter() - t0)
    launches = K.LAUNCHES["normalize_rows"]
    rows = trace.totals().get("search.normalised_rows", 0) - rows0
    check(launches == COS_CALLS and rows == COS_CALLS * COS_QUERIES,
          f"cosine: {launches} normalize_rows launches and {rows} rows "
          f"normalised for {COS_CALLS} calls of {COS_QUERIES} rows")
    main_launches["normalize_rows"] = (main_launches.get("normalize_rows", 0)
                                       + launches)
    res = fn(unit_q, idx.profile.cos_theta_star)
    host_ids = res.ids[:, :10].cpu().numpy().astype(np.int64)
    card, host = recall_at_k(ids, gt, 10), recall_at_k(host_ids, gt, 10)
    check(card > 0.5 and abs(card - host) <= 1e-3,
          f"cosine: recall@10 {card} with the rows normalised on the card, "
          f"{host} on the host")
    emit({"phase": "cosine", "n": COS_BASE, "dim": COS_DIM, "graph": "knn",
          "k": 64, "queries": COS_QUERIES, "build_secs": build_secs,
          "calls": COS_CALLS, "normalize_rows_launches": launches,
          "normalised_rows": rows, "call_secs": secs,
          "recall_card": card, "recall_host": host,
          "cuts": "dbpedia500k's 500,000 rows -> 50,000; profile from 64 "
                  "sampled searches"})


WRAPPERS = ("fused_expand", "pool_merge", "sq8_estimate",
            "gather_distance_where", "crouting_prune")


class CaptureInputs:
    """Record the arguments of the N-th call of each kernel wrapper, per
    lane width of its first argument, during a main-path run (the last call
    if there are fewer), for timing the kernels on real inputs.  Tensors of
    more than 2**24 elements (the vector and code tables) are kept by
    reference: the search never writes them.  A replayed CUDA graph calls
    no wrapper, so it wraps an eager pass of its own, off the counts and
    the clock, under ``eager_twin``'s router; the counted run replays."""

    def __init__(self, nth: int = 30):
        self.nth = nth
        self.args = {}

    def get(self, name, width=None):
        keys = [k for k in self.args if k[0] == name
                and (width is None or k[1] == width)]
        check(len(keys) == 1, f"capture: {name} width={width} has {keys}")
        return self.args[keys[0]]

    def __enter__(self):
        from repro_torch.kernels import ops
        self._orig = {w: getattr(ops, w) for w in WRAPPERS}
        calls = {}

        def keep(x):
            if not hasattr(x, "clone") or x.numel() > 2 ** 24:
                return x
            if x.is_contiguous() or x.numel() == 0:
                return x.clone()
            # a strided view (an operand expanded over lanes): copy the
            # storage it spans and keep its strides
            import torch
            span = 1 + sum((n - 1) * st for n, st in zip(x.shape,
                                                         x.stride()))
            flat = torch.as_strided(x, (span,), (1,),
                                    x.storage_offset()).clone()
            return torch.as_strided(flat, x.shape, x.stride())

        def wrap(name):
            orig = self._orig[name]

            def f(*a, **kw):
                key = (name, int(a[0].shape[1]))
                calls[key] = calls.get(key, 0) + 1
                if calls[key] <= self.nth:
                    self.args[key] = ([keep(x) for x in a],
                                      {k: keep(v) for k, v in kw.items()})
                return orig(*a, **kw)
            return f
        for w in WRAPPERS:
            setattr(ops, w, wrap(w))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for w, f in self._orig.items():
            setattr(ops, w, f)
        return False


@contextlib.contextmanager
def eager_twin(kw):
    """``kw`` with its router replaced by a copy that does not declare
    itself ``graph_safe``, registered for the block: the same search, with
    every iteration's kernels launched from Python, where a
    ``CaptureInputs`` sees them."""
    import dataclasses
    from repro_torch.core import routers as R
    name = kw["router"] + ".eager"
    R.register_router(dataclasses.replace(
        R.get_router(kw["router"]), name=name, graph_safe=False))
    try:
        yield dict(kw, router=name)
    finally:
        R.unregister_router(name)


KERNEL_FILES = {
    "fused_expand": "src/repro/kernels/fused_expand.py:106",
    "pool_merge": "src/repro/kernels/pool_merge.py:95",
    "sq8_distance": "src/repro/kernels/sq8_distance.py:87",
    "gather_distance": "src/repro/kernels/gather_distance.py:53",
    "crouting_prune": "src/repro/kernels/crouting_prune.py:54",
    "l2_distance": "src/repro/kernels/l2_distance.py:65",
    # no Pallas kernel: where the reference sums rows by id (XLA scatter-add)
    "segment_sum": "src/repro/models/dlrm.py:104",
    # no Pallas kernel: where the reference normalises cosine rows (NumPy)
    "normalize_rows": "src/repro/core/distances.py:110"}
NO_LIBRARY_CALL = {
    "fused_expand": "no single PyTorch call: a row gather under a computed "
                    "prune mask, then a distance",
    "pool_merge": "no single PyTorch call: a lexicographic (dist, id) "
                  "merge needs a concat and two sorts",
    "sq8_distance": "no single PyTorch call: a uint8 row gather, a "
                    "dequantization and two sums",
    "gather_distance": "no single PyTorch call: a row gather under a skip "
                       "mask, then a distance",
    "crouting_prune": "no single PyTorch call: an elementwise estimate and "
                      "a comparison are several ops"}


def timed_row(name, kernel, plain, nbytes, flops, err, shape, flush=None,
              library=None, library_note=None):
    """One kernel-table row: the kernel's, the plain version's and (where
    one PyTorch call computes the same function) that call's median time,
    and the bound (the larger of bytes over HBM rate and flops over the
    fp32 rate), on the same inputs."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    device_ms, kept = kernel_device_ms(kernel, f"{name}_kernel", before=flush)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": KERNEL_FILES[name], "max_abs_err": err,
            "ms": cuda_times(kernel, 200, flush),
            "device_ms": device_ms, "device_kept": kept,
            "plain_ms": cuda_times(plain, 50, flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": (None if library is None
                           else cuda_times(library, 200, flush)),
            "library_note": library_note or NO_LIBRARY_CALL[name],
            "shape": shape}


def operand_bytes(x):
    """Bytes of the distinct elements a tensor holds (an expanded view
    counts its source once)."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        n *= size if stride else 1
    return n * x.element_size()


def wrapper_row(call, flush, reps: int = 50, tries: int = 3):
    """All device time and kernels of one wrapper call (``call``), from
    torch.profiler behind the L2 flush; the flush's own kernels (named by a
    profile of the flush alone) are left out.  A window that kept fewer
    kernels than calls is taken again, up to ``tries`` windows, and the
    fullest is used; ``wrapper_kept``: its kernels over the calls made."""
    flush_names = {n for n, _ in traced_kernels(flush, reps)}

    def both():
        flush()
        call()
    ours = []
    for _ in range(tries):
        got = [(n, us) for n, us in traced_kernels(both, reps)
               if n not in flush_names]
        ours = max(ours, got, key=len)
        if len(ours) >= reps:
            break
    return {"wrapper_device_ms": sum(us for _, us in ours) / reps / 1e3,
            "wrapper_launches": len(ours) / reps,
            "wrapper_kept": f"{len(ours)}/{reps}",
            "wrapper_kernels": sorted({n[:60] for n, _ in ours})}


def time_fused_expand(capture, flush):
    import torch
    from repro_torch.kernels import fused_expand as FE
    from repro_torch.kernels import ops, ref
    a, kw = capture.get("fused_expand")
    args = ops.cuda_args_fused_expand(*a, **kw)
    plain_args = ops.prepare_fused_expand(*a, **kw)
    nbrs, q, ed, dcq, bound2, _, table, ev, pe, _ = args
    B, L = nbrs.shape
    d = q.shape[1]
    kd, kp = FE.fused_expand_cuda(*args)
    pd, pp = ref.fused_expand_ref(*plain_args)
    check(bit_equal(kp, pp) and bit_equal(kd, pd),
          "timing: fused_expand not bit-equal on captured inputs")
    computed = int(torch.isfinite(pd).sum())
    # bytes: computed rows + each operand as handed over (nbrs, ed, dcq
    # [B, W] over M, bound2 [B] over L, one-byte masks) + the queries in;
    # dist2 (4 B) and prune (1 B) a lane out
    side = sum(operand_bytes(x) for x in (nbrs, ed, dcq, bound2, ev, pe)
               if x is not None)
    nbytes = computed * d * 4 + side + B * d * 4 + B * L * 5
    flops = computed * 3 * d + B * L * 8
    row = timed_row("fused_expand", lambda: FE.fused_expand_cuda(*args),
                    lambda: ref.fused_expand_ref(*plain_args), nbytes, flops,
                    0.0, {"B": B, "L": L, "d": d,
                          "table_rows": table.shape[0],
                          "computed_lanes": computed,
                          "pruned_lanes": int(kp.sum()),
                          "kernel_prunes": pe is not None}, flush)
    row.update(wrapper_row(lambda: ops.fused_expand(*a, **kw), flush))
    row["empty_launch_ms"], row["empty_launch_kept"] = kernel_device_ms(
        lambda: FE.empty_launch(B, L), "fused_expand_empty", before=flush)
    # round trip 1 alone: the same call with every lane masked reads no row
    none = ops.cuda_args_fused_expand(*a, **dict(
        kw, eval_mask=torch.zeros((B, L), dtype=torch.bool, device=q.device)))
    row["no_rows_device_ms"], row["no_rows_kept"] = kernel_device_ms(
        lambda: FE.fused_expand_cuda(*none), "fused_expand_kernel",
        before=flush)
    return row


def time_pool_merge(capture):
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_merge import choose_variant, pool_merge_cuda
    a, _ = capture.get("pool_merge")
    margs = (a[0].float().contiguous(), a[1].int().contiguous(),
             a[2].float().contiguous(), a[3].int().contiguous())
    B, P = margs[0].shape
    L = margs[2].shape[1]
    kd, ki = pool_merge_cuda(*margs)
    pd, pi = ref.pool_merge_ref(*margs)
    check(bit_equal(kd, pd) and bit_equal(ki, pi),
          "timing: pool_merge not bit-exact on captured inputs")
    sorted_rows = int(rows_sorted(margs[0], margs[1]).sum())
    return timed_row("pool_merge", lambda: pool_merge_cuda(*margs),
                     lambda: ref.pool_merge_ref(*margs),
                     B * (P + L) * 8 + B * P * 8, 0, 0.0,
                     {"B": B, "P": P, "L": L,
                      "variant": choose_variant(P, L)[0],
                      "sorted_pool_rows": sorted_rows})


def rows_sorted(d, i):
    """Per row: whether the pool is sorted by (dist, id)."""
    d0, d1, i0, i1 = d[:, :-1], d[:, 1:], i[:, :-1], i[:, 1:]
    return ((d0 < d1) | ((d0 == d1) & (i0 <= i1))).all(dim=1)


def time_sq8_distance(capture, flush):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sq8_distance as SK
    a, kw = capture.get("sq8_estimate")
    args = ops.cuda_args_sq8_estimate(*a, **kw)
    plain_args = ops.prepare_sq8_estimate(*a, **kw)
    nbrs, q, ev = args[:3]
    B, L = nbrs.shape
    d = q.shape[1]
    ka, kl = SK.sq8_distance_cuda(*args)
    pa, pl = ref.sq8_estimate_ref(*plain_args)
    check(bit_equal(ka, pa) and bit_equal(kl, pl),
          "timing: sq8_distance not bit-equal on captured inputs")
    evaluated = int(torch.isfinite(pa).sum())
    # bytes: evaluated code rows + nbrs (4 B) and eval (1 B) a lane + the
    # queries and the three [d] grid arrays in; ad2, lb2 (4 B each) out
    nbytes = evaluated * d + B * L * 5 + B * d * 4 + 3 * d * 4 + B * L * 8
    flops = evaluated * d * 8 + B * L * 3
    row = timed_row("sq8_distance", lambda: SK.sq8_distance_cuda(*args),
                    lambda: ref.sq8_estimate_ref(*plain_args), nbytes, flops,
                    0.0, {"B": B, "L": L, "d": d,
                          "code_rows": args[3].shape[0],
                          "evaluated_lanes": evaluated}, flush)
    row.update(wrapper_row(lambda: ops.sq8_estimate(*a, **kw), flush))
    row["empty_launch_ms"], row["empty_launch_kept"] = kernel_device_ms(
        lambda: SK.empty_launch(B, L), "sq8_distance_empty", before=flush)
    # round trip 1 alone: the same call with every lane masked reads no row
    none = (args[0], q, torch.zeros((B, L), dtype=torch.bool,
                                    device=q.device), *args[3:])
    row["no_rows_device_ms"], row["no_rows_kept"] = kernel_device_ms(
        lambda: SK.sq8_distance_cuda(*none), "sq8_distance_kernel",
        before=flush)
    return row


def time_gather_distance(capture, width, flush, what):
    import torch
    from repro_torch.kernels import gather_distance as GD
    from repro_torch.kernels import ops
    a, kw = capture.get("gather_distance_where", width)
    ids, compute, q, table = a
    args = ops.cuda_args_gather_distance(ids, q, table, compute, True)
    B, M = ids.shape
    d = q.shape[1]
    kd = GD.gather_distance_cuda(*args)
    pd = gather_plain(ids, q, table, compute, True)
    check(bit_equal(kd, pd), f"timing: gather_distance ({what}) not "
          "bit-equal on captured inputs")
    computed = int(torch.isfinite(pd).sum())
    # bytes: computed rows + ids and the compute mask as handed over + the
    # queries in; dist2 (4 B a lane) out
    nbytes = (computed * d * 4 + operand_bytes(args[0])
              + operand_bytes(args[3]) + B * d * 4 + B * M * 4)
    row = timed_row("gather_distance", lambda: GD.gather_distance_cuda(*args),
                    lambda: gather_plain(ids, q, table, compute, True),
                    nbytes, computed * 3 * d, 0.0,
                    {"call": what, "B": B, "M": M, "d": d,
                     "computed_lanes": computed}, flush)
    row.update(wrapper_row(lambda: ops.gather_distance_where(*a, **kw),
                           flush))
    row["empty_launch_ms"], row["empty_launch_kept"] = kernel_device_ms(
        lambda: GD.gather_distance_empty_launch(B, M),
        "gather_distance_empty", before=flush)
    # round trip 1 alone: the same call with every lane masked reads no row
    none = ops.cuda_args_gather_distance(
        ids, q, table, torch.zeros((B, M), dtype=torch.bool,
                                   device=q.device), True)
    row["no_rows_device_ms"], row["no_rows_kept"] = kernel_device_ms(
        lambda: GD.gather_distance_cuda(*none), "gather_distance_kernel",
        before=flush)
    return row


def time_crouting_prune(capture):
    """On the captured unfused tile, with no L2 flush: the operands were
    just written by the hop loop."""
    from repro_torch.kernels import crouting_prune as CP
    from repro_torch.kernels import ops, ref
    a, kw = capture.get("crouting_prune")
    args = ops.cuda_args_crouting_prune(*a, **kw)
    plain = ops.prepare_crouting_prune(*a, **kw)
    ed, dcq, bound2, valid, _ = args
    B, L = valid.shape
    ke, kp = CP.crouting_prune_cuda(*args)
    pe, pp = ref.crouting_prune_ref(*plain)
    check(bit_equal(ke, pe) and bit_equal(kp, pp),
          "timing: crouting_prune not bit-equal on captured inputs")
    # bytes: ed, dcq, bound2 and valid as handed over (dcq [B, W] over M,
    # bound2 [B] over L under l2) in; est2 (4 B) and prune (1 B) a lane out
    nbytes = sum(operand_bytes(x) for x in (ed, dcq, bound2, valid)) \
        + B * L * 5
    row = timed_row("crouting_prune", lambda: CP.crouting_prune_cuda(*args),
                    lambda: ref.crouting_prune_ref(*plain), nbytes,
                    B * L * 7, 0.0,
                    {"B": B, "L": L, "pruned_lanes": int(kp.sum()),
                     "operands": [list(x.shape) for x in (ed, dcq, bound2)]})
    row.update(wrapper_row(lambda: ops.crouting_prune(*a, **kw),
                           lambda: None))
    row["empty_launch_ms"], row["empty_launch_kept"] = kernel_device_ms(
        lambda: CP.crouting_prune_empty_launch(B, L), "crouting_prune_empty")
    # the same kernel on dense [B, L] copies of ed, dcq and bound2: what
    # reading them through their strides costs
    dense = ops.cuda_args_crouting_prune(
        *(x.reshape(B, -1).expand(B, L).contiguous() for x in a[:3]),
        *a[3:], **kw)
    de, dp = CP.crouting_prune_cuda(*dense)
    check(bit_equal(de, pe) and bit_equal(dp, pp),
          "timing: crouting_prune on dense operands not bit-equal")
    row["dense_operands_device_ms"], row["dense_operands_kept"] = \
        kernel_device_ms(lambda: CP.crouting_prune_cuda(*dense),
                         "crouting_prune_kernel")
    return row


def time_l2_distance(q, x, flush=None):
    """l2_distance in ip mode (the retrieval path's mode) beside
    ``torch.addmm(1, q, x^T, alpha=-1)``: cuBLAS fp32 with TF32 off, one
    PyTorch call computing the same function, which the port never calls."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2_distance import choose_variant, \
        l2_distance_cuda
    Q, d = q.shape
    C = x.shape[0]
    one = torch.ones((1, 1), device=q.device)
    got = l2_distance_cuda(q, x, "ip")
    exp = ref.l2_distance_ref(q, x, "ip")
    lib = torch.addmm(one, q, x.T, alpha=-1)
    err, ratio = l2_errors(got, exp, d)
    check(ratio <= 1.0 and l2_errors(lib, exp, d)[1] <= 1.0,
          f"timing: l2_distance [{Q}, {C}, {d}] disagrees (err {err})")
    return timed_row("l2_distance", lambda: l2_distance_cuda(q, x, "ip"),
                     lambda: ref.l2_distance_ref(q, x, "ip"),
                     4 * (Q * d + C * d + Q * C), 2 * Q * C * d, err,
                     {"Q": Q, "C": C, "d": d, "mode": "ip",
                      "variant": choose_variant(Q, C, d, 4, x.data_ptr())},
                     flush,
                     library=lambda: torch.addmm(one, q, x.T, alpha=-1),
                     library_note="torch.addmm(ones, q, x.T, alpha=-1), "
                                  "cuBLAS fp32, TF32 off")


def l2_crossover(cands, queries, flush):
    """The streaming and the tiled kernel, ip mode, at [Q, C, 128] for Q
    and C on both sides of ``choose_variant``'s split: where the streaming
    kernel stops paying.  Both are launched through the C entry point with
    the variant given, past the chooser, here only; C below 1M is flushed
    from the L2 before each launch."""
    import torch
    from repro_torch.kernels import l2_distance as L2K
    launch = L2K._lib()

    def run(q, x, variant):
        out = torch.empty((q.shape[0], x.shape[0]), device=q.device)
        err = launch(q.data_ptr(), x.data_ptr(), out.data_ptr(), q.shape[0],
                     x.shape[0], q.shape[1], L2K.MODES.index("ip"), 0,
                     L2K.VARIANTS.index(variant),
                     torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"l2_crossover: {variant} launch failed ({err})")
        return out

    rows = []
    for C in (8192, 32_768, 65_536, 131_072, 1_000_000):
        x = cands[:C]
        before = flush if C < 1_000_000 else None
        for Q in (1, 4, 8, 12, L2K.STREAM_MAX_Q):
            q = queries[:Q]
            row = {"Q": Q, "C": C, "chosen": L2K.choose_variant(
                Q, C, q.shape[1], 4, x.data_ptr())}
            for v in ("stream", "tiled"):
                fn = lambda: run(q, x, v)              # noqa: E731
                row[f"{v}_ms"] = cuda_times(fn, 100, before)
                row[f"{v}_device_ms"], row[f"{v}_kept"] = kernel_device_ms(
                    fn, "l2_distance_kernel", before=before)
            rows.append(row)
    return rows


def timing_phase(captures, main_launches, cands, queries):
    """Each kernel against its plain version and its bound on inputs
    captured from the knn_1m main path (l2_distance on the retrieval
    phase's candidates and queries; fused_expand and pool_merge also on the
    NSG build's candidate acquisition, B = 512, efs = 500).  Returns the kernel table: one row
    per kernel (its first timing), with the other timings under
    ``other_shapes`` and the main path's launch count."""
    import torch
    w4, w1 = captures[("W4", "fused")], captures[("W1", "fused")]
    both, unf = captures[("W4_both", "fused")], captures[("W4", "unfused")]
    nsg = captures[("nsg", "build")]
    W, efs = SPECS["W4_both"]["beam_width"], SPECS["W4_both"]["efs"]
    L = unf.get("crouting_prune")[0][3].shape[1]
    # 64 MB written between timed launches evicts the 50 MB L2: the hop
    # loop's row reads are first touches
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                        device="cuda").zero_
    rows = {
        "fused_expand": [time_fused_expand(w4, flush),
                         time_fused_expand(w1, flush),
                         time_fused_expand(nsg, flush)],
        "pool_merge": [time_pool_merge(w4), time_pool_merge(w1),
                       time_pool_merge(both),
                       time_pool_merge(captures[("ip_W4", "fused")]),
                       time_pool_merge(nsg)],
        "sq8_distance": [time_sq8_distance(both, flush)],
        "gather_distance": [
            time_gather_distance(both, W, flush, "in-loop rerank [B, W]"),
            time_gather_distance(both, efs, flush, "final rerank [B, efs]"),
            time_gather_distance(unf, L, flush, "unfused exact [B, W*M]")],
        "crouting_prune": [time_crouting_prune(unf)],
        # 512 MB of candidates exceed the L2; the 4 MB block is flushed
        "l2_distance": [time_l2_distance(queries[:1], cands),
                        time_l2_distance(queries, cands),
                        time_l2_distance(queries[:8], cands[:8192], flush)],
        "segment_sum": time_segment_sum(),
        "normalize_rows": [time_normalize_rows(flush)]}
    emit({"phase": "timing", "kernels": rows,
          "l2_crossover": l2_crossover(cands, queries, flush),
          "event_floor": event_floor_ms()})
    table = []
    for name, rs in rows.items():
        row = dict(rs[0])
        row["launches"] = main_launches[name]
        row["other_shapes"] = [
            {k: r[k] for k in ("shape", "ms", "device_ms", "device_kept",
                               "plain_ms", "bound_ms", "library_ms")}
            for r in rs[1:]]
        table.append(row)
    return table


# --- the cells phase: the dry run's bounds beside what the card measured -----
ANNS_ROWS = 200_000      # serve_100m_gist's 100M rows cut to one slot's worth
ANNS_PROFILE_QUERIES = 32


def _cut_cell(arch_id, shape_id, cfg=None, **dims):
    """``build_cell`` at one card on the named shape with ``dims``
    replaced (the dims a phase ran at), and ``cfg`` for the model's."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_cell
    spec = get_arch(arch_id)
    shape = spec.shape(shape_id)
    cut = dataclasses.replace(shape, dims={**shape.dims, **dims})
    spec = dataclasses.replace(spec, shapes=(cut,),
                               model_cfg=cfg or spec.model_cfg)
    return build_cell(spec, shape_id, SH.mesh_shape("single"))


def anns_cell(dev, main_launches):
    """The ANNS cell through ``build_cell`` at ``serve_100m_gist``'s widths
    (dim 960, max degree 32, B 256, efs 128, crouting, the fused engine),
    its rows cut to ``ANNS_ROWS`` on one slot: an exact K-NN graph (k =
    32, ``core/knn_graph.py``) built on the card, stacked by
    ``stack_shards`` into the cell's thirteen arguments (each held to the
    cell's meta shape and dtype), one warm batch and three timed ones.
    The fused kernels must launch, and the plain (``torch``) engine on the
    same arguments must return the same ids (>= 99% of queries) and the
    same counters; recall@10 against exact ground truth is printed (one
    Gaussian cloud, as knn_1m draws it).  Returns (row, the cell, the median batch
    seconds)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.angles import sample_angle_profile
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.core.sharded_index import stack_shards
    from repro_torch.core.spec import SearchSpec
    from repro_torch.models.api import make_anns_serve
    from repro_torch.data.vectors import (exact_ground_truth, make_dataset,
                                          recall_at_k)
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    cell = _cut_cell("crouting-anns", "serve_100m_gist", n_total=ANNS_ROWS)
    (vec_spec, *_), B = cell.arg_specs, cell.arg_specs[10].shape[0]
    dim = vec_spec.shape[2]
    t0 = time.perf_counter()
    ds = make_dataset(n_base=ANNS_ROWS, n_query=B, dim=dim, n_clusters=1,
                      seed=0)
    data_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_knn_graph(ds.base, k=cell.arg_specs[1].shape[2], device=dev)
    knn_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = sample_angle_profile(g, n_sample=ANNS_PROFILE_QUERIES, seed=0)
    prof_secs = time.perf_counter() - t0
    arr = stack_shards([g], [prof])

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    args = [t(arr.vectors, torch.float32), t(arr.neighbors, torch.int32),
            t(arr.edge_eu, torch.float32), t(arr.norms, torch.float32),
            t(arr.entries, torch.int32), t(arr.offsets, torch.int32),
            t(arr.sq8_codes, torch.uint8), t(arr.sq8_lo, torch.float32),
            t(arr.sq8_scale, torch.float32), t(arr.sq8_eps, torch.float32),
            t(ds.queries, torch.float32),
            torch.tensor(arr.cos_theta, dtype=torch.float32, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev)]
    for i, (a, want) in enumerate(zip(args, cell.arg_specs)):
        check(a.shape == want.shape and a.dtype == want.dtype,
              f"cells/anns: argument {i} is {a.dtype} {tuple(a.shape)}, "
              f"the cell's is {want.dtype} {tuple(want.shape)}")
    ops.reset_launch_counts()
    out = cell.step_fn(*args)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = cell.step_fn(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    check(launches["fused_expand"] > 0 and launches["pool_merge"] > 0,
          f"cells/anns: the fused engine's kernels did not launch: {launches}")
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v
    dists, ids, counters = out
    # the plain engine on the same arguments: the same pool and counters
    plain = make_anns_serve(dataclasses.replace(
        SearchSpec(efs=128, k=10, router="crouting", metric="l2",
                   max_hops=256, use_hierarchy=False),
        engine="torch").canonical(), ANNS_ROWS)(*args)
    same_ids = float((ids == plain[1]).all(1).float().mean())
    check(bool(torch.isfinite(dists[:, :10]).all()) and same_ids >= 0.99
          and counters == plain[2],
          f"cells/anns: fused against torch: {same_ids} of queries with "
          f"equal ids, counters {counters} against {plain[2]}")
    gt = exact_ground_truth(ds, k=10, device=dev)
    recall = recall_at_k(ids[:, :10].cpu().numpy(), gt, 10)
    row = {"phase": "cells.anns", "rows": ANNS_ROWS, "dim": dim,
           "batch": B, "efs": 128, "max_degree": g.max_degree,
           "data_secs": data_secs, "knn_build_secs": knn_secs,
           "profile_secs": prof_secs, "theta_star": prof.theta_star,
           "batch_secs": secs, "recall_at_10": recall,
           "ids_equal_to_torch_engine": same_ids,
           "counters_per_query": {
               n: c / B for n, c in zip(
                   ("dist_calls", "est_calls", "rerank_calls", "sq8_calls",
                    "hops"), counters[:5])},
           "iters": counters[5], "launches": launches,
           "vector_gb": ANNS_ROWS * dim * 4 / 1e9,
           "cuts": "serve_100m_gist's 100M rows over the mesh -> 200,000 "
                   "rows, one slot (768 MB of vectors plus the SQ8 codes); "
                   f"exact K-NN graph instead of HNSW; angle profile from "
                   f"{ANNS_PROFILE_QUERIES} sampled searches",
           "secs": time.perf_counter() - t_phase}
    return row, cell, statistics.median(secs)


def cells_phase(dev, lm_rows, gnn_rows, dlrm_row, main_launches):
    """The dry run's one-H100 bound (``launch/dryrun.cell_terms``:
    ``step_time_lb_s``, ``dominant``) of each step a phase measured, at the
    dims it ran, beside its measured seconds (taken from those phases, not
    run again): granite-8b prefill 2 x 4,096 and decode 2 x 4,128,
    granite-moe-1b-a400m train 2 x 512, gin-tu ``ogb_products``,
    ``dlrm.train`` at ``VOCAB_CAP`` rows a table, and the ANNS cell
    (``anns_cell``, run here)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import cell_terms
    t_phase = time.perf_counter()
    anns_row, anns, anns_secs = anns_cell(dev, main_launches)
    emit(anns_row)
    serve, train = lm_rows["lm.serve"], lm_rows["lm.train"]
    dlrm_cfg = dataclasses.replace(get_arch("dlrm-mlperf").model_cfg,
                                   vocab_cap=VOCAB_CAP)
    steps = [
        ("granite-8b prefill 2 x 4096",
         _cut_cell("granite-8b", "prefill_32k", seq_len=serve["prompt"],
                   global_batch=serve["batch"]), serve["prefill_secs"]),
        ("granite-8b decode 2 x 4128",
         _cut_cell("granite-8b", "decode_32k", seq_len=serve["cache_slots"],
                   global_batch=serve["batch"]),
         serve["decode_ms_per_token_median"] / 1e3),
        ("granite-moe-1b-a400m train 2 x 512",
         _cut_cell("granite-moe-1b-a400m", "train_4k", seq_len=train["seq"],
                   global_batch=train["batch"]),
         statistics.median(train["step_secs"][1:])),
        ("gin-tu ogb_products",
         _cut_cell("gin-tu", "ogb_products"),
         gnn_rows[("gin-tu", "ogb_products")]["steady_step_s"]),
        (f"dlrm-mlperf train_batch, {VOCAB_CAP} rows a table",
         _cut_cell("dlrm-mlperf", "train_batch", cfg=dlrm_cfg),
         statistics.median(dlrm_row["step_secs"][1:])),
        (f"crouting-anns serve_100m_gist, {ANNS_ROWS} rows", anns,
         anns_secs)]
    rows = []
    for what, cell, measured in steps:
        terms = cell_terms(cell)
        rows.append({
            "cell": what, "step": cell.step_name,
            "step_time_lb_s": terms["step_time_lb_s"],
            "dominant": terms["dominant"], "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"],
            "flops_by_dtype": terms["flops_by_dtype"],
            "bytes_min": terms["bytes_min_per_dev"],
            "bytes_eager": terms["bytes_eager_per_dev"],
            "loop_correction": terms["loop_correction"],
            "measured_s": measured,
            "measured_over_bound": measured / terms["step_time_lb_s"]})
    emit({"phase": "cells", "hw": "H100_SXM (989.4 TFLOP/s bf16, 66.9 "
          "fp32, 3.35 TB/s)", "steps": rows,
          "secs": time.perf_counter() - t_phase})
    return rows


def add_chain_ms():
    """The card's dependent fp32 add: one thread's chain of ``10**6``
    ``__fadd_rn`` (``segment_sum.add_chain``, from the kernel's library),
    ms a link."""
    import torch
    from repro_torch.kernels import segment_sum as K
    out = torch.zeros(1, device="cuda")
    n = 10 ** 6
    total = cuda_times(lambda: K.add_chain(out, n), 5, group=5)
    check(float(out) == float(n), f"add chain: {float(out)} != {n}")
    return {"adds": n, "ms": total, "ns_an_add": total * 1e6 / n,
            "ms_an_add": total / n}


def call_device_ms(fn, reps: int = 50):
    """All device time (kernels and memsets) of one call of ``fn`` and the
    activities the trace kept a call: ``wrapper_row`` with no flush."""
    got = wrapper_row(fn, lambda: None, reps)
    return got["wrapper_device_ms"], got["wrapper_launches"], \
        got["wrapper_kernels"]


def runs_int64(ids, S):
    """The set-up as it stood before int32 keys and the long-run list: a
    stable sort of int64 ids, arange and searchsorted (timed beside
    ``segment_sum.runs``)."""
    import torch
    flat = ids.reshape(-1).long()
    sorted_ids, order = torch.sort(flat, stable=True)
    return sorted_ids, order, torch.searchsorted(
        sorted_ids, torch.arange(S + 1, device=flat.device))


def time_segment_sum():
    """``segment_sum`` at the main path's shapes (the lookups' backward of
    ``dlrm.train``: a 3-row table's and a 4M-row table's [65,536, 128]
    gradient rows; ``lm.train``'s token embedding, [1,024, 1,024] bf16 rows
    into granite-moe's 49,280-row vocabulary; gin-tu's aggregation at
    ``minibatch_lg``; a skewed list, one id holding half of 65,536 rows and
    the rest over 100k ids): the kernel alone on runs set up beforehand
    (events: ``ms``; the profiler: ``device_ms``, the kernel, and
    ``device_ms_with_memset``, the kernel and the run-start grid's zeroing),
    the whole wrapper call given the ids (set-up and kernel:
    ``wrapper_ms``, ``wrapper_device_ms``), the set-up alone with int32 and
    with int64 keys (``runs_ms``, ``runs_int64_ms``) and its stable sort
    alone (``sort_int32_ms``, ``sort_int64_ms``), the plain version on
    the card, and ``torch.index_add`` (atomics: one PyTorch call that
    computes the same sum in no fixed order).  Inputs are fresh in L2, as
    a backward that just wrote them leaves them.  ``bound_ms`` counts the
    rows and ids read and the output written once; ``chain_bound_ms`` is
    the longest run's adds at the card's dependent add time
    (``add_chain_ms``), which no order-keeping kernel can beat."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    chain = add_chain_ms()
    emit({"phase": "add_chain", **chain})
    out = []
    for what, N, S, span, d, dt in (
            ("dlrm small-table backward (3-row vocab)", 65536, 16, 3, 128,
             torch.float32),
            ("dlrm 4M-row table backward", 65536, 4_000_256, 4_000_000, 128,
             torch.float32),
            ("lm.train token embedding backward", 1024, 49280, 49155, 1024,
             torch.bfloat16),
            ("gin-tu minibatch_lg aggregation", 168960, 169984, 169984, 64,
             torch.float32),
            ("skewed ids: one id holds half", 65536, 100000, 100000, 128,
             torch.float32)):
        data = torch.randn((N, d), generator=gen, device=dev).to(dt)
        ids = torch.randint(0, span, (N,), generator=gen, device=dev)
        if what.startswith("skewed"):
            hot = torch.randperm(N, generator=gen, device=dev)[: N // 2]
            ids[hot] = SEG_HOT_ID
        runs = K.runs(ids, S)

        def kernel():
            return K.launch_runs(data, runs)
        zeros = torch.zeros((S, d), dtype=dt, device=dev)
        got = kernel().cpu()
        want = ref.segment_sum_ref(data.cpu(), ids.cpu(), S)
        check(bit_equal(got, want), f"segment_sum timing inputs {what}: the "
              "kernel differs from its plain version")
        e = data.element_size()
        row = timed_row(
            "segment_sum", kernel, lambda: ref.segment_sum_ref(data, ids, S),
            N * d * e + 8 * N + S * d * e, N * d,
            float((got.float() - want.float()).abs().max()) if N else 0.0,
            f"{what}: [{N}, {d}] {str(dt).removeprefix('torch.')} -> "
            f"{S} segments", library=lambda: torch.index_add(zeros, 0, ids,
                                                             data),
            library_note="torch.index_add (CUDA atomics, no fixed order; "
                         "the port never calls it)")
        row["longest_run"] = int((runs.offsets[1:]
                                  - runs.offsets[:-1]).max())
        row["plan"] = K.plan(N, S, d, e, K.alignment(data))._asdict()
        row["long_runs"] = int((runs.long < S).sum())
        row["chain_bound_ms"] = row["longest_run"] * chain["ms_an_add"]
        (row["device_ms_with_memset"], row["device_activities"],
         row["device_names"]) = call_device_ms(kernel)
        row["wrapper_ms"] = cuda_times(lambda: K.segment_sum(data, ids, S),
                                       50)
        (row["wrapper_device_ms"], row["wrapper_activities"],
         row["wrapper_names"]) = call_device_ms(
            lambda: K.segment_sum(data, ids, S))
        row["runs_ms"] = cuda_times(lambda: K.runs(ids, S), 50)
        row["runs_int64_ms"] = cuda_times(lambda: runs_int64(ids, S), 50)
        keys32, keys64 = ids.int(), ids.long()
        row["sort_int32_ms"] = cuda_times(
            lambda: torch.sort(keys32, stable=True), 50)
        row["sort_int64_ms"] = cuda_times(
            lambda: torch.sort(keys64, stable=True), 50)
        row["replaces_note"] = ("no Pallas kernel: the reference sums rows "
                                "by id with XLA's scatter-add "
                                "(jax.ops.segment_sum, jnp.take's backward)")
        out.append(row)
        del data, ids, runs, zeros, keys32, keys64
        torch.cuda.empty_cache()
    return out


def time_normalize_rows(flush):
    """``normalize_rows`` at a cosine cell's query batch (the
    ``dbpedia500k`` cell: [10,000, 1,536] float32) behind the L2 flush,
    into a separate output so that every launch reads the same rows;
    ``bound_ms`` counts the rows read and written once.  Beside it:
    ``torch.nn.functional.normalize`` (the same formula in one PyTorch call,
    as the yardstick; the port never calls it), the host's NumPy pass that
    the kernel took off the batch path (``numpy_ms``, host clock, median of
    5) and the batch's pageable upload (``upload_ms``, host clock around a
    synchronised copy, median of 5)."""
    import numpy as np
    import torch
    from repro_torch.core import distances as D
    from repro_torch.kernels import normalize_rows as K
    from repro_torch.kernels import ref
    B, d = 10_000, 1536
    host = norm_rows(np.random.default_rng(10), B, d).numpy()
    x = torch.as_tensor(host, device="cuda")
    out = torch.empty_like(x)
    got = K.normalize_rows_cuda(x, out).cpu()
    want = ref.normalize_rows_ref(torch.as_tensor(host))
    check(bit_equal(got, want), "normalize_rows timing inputs: the kernel "
          "differs from its plain version")
    row = timed_row(
        "normalize_rows", lambda: K.normalize_rows_cuda(x, out),
        lambda: ref.normalize_rows_ref(x), 2 * B * d * 4, 3 * B * d, 0.0,
        f"a cosine query batch: [{B}, {d}] float32", flush=flush,
        library=lambda: torch.nn.functional.normalize(x, dim=1),
        library_note="torch.nn.functional.normalize(x, dim=1) (the same "
                     "formula; the port never calls it)")

    def host_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    row["numpy_ms"] = host_ms(lambda: D.preprocess_vectors(host, "cosine"))
    row["upload_ms"] = host_ms(lambda: (torch.as_tensor(host, device="cuda"),
                                        torch.cuda.synchronize()))
    row["replaces_note"] = ("no Pallas kernel: the reference normalises a "
                            "cosine index's rows on the host in NumPy "
                            "(preprocess_vectors)")
    return row


def profile_batch(idx, queries, spec):
    """Device time by kernel for one batch (torch.profiler) and the share
    of the batch's wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    idx.search(queries[:BATCH], spec)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_launches(TRACE_PAD_LAUNCHES)
        t0 = time.perf_counter()
        idx.search(queries[:BATCH], spec)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        _pad_launches(TRACE_PAD_LAUNCHES)
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type) or PAD_KERNEL in ev.key:
            continue                            # kernels only, not host ops
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    ours = {name: {"device_ms": dt / 1e3, "count": c}
            for dt, k, c in rows for name in KERNEL_FILES
            if f"{name}_kernel" in k}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / wall_us) if busy else None,
            "kernel_launches": sum(r[2] for r in rows), "port_kernels": ours,
            "top": [{"name": k[:60], "device_ms": dt / 1e3, "count": c}
                    for dt, k, c in rows[:8]]}


def ptxas_summary(log: str):
    """Registers a thread and spill bytes of each kernel (each variant and
    instantiation) from nvcc's ``-Xptxas -v`` output, names demangled
    where ``c++filt`` is there."""
    import re
    import shutil
    out, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln) or re.search(
            r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            spill = int(m.group(1)) + int(m.group(2))
            if out and out[-1]["fn"] == fn:
                out[-1]["spill_bytes"] = spill
            else:
                out.append({"fn": fn, "spill_bytes": spill})
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            if not (out and out[-1]["fn"] == fn):
                out.append({"fn": fn})
            out[-1]["registers"] = int(m.group(1))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["fn"] for r in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        for r, n in zip(out, names):
            r["fn"] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return out


def segment_sum_tree(tree: str) -> int:
    """``--tree DIR``: ``segment_sum_step_profiles`` alone, run on the
    package under ``DIR/src``: another checkout, such as the parent commit
    unpacked with ``git archive``, profiled the same way in the same call
    (parent, change, change, parent).  It drives the model steps and wraps
    ``kernels.segment_sum.runs``, so any tree with those serves."""
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import repro_torch
    from repro_torch.kernels import build
    emit({"phase": "tree", "package": repro_torch.__file__,
          "gpu": nvidia_smi("name,power.limit")})
    build.build_all(["segment_sum"])
    emit({"phase": "step_profiles",
          **segment_sum_step_profiles(torch.device("cuda"))})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tree"] and len(sys.argv) == 3:
        return segment_sum_tree(sys.argv[2])
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
    emit({"phase": "build", "secs": time.perf_counter() - t0, "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {k: ptxas_summary(v) for k, v in build.BUILD_LOG.items()}})

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    emit({"phase": "kernels", "fused_expand": check_fused_expand(rng, dev),
          "pool_merge": check_pool_merge(rng, dev),
          "sq8_distance": check_sq8_distance(rng, dev),
          "gather_distance": check_gather_distance(rng, dev),
          "crouting_prune": check_crouting_prune(rng, dev),
          "l2_distance": check_l2_distance(dev),
          "segment_sum": check_segment_sum(dev),
          "normalize_rows": check_normalize_rows(dev)})
    # 2b. the LM family: granite-8b serving, granite-moe training, launcher
    lm_rows, lm_seg = lm_phase(dev)
    # 2c. the GNN family, DLRM training, the quickstart example
    gnn_rows, gnn_seg = gnn_phase(dev)
    dlrm_row = dlrm_train(dev)
    emit(dlrm_row)
    emit({"phase": "step_profiles", **segment_sum_step_profiles(dev)})
    main_launches = {"segment_sum": lm_seg + gnn_seg
                     + dlrm_row["segment_sum_launches"]}
    quickstart_phase(main_launches)
    # 2d. the cells: the ANNS cell at GIST's width, and the dry run's
    # bounds beside the steps measured above
    cells_phase(dev, lm_rows, gnn_rows, dlrm_row, main_launches)
    # 3. hnsw: the main path with its hierarchy, at a reduced n
    t0 = time.perf_counter()
    ds = make_dataset(n_base=HNSW_BASE, n_query=1024, dim=128, n_clusters=64,
                      seed=0)
    idx = AnnIndex.build(ds.base, graph="hnsw", m=16, efc=64)
    build_secs = time.perf_counter() - t0
    gt = exact_ground_truth(ds, k=10)
    emit({"phase": "hnsw", "n": HNSW_BASE, "dim": 128, "m": 16, "efc": 64,
          "build_secs": build_secs,
          "levels": idx.graph.build_stats["levels"],
          "theta_star": idx.profile.theta_star,
          "cuts": "n 1M->30k (50k until the lm phase came), m 32->16, "
                  "efc 256->64 (host HNSW builder)"})
    search_phase("hnsw", idx, ds.queries, gt, main_launches,
                 specs={**SPECS, **FINGER_SPECS},
                 unfused_specs=UNFUSED_SPECS + tuple(FINGER_SPECS))
    hnsw_prof = profile_batch(idx, ds.queries, SearchSpec(**SPECS["W4"]))
    # 3b. serve: the bucketed frontend on the hnsw index
    serve_phase(idx, ds.queries, main_launches)
    del idx

    # 4. nsg: NSG at the paper's widths on the same data and queries
    captures = {("nsg", "build"): CaptureInputs()}
    nsg_idx = nsg_phase(ds, gt, main_launches, captures[("nsg", "build")],
                        rng)
    nsg_prof = profile_batch(nsg_idx, ds.queries, SearchSpec(**SPECS["W4"]))
    # 4b. mutate: live mutation with its WAL on an NSG of the same data,
    # the crash sweep
    mutate_phase(ds, main_launches)
    del nsg_idx
    # 4c. sharded: the mutate phase's rows in four shards on the one card;
    # 4d. launch: the serving entry point with the autotune controller
    sharded_phase(ds, main_launches)
    launch_phase()
    del ds

    # 5. every router on every engine beside BENCH_engine.json
    router_sweep(main_launches)

    # 6. knn_1m: the kernels at a deployment's state size
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
    captures.update({key: CaptureInputs() for key in (
        ("W4", "fused"), ("W1", "fused"), ("W4_both", "fused"),
        ("W4", "unfused"))})
    search_phase("knn_1m", idx, ds.queries, gt, main_launches,
                 captures=captures)
    profiles = {
        "hnsw_W4_fused": hnsw_prof,
        "nsg_W4_fused": nsg_prof,
        "knn_1m_W4_fused": profile_batch(idx, ds.queries,
                                         SearchSpec(**SPECS["W4"])),
        "knn_1m_W4_both_fused": profile_batch(
            idx, ds.queries, SearchSpec(**SPECS["W4_both"])),
        "knn_1m_W4_unfused": profile_batch(
            idx, ds.queries, SearchSpec(engine="unfused", **SPECS["W4"]))}

    # 7. the dlrm-mlperf retrieval path
    captures[("ip_W4", "fused")] = CaptureInputs()
    cands, queries, ip_idx, ip_queries = retrieval_phase(dev, main_launches,
                                                         captures)
    profiles["retrieval_ip_W4_fused"] = profile_batch(
        ip_idx, ip_queries, SearchSpec(**IP_SPECS["ip_W4"]))
    emit({"phase": "profile", **profiles})
    # 7b. cosine: the dbpedia500k cell's batch through search_on
    cosine_phase(dev, main_launches)

    # 8. kernels on captured main-path inputs
    kernels = timing_phase(captures, main_launches, cands, queries)
    emit({"phase": "done", "secs": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
