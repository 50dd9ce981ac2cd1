"""The port's serving frontend against the JAX package's.

One HNSW graph (1.2k x 32, m=8) is built by the JAX package and carried to
the port with ``AnnIndex.from_payload``.  The bucketing helpers must equal
the reference's on seeded inputs; the same seeded ragged stream (requests
of 1..32 rows, ``k`` mixed over {1, 5, 10}) goes through the reference
``ServeFrontend`` on ``engine="jnp"`` and through the port's on ``torch``
and ``fused`` (the kernels' plain versions on the CPU): ids and every
per-request counter must be equal, distances within 1e-5 (the port sums
squared differences in the kernels' order, XLA in its own), and no request
may pay a first-use event after warmup (``recompiles_after_warmup == 0``).
Admission control, worker mode, fault confinement, engine pinning against
the engine cache's eviction, and ``make_session``'s type check are the
port's own.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro.core.angles import sample_angle_profile
from repro.core.hnsw import build_hnsw
from repro.core.index import AnnIndex as JIndex
from repro.core.sharded_index import ShardedAnnIndex as JSharded
from repro.core.spec import SearchSpec as JSpec
from repro.data.vectors import make_dataset
from repro.serve import ServeFrontend as JFrontend
from repro.serve import bucketing as jb

from repro_torch import fault
from repro_torch.core import search as S
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.serve import (DeadlineExceeded, FrontendStopped, QueueFull,
                               RequestRejected, ServeFrontend,
                               SingleIndexSession, bucket_for, make_session,
                               pad_to_bucket, validate_buckets)

BUCKETS = (1, 8, 32)
COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")
SPEC = dict(k=10, efs=32, router="crouting", beam_width=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor ops beside other test processes
    on a shared CPU: one intra-op thread each keeps them from
    oversubscribing the cores (the setting is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    ds = make_dataset(n_base=1200, n_query=64, dim=32, n_clusters=12, seed=5)
    g = build_hnsw(ds.base, m=8, efc=48, seed=0)
    prof = sample_angle_profile(g, n_sample=8, efs=32, seed=1)
    j = JIndex(graph=g, profile=prof)
    return ds, j, AnnIndex.from_payload(j._payload(), device="cpu")


def _stream(n_queries, seed=11, top=32):
    """A seeded ragged stream: (lo, hi, k) spans covering the queries."""
    rng = np.random.default_rng(seed)
    out, lo = [], 0
    while lo < n_queries:
        n = int(min(rng.integers(1, top + 1), n_queries - lo))
        out.append((lo, lo + n, int(rng.choice([1, 5, 10]))))
        lo += n
    return out


def _drive(fe, queries, stream, flush_every=3):
    futs = []
    for i, (lo, hi, k) in enumerate(stream):
        futs.append(fe.submit(queries[lo:hi], k=k))
        if i % flush_every == flush_every - 1:
            fe.flush()
    fe.flush()
    return [f.result(timeout=60) for f in futs]


def _assert_stats_equal(a, b):
    for c in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a, c)),
                                      np.asarray(getattr(b, c)), err_msg=c)
    assert set(a.extra) == set(b.extra)
    for c in a.extra:
        np.testing.assert_array_equal(a.extra[c], b.extra[c], err_msg=c)


@pytest.fixture(scope="module")
def reference_stream(pair):
    """The reference frontend (``jnp``) over the seeded ragged stream."""
    ds, j, _ = pair
    fe = JFrontend(j, JSpec(engine="jnp", **SPEC), buckets=BUCKETS)
    stream = _stream(len(ds.queries))
    outs = _drive(fe, ds.queries, stream)
    assert fe.telemetry.recompiles_after_warmup == 0
    return stream, outs


# --------------------------------------------------------------------------
# bucketing helpers: equal to the reference's on seeded inputs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bucket_helpers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ladder = rng.integers(1, 200, size=int(rng.integers(1, 6))).tolist()
    assert validate_buckets(ladder) == jb.validate_buckets(ladder)
    top = validate_buckets(ladder)
    for n in rng.integers(1, top[-1] + 1, size=16):
        assert bucket_for(int(n), top) == jb.bucket_for(int(n), top)
        q = rng.normal(size=(int(n), 7)).astype(np.float32)
        b = bucket_for(int(n), top)
        got, want = pad_to_bucket(q, b), jb.pad_to_bucket(q, b)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        bucket_for(top[-1] + 1, top)
    with pytest.raises(ValueError):
        validate_buckets(())


# --------------------------------------------------------------------------
# the ragged stream against the reference frontend
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_ragged_stream_matches_reference(pair, reference_stream, engine):
    ds, _, t = pair
    stream, ref = reference_stream
    fe = ServeFrontend(t, SearchSpec(engine=engine, **SPEC), buckets=BUCKETS)
    warm = fe._base.engine.compile_count()
    outs = _drive(fe, ds.queries, stream)
    for (lo, hi, k), (ids, d, st), (rid, rd, rst) in zip(stream, outs, ref):
        assert ids.shape == (hi - lo, k)
        np.testing.assert_array_equal(ids, np.asarray(rid))
        np.testing.assert_allclose(d, np.asarray(rd), rtol=1e-5, atol=1e-5)
        _assert_stats_equal(st, rst)
    assert fe.telemetry.recompiles_after_warmup == 0
    assert fe._base.engine.compile_count() == warm
    summ = fe.telemetry.summary()
    assert summ["requests"]["served"] == len(stream)
    assert sum(b["rows"] for b in summ["buckets"].values()) == len(ds.queries)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_requests_equal_direct_searches(pair, engine):
    """Each request of a coalesced dispatch equals a direct search of its
    own rows: ids, dists and counters bit for bit (``iters`` is the
    batch's and is left out)."""
    ds, _, t = pair
    spec = SearchSpec(engine=engine, **SPEC)
    fe = ServeFrontend(t, spec, buckets=BUCKETS)
    stream = _stream(40, seed=3)
    for (lo, hi, k), (ids, d, st) in zip(stream,
                                         _drive(fe, ds.queries, stream)):
        ids2, d2, st2 = t.search(ds.queries[lo:hi], spec.replace(k=k))
        np.testing.assert_array_equal(ids, ids2)
        np.testing.assert_array_equal(d, d2)
        _assert_stats_equal(st, st2)


def test_warmup_counts_first_uses_per_rung(pair):
    """Warmup runs each rung once: one first use a rung (its batch shape);
    the engine's own setup happened when the session was made."""
    _, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", efs=40, k=10,
                                     router="crouting"), buckets=BUCKETS)
    summ = fe.telemetry.summary()
    assert [summ["buckets"][str(b)]["compiles"] for b in BUCKETS] == [1, 1, 1]
    assert fe._base.engine.compile_count() == 1 + len(BUCKETS)


def test_off_ladder_shape_counts_as_a_first_use(pair):
    """A batch shape the ladder did not warm is a first use: a direct call
    through the session's engine moves its count (the frontend never makes
    one, because it pads every dispatch onto a rung)."""
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", efs=36, k=10,
                                     router="crouting"), buckets=(1, 8))
    c0 = fe._base.engine.compile_count()
    fe._base.engine.search_padded(ds.queries[:5], 5, 10, None)
    assert fe._base.engine.compile_count() == c0 + 1
    fe._base.engine.search_padded(ds.queries[:5], 5, 10, None)
    assert fe._base.engine.compile_count() == c0 + 1


def test_session_engine_survives_cache_eviction(pair):
    """The engine cache holds 16 engines; a session searches through the
    engine it holds, so one evicted by other specs is not set up again on
    a request and the count stays honest."""
    ds, _, t = pair
    spec = SearchSpec(engine="torch", efs=44, k=10, router="crouting")
    fe = ServeFrontend(t, spec, buckets=BUCKETS)
    engine = fe._base.engine._fn
    warm = fe._base.engine.compile_count()
    for efs in range(50, 50 + S._ENGINE_CACHE_MAX + 2):
        t.search(ds.queries[:1], SearchSpec(engine="torch", efs=efs, k=10,
                                            router="crouting"))
    assert all(v[2] is not engine for v in S._ENGINE_CACHE.values())
    fe.search(ds.queries[:3])
    assert fe.telemetry.recompiles_after_warmup == 0
    assert fe._base.engine.compile_count() == warm
    assert fe._base.engine._fn is engine
    with pytest.raises(ValueError, match="another graph or spec"):
        t.search_on(engine, ds.queries[:1], spec.replace(efs=50))


def test_new_spec_opens_a_warmed_session(pair):
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", **SPEC), buckets=BUCKETS)
    other = SearchSpec(engine="torch", k=10, efs=32, router="none")
    ids, _, _ = fe.search(ds.queries[:4], spec=other)
    assert ids.shape == (4, 10)
    assert len(fe._sessions) == 2
    assert fe.telemetry.recompiles_after_warmup == 0
    # request-only fields map onto the same session
    fe.search(ds.queries[:4], spec=other.replace(k=5, cos_theta=0.5))
    assert len(fe._sessions) == 2
    assert fe.activate_spec(other).router == "none"
    assert fe.active_spec.router == "none"


# --------------------------------------------------------------------------
# admission control
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fe_torch(pair):
    _, _, t = pair
    return ServeFrontend(t, SearchSpec(engine="torch", **SPEC),
                         buckets=BUCKETS)


def test_oversized_request_rejected_not_truncated(pair, fe_torch):
    ds, _, _ = pair
    with pytest.raises(RequestRejected, match="largest bucket"):
        fe_torch.submit(ds.queries[:33])


@pytest.mark.parametrize("k", [0, 33])
def test_k_outside_pool_rejected(pair, fe_torch, k):
    ds, _, _ = pair
    with pytest.raises(RequestRejected, match="efs"):
        fe_torch.submit(ds.queries[:2], k=k)


def test_dim_mismatch_rejected(fe_torch):
    with pytest.raises(RequestRejected, match="dim"):
        fe_torch.submit(np.zeros((2, 5), np.float32))


def test_backpressure_queue_full(pair):
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", **SPEC),
                       buckets=BUCKETS, max_pending_rows=10)
    fe.submit(ds.queries[:8])
    with pytest.raises(QueueFull):
        fe.submit(ds.queries[:8])
    assert fe.telemetry.rejected == 1
    fe.flush()
    fe.submit(ds.queries[:8])
    fe.flush()


def test_expired_deadline_fails_future(pair, fe_torch):
    ds, _, _ = pair
    expired0 = fe_torch.telemetry.expired
    fut = fe_torch.submit(ds.queries[:2], timeout=1e-4)
    live = fe_torch.submit(ds.queries[:3], timeout=30.0)
    time.sleep(0.01)
    fe_torch.flush()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5)
    assert live.result(timeout=5)[0].shape == (3, 10)
    assert fe_torch.telemetry.expired == expired0 + 1


def test_stopped_frontend_rejects_then_reopens(pair):
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", **SPEC), buckets=BUCKETS)
    fut = fe.submit(ds.queries[:2])
    fe.stop()
    assert fut.result(timeout=5)[0].shape == (2, 10)   # drained by stop()
    fe.stop()                                          # idempotent
    with pytest.raises(FrontendStopped):
        fe.submit(ds.queries[:2])
    fe.start()
    assert fe.submit(ds.queries[:2]).result(timeout=30)[0].shape == (2, 10)
    fe.stop()


# --------------------------------------------------------------------------
# worker mode, faults, health
# --------------------------------------------------------------------------
def test_worker_serves_submitting_threads(pair):
    ds, _, t = pair
    spec = SearchSpec(engine="fused", **SPEC)
    stream = _stream(len(ds.queries), seed=9)
    results = {}
    with ServeFrontend(t, spec, buckets=BUCKETS) as fe:
        def submit(part):
            for i in part:
                lo, hi, k = stream[i]
                results[i] = fe.submit(ds.queries[lo:hi], k=k)
        threads = [threading.Thread(target=submit,
                                    args=(range(w, len(stream), 4),))
                   for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        outs = {i: f.result(timeout=60) for i, f in results.items()}
    assert fe.telemetry.recompiles_after_warmup == 0
    for i, (lo, hi, k) in enumerate(stream):
        ids, d, st = outs[i]
        ids2, d2, st2 = t.search(ds.queries[lo:hi], spec.replace(k=k))
        np.testing.assert_array_equal(ids, ids2)
        np.testing.assert_array_equal(d, d2)
        _assert_stats_equal(st, st2)


def test_dispatch_fault_fails_only_its_own_batch(pair):
    """An armed ``serve.dispatch`` failpoint fails the second dispatch of a
    flush: its futures carry the error, the dispatches before and after it
    resolve."""
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", **SPEC), buckets=BUCKETS)
    futs = [fe.submit(ds.queries[:3], cos_theta=ct) for ct in (0.9, 0.8, 0.7)]
    fault.arm("serve.dispatch", kind="raise", hits={1})
    try:
        assert fe.flush() == 3
    finally:
        fault.disarm()
    assert futs[0].result(timeout=5)[0].shape == (3, 10)
    with pytest.raises(fault.FaultInjected, match="serve.dispatch"):
        futs[1].result(timeout=5)
    assert futs[2].result(timeout=5)[0].shape == (3, 10)
    assert fe.telemetry.dispatch_failures == 1 and fe.telemetry.failed == 1


def test_worker_fault_surfaces_on_caller(pair):
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", **SPEC), buckets=BUCKETS)
    fault.arm("serve.worker", kind="raise", hits={0})
    try:
        fe.start(poll_s=0.005)
        deadline = time.time() + 10
        while fe.telemetry.worker_errors == 0 and time.time() < deadline:
            time.sleep(0.005)
    finally:
        fault.disarm()
    assert fe.health()["worker_error"] is not None
    from repro_torch.serve import WorkerFailure
    with pytest.raises(WorkerFailure):
        fe.submit(ds.queries[:1])
    fe.stop()


def test_health_reports_frontend_and_backend(pair):
    ds, _, t = pair
    fe = ServeFrontend(t, SearchSpec(engine="torch", **SPEC), buckets=BUCKETS)
    h = fe.health()
    assert h["backend"] == {"kind": "single", "n": 1200, "degraded": False}
    assert h["autotune"] is None and fe.autotune is None
    fe.submit(ds.queries[:3])
    assert fe.health()["queued_requests"] == 1
    fe.flush()
    assert fe.health()["latency_window"]["served"] == 1


# --------------------------------------------------------------------------
# make_session
# --------------------------------------------------------------------------
def test_make_session_types(pair):
    from repro_torch.core.sharded_index import ShardedAnnIndex, shard_dataset
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.mutate import MutableShardedAnnIndex
    from repro_torch.serve import (MutableShardedIndexSession,
                                   ShardedIndexSession)
    ds, j, t = pair
    assert isinstance(make_session(t, SearchSpec(engine="torch", **SPEC)),
                      SingleIndexSession)
    with pytest.raises(TypeError, match="repro_torch"):
        make_session(j)
    # the JAX package's sharded index is still not the port's to serve
    with pytest.raises(TypeError, match="repro_torch"):
        make_session(object.__new__(JSharded))
    with pytest.raises(TypeError):
        ServeFrontend(j)
    # the port's sharded indexes get their sessions
    arrays = shard_dataset(ds.base[:400], 2, graph="hnsw", m=8, efc=32)
    sharded = ShardedAnnIndex(arrays, make_local_mesh(2, device="cpu"))
    sess = make_session(sharded, SearchSpec(engine="torch", **SPEC))
    assert isinstance(sess, ShardedIndexSession) and not sess.splits_stats
    mutable = MutableShardedAnnIndex([t])
    assert isinstance(make_session(mutable), MutableShardedIndexSession)


def test_failpoint_sites_match_reference():
    from repro.fault import failpoints as jfp
    from repro_torch.fault import failpoints as tfp
    ported = {"serve.dispatch", "serve.worker", "mutate.merge.build",
              "mutate.merge.swap", "index.save.write", "index.save.rename",
              "wal.append", "wal.fsync", "wal.rotate", "checkpoint.write",
              "manifest.rename", "shard.search", "sharded.search",
              "autotune.step", "autotune.probe"}
    assert tfp.DECLARED_SITES == ported == jfp.DECLARED_SITES
    assert tfp.KINDS == jfp.KINDS
    assert jfault.FaultSpec().kind == fault.FaultSpec().kind == "raise"


def test_serving_example_runs_on_the_cpu():
    """examples/serve_anns_torch.py end to end at a small size: no
    first-use event after warmup, no deleted id returned, and the live
    index merged in the background while it served."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "serve_anns_torch.py")
    spec = importlib.util.spec_from_file_location("serve_anns_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.run(n_base=1000, n_query=64, device="cpu")
    assert out["recompiles_after_warmup"] == 0
    assert out["sharded_recompiles"] == 0 and out["sharded_recall"] > 0.9
    assert out["mutable_recompiles"] == 0 and out["deleted_leaks"] == 0
    assert out["merges"] >= 1 and out["recall"] > 0.9
