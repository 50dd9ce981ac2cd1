"""The port's sharded index against the JAX package's.

``shard_dataset`` must give the reference's arrays bit for bit (HNSW, l2
and ip, three shards with a short last one), and the reference's
threshold under l2; under ip the port's profile leaves out the samples of
each profile query's own row, which the reference's takes.  The reference
``ShardedAnnIndex`` (``engine="jnp"``) runs in a subprocess with four host
devices (``--xla_force_host_platform_device_count`` must be set before JAX
starts), on ``make_dataset(1200, n_query=24, dim=32, seed=5)``'s first
1190 rows in three shards (HNSW m=8, efc=48); the port's, on the same
arrays with three CPU slots, must give the same ids, dists within 1e-5 and
every ``SearchStats`` field equal, on the ``torch``, ``fused`` and
``unfused`` engines (the kernels' plain versions on the CPU), for
crouting W1, W4, W4 ``both``, ``max_hops=8`` and a bucket-padded batch.
The merge, the request-only fields, the finger rejection, serving behind
the frontend and the ``SearchStats`` repair are checked besides.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.angles import sample_angle_profile as j_profile
from repro.core.graph import GraphIndex as JGraph
from repro.core.spec import SearchStats as JStats

from repro_torch.core.search import _search_batch
from repro_torch.core.sharded_index import (ShardedAnnIndex,
                                            ShardedIndexArrays, build_shards,
                                            shard_dataset, shard_tensors)
from repro_torch.core.spec import SearchSpec, SearchStats
from repro_torch.data.vectors import make_dataset
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve import ServeFrontend, ShardedIndexSession, make_session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, N_SHARDS = 1190, 3          # ns = 397: the last shard holds 396
BASE = dict(k=10, efs=48, router="crouting", max_hops=2048)
SPECS = {"W1": dict(), "W4": dict(beam_width=4),
         "W4_both": dict(beam_width=4, estimate="both"),
         "hops8": dict(beam_width=4, max_hops=8)}
N_PADDED = 20                       # real rows of the padded batch
FIELDS = ("vectors", "neighbors", "edge_eu", "norms", "entries", "offsets",
          "sq8_codes", "sq8_lo", "sq8_scale", "sq8_eps")
STAT_FIELDS = ("dist_calls", "est_calls", "rerank_calls", "sq8_calls",
               "hops", "iters", "router", "extra", "shards_failed",
               "degraded")

REF_SCRIPT = r"""
import json, sys
import numpy as np
from repro.core.sharded_index import ShardedAnnIndex, shard_dataset
from repro.core.spec import SearchSpec
from repro.data.vectors import make_dataset
from repro.launch.mesh import make_local_mesh
out_path, n_rows, n_shards, base, specs, n_padded = json.loads(sys.argv[1])
ds = make_dataset(n_base=1200, n_query=24, dim=32, seed=5)
res = {}
for metric in ("l2", "ip"):
    a = shard_dataset(ds.base[:n_rows], n_shards, metric=metric,
                      graph="hnsw", m=8, efc=48)
    for f in ("vectors", "neighbors", "edge_eu", "norms", "entries",
              "offsets", "sq8_codes", "sq8_lo", "sq8_scale", "sq8_eps"):
        res[f"{metric}/{f}"] = getattr(a, f)
    res[f"{metric}/meta"] = np.asarray([a.ns, a.cos_theta])
    if metric == "l2":
        arrays = a
idx = ShardedAnnIndex(arrays, make_local_mesh(n_shards, "shards"),
                      spec=SearchSpec(**base))
stats = {}
def run(name, q, valid=None, **kw):
    ids, d, st = idx.search(q, spec=SearchSpec(**base).replace(**kw),
                            valid=valid)
    res[f"{name}/ids"], res[f"{name}/dists"] = ids, d
    stats[name] = dict(
        dist_calls=int(st.dist_calls), est_calls=int(st.est_calls),
        rerank_calls=int(st.rerank_calls), sq8_calls=int(st.sq8_calls),
        hops=int(st.hops), iters=int(st.iters), router=st.router,
        extra={k: int(v) for k, v in st.extra.items()},
        shards_failed=int(st.shards_failed), degraded=bool(st.degraded))
for name, kw in specs.items():
    run(name, ds.queries, **kw)
q = ds.queries.copy()
q[n_padded:] = 0.0
valid = np.arange(len(q)) < n_padded
run("padded", q, valid=valid, **specs["W4"])
np.savez(out_path, **res)
print(json.dumps(stats))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small searches run beside other test
    processes on a shared CPU (the setting is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_dataset(n_base=1200, n_query=24, dim=32, seed=5)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's arrays and searches, from a 4-device subprocess."""
    out = str(tmp_path_factory.mktemp("sharded") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = json.dumps([out, N_ROWS, N_SHARDS, BASE, SPECS, N_PADDED])
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, arg],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, stats


def ref_arrays(ref, metric):
    z = ref[0]
    ns, ct = z[f"{metric}/meta"]
    return ShardedIndexArrays(
        ns=int(ns), metric=metric, cos_theta=float(ct),
        **{f: z[f"{metric}/{f}"] for f in FIELDS})


@pytest.fixture(scope="module")
def port_index(ref):
    return ShardedAnnIndex(ref_arrays(ref, "l2"),
                           make_local_mesh(N_SHARDS, "shards", device="cpu"),
                           spec=SearchSpec(**BASE))


def _own_rows_left_out(got, want, queries, degree):
    """Each of ``got``'s angle samples has its own in ``want``, their
    cosines equal to 1e-5, and at most a degree of ``want``'s samples a
    profile query are left over: the expansions of the queries' own rows,
    which the reference's profile samples under ``ip`` and the port's
    does not (``repro_torch.core.ref_search``)."""
    got, want = np.sort(np.cos(got)), np.sort(np.cos(want))
    j = 0
    for v in want:
        if j < len(got) and abs(v - got[j]) <= 1e-5:
            j += 1
    assert j == len(got)
    assert 0 < len(want) - len(got) <= queries * degree


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_shard_dataset_equals_the_reference(ds, ref, metric):
    got = shard_dataset(ds.base[:N_ROWS], N_SHARDS, metric=metric,
                        graph="hnsw", m=8, efc=48)
    want = ref_arrays(ref, metric)
    assert got.ns == want.ns == 397 and got.metric == metric
    if metric == "l2":
        assert got.cos_theta == want.cos_theta
    else:
        # the threshold is the median of the shards' own profiles, each the
        # reference's samples less those of the profile queries' own rows
        graphs, profiles = build_shards(ds.base[:N_ROWS], N_SHARDS,
                                        metric=metric, graph="hnsw", m=8,
                                        efc=48)
        assert got.cos_theta == float(np.median(
            [p.cos_theta_star for p in profiles]))
        for g, p in zip(graphs, profiles):
            jp = j_profile(JGraph(**dataclasses.asdict(g)), seed=0)
            assert p.n_sample_queries == jp.n_sample_queries
            _own_rows_left_out(p.samples, jp.samples, p.n_sample_queries,
                               g.max_degree)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the short last shard: its rows past 396 are the zero pad, no edge
    # reaches them, and its SQ8 grid is fit on the real rows only
    assert not got.vectors[2, 396:].any()
    assert (got.neighbors[2, :396] <= 397).all()
    assert not np.isin(396, got.neighbors[2])


def _same_stats(st, want):
    for f in STAT_FIELDS:
        got = getattr(st, f)
        if f == "extra":
            got = {k: int(v) for k, v in got.items()}
        assert got == want[f], (f, got, want[f])


@pytest.mark.parametrize("engine", ["torch", "fused", "unfused"])
@pytest.mark.parametrize("name", list(SPECS) + ["padded"])
def test_sharded_search_equals_the_reference(ds, ref, port_index, engine,
                                             name):
    arrays, stats = ref
    kw = SPECS["W4" if name == "padded" else name]
    spec = SearchSpec(engine=engine, **BASE).replace(**kw)
    q, valid = ds.queries, None
    if name == "padded":
        q = ds.queries.copy()
        q[N_PADDED:] = 0.0
        valid = np.arange(len(q)) < N_PADDED
    ids, dists, st = port_index.search(q, spec, valid=valid)
    assert ids.dtype == np.int32 and ids.shape == (24, 10)
    np.testing.assert_array_equal(ids, arrays[f"{name}/ids"])
    np.testing.assert_allclose(dists, arrays[f"{name}/dists"], rtol=0,
                               atol=1e-5)
    _same_stats(st, stats[name])
    if name == "hops8":
        assert st.iters <= 8
    if name == "padded":
        # the padded batch's totals are the unpadded real rows' totals
        _, _, st_real = port_index.search(ds.queries[:N_PADDED], spec)
        for f in STAT_FIELDS:
            if f != "iters":
                assert getattr(st, f) == getattr(st_real, f), f


def test_merge_equals_a_host_merge_of_the_shards_pools(ds, port_index):
    """The merged top-efs equals a stable host sort of the S shards' own
    ``_search_batch`` pools, global ids, counters summed, iters maxed."""
    spec = SearchSpec(engine="fused", **BASE).replace(beam_width=4)
    ids, dists, st = port_index.search(ds.queries, spec.replace(k=48))
    a = port_index.arrays
    cfg = spec.replace(metric="l2", use_hierarchy=False)
    parts = [_search_batch(shard_tensors(a, s, torch.device("cpu")),
                           torch.as_tensor(ds.queries),
                           np.float32(a.cos_theta), cfg)
             for s in range(N_SHARDS)]
    d = np.concatenate([p.dists.numpy() for p in parts], axis=1)
    gi = np.concatenate([np.where(p.ids.numpy() < a.ns,
                                  p.ids.numpy() + a.offsets[s], -1)
                         for s, p in enumerate(parts)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :48]
    np.testing.assert_array_equal(ids, np.take_along_axis(gi, order, 1))
    np.testing.assert_array_equal(dists, np.take_along_axis(d, order, 1))
    assert st.dist_calls == sum(int(p.dist_calls.sum()) for p in parts)
    assert st.hops == sum(int(p.hops.sum()) for p in parts)
    assert st.iters == max(p.iters for p in parts)
    real = ids[ids >= 0]
    assert real.max() < N_ROWS
    for row in ids:
        r = row[row >= 0]
        assert len(set(r.tolist())) == len(r)


def test_request_only_fields_reuse_the_step(ds, port_index):
    spec = SearchSpec(engine="torch", **BASE).replace(beam_width=4)
    step = port_index._step(spec)
    port_index.search(ds.queries[:8], spec)
    n_steps, uses = len(port_index._steps), step.first_uses()
    ids, _, _ = port_index.search(ds.queries[:8],
                                  spec.replace(k=5, cos_theta=0.6))
    assert ids.shape == (8, 5)
    assert port_index._step(spec.replace(k=3)) is step
    assert len(port_index._steps) == n_steps and step.first_uses() == uses
    port_index.search(ds.queries[:3], spec)
    assert step.first_uses() == uses + 1          # one new batch shape


def test_finger_router_is_rejected(ref, port_index):
    with pytest.raises(NotImplementedError, match="companion tables"):
        port_index.search(np.zeros((2, 32), np.float32),
                          SearchSpec(router="finger", engine="torch"))
    with pytest.raises(NotImplementedError):
        ShardedAnnIndex(ref_arrays(ref, "l2"),
                        make_local_mesh(N_SHARDS, device="cpu"),
                        spec=SearchSpec(router="finger"))
    with pytest.raises(TypeError):
        port_index.search(np.zeros((2, 32), np.float32), {"k": 10})
    with pytest.raises(ValueError, match="slots"):
        ShardedAnnIndex(ref_arrays(ref, "l2"),
                        make_local_mesh(2, device="cpu"))


def test_sharded_session_behind_the_frontend(ds, port_index):
    """Each ragged request equals a direct sharded search of its rows
    padded to its rung; no first use after warmup; stats are the
    dispatch's totals."""
    spec = SearchSpec(engine="fused", **BASE).replace(beam_width=4)
    fe = ServeFrontend(port_index, spec, buckets=(1, 8, 32))
    sess = make_session(port_index, spec)
    assert isinstance(sess, ShardedIndexSession) and not sess.splits_stats
    spans = [(0, 3), (3, 11), (11, 12), (12, 24)]
    futs = [fe.submit(ds.queries[a:b], k=5) for a, b in spans]
    fe.flush()
    for (a, b), f in zip(spans, futs):
        ids, dists, st = f.result(timeout=60)
        want = port_index.search(ds.queries[a:b], spec.replace(k=5))
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(dists, want[1])
        assert np.ndim(st.dist_calls) == 0
    summ = fe.telemetry.summary()
    assert summ["recompiles_after_warmup"] == 0
    assert fe.health()["backend"]["kind"] == "sharded"


def test_local_mesh_slots():
    m = make_local_mesh(4, "shards", device="cpu")
    assert m.axis_name == "shards" and len(m.devices) == 4
    assert all(d.type == "cpu" for d in m.devices)
    with pytest.raises(ValueError):
        make_local_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_local_mesh(2)


def _pair(dc, ec, rr, sq, hops, iters, router="crouting", extra=None,
          failed=0, degraded=False):
    kw = dict(dist_calls=dc, est_calls=ec, rerank_calls=rr, sq8_calls=sq,
              hops=hops, iters=iters, router=router, extra=extra or {},
              shards_failed=failed, degraded=degraded)
    return SearchStats(**kw), JStats(**kw)


@pytest.mark.parametrize("kind", ["arrays", "totals"])
def test_search_stats_merge_and_summary_equal_the_reference(kind):
    if kind == "arrays":
        a = _pair(np.array([1, 2]), np.array([0, 1]), np.array([1, 0]),
                  np.array([6, 8]), np.array([3, 3]), 4,
                  extra={"finger_est_calls": np.array([2, 5])})
        b = _pair(np.array([5]), np.array([2]), np.array([2]), np.array([9]),
                  np.array([1]), 7, extra={"finger_est_calls": np.array([4])})
    else:
        a = _pair(7, 3, 0, 0, 5, 4, extra={"delta_scanned": 12}, failed=1,
                  degraded=True)
        b = _pair(7, 1, 2, 9, 6, 9, extra={"delta_scanned": 3})
    got = SearchStats.merge([a[0], b[0]])
    want = JStats.merge([a[1], b[1]])
    assert got.summary() == want.summary()
    assert a[0].summary() == a[1].summary()
    for f in STAT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "extra":
            assert set(g) == set(w)
            assert all(np.array_equal(g[k], w[k]) for k in g)
        else:
            assert np.array_equal(g, w), f
    if kind == "totals":
        assert got.dist_calls == 14 and got.shards_failed == 1
        assert got.degraded and got.iters == 9
        assert got.extra == {"delta_scanned": 15}
    assert set(got.summary()) >= {"shards_failed", "degraded"}


def test_arrays_without_sq8_tables_are_backfilled(ref):
    """Arrays built without SQ8 tables get the reference's per-shard grids
    (fit on the stacked rows, pad rows included) and serve sq8 specs."""
    import dataclasses
    from repro.core.sharded_index import _backfill_sq8 as j_backfill
    from repro_torch.core.sharded_index import _backfill_sq8

    bare = dataclasses.replace(ref_arrays(ref, "l2"), sq8_codes=None,
                               sq8_lo=None, sq8_scale=None, sq8_eps=None)
    got, want = _backfill_sq8(bare), j_backfill(bare)
    for f in ("sq8_codes", "sq8_lo", "sq8_scale", "sq8_eps"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    idx = ShardedAnnIndex(bare, make_local_mesh(N_SHARDS, device="cpu"))
    assert idx.arrays.sq8_codes is not None
    ids, _, st = idx.search(np.asarray(ref[0]["l2/vectors"][0, :4]),
                            SearchSpec(engine="torch", estimate="sq8"))
    assert ids.shape == (4, 10) and st.sq8_calls > 0
