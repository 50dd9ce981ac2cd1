"""The port's live mutation against the JAX package's.

The same base graph (built by the JAX package, carried across with
``AnnIndex.from_payload``) is wrapped by both packages' ``MutableAnnIndex``
and driven through one seeded sequence of inserts, deletes and merges, on
HNSW and NSG merges, l2 and ip.  After every step the live external ids
must be equal, and the searches (reference ``engine="jnp"``, port
``torch`` and ``fused``, the latter's kernels as their plain versions on
the CPU) return equal external ids with distances within 1e-5.

Under ip the graph pool's distances are the kernel-form rank (``(|q-x|^2 -
|q|^2 - |x|^2 + 2) / 2`` on every port engine, ``1 - <q, x>`` on ``jnp``)
and meet the delta's ``1 - <q, x>`` in the host merge, so two candidates
whose distances agree within 1e-6 may come out in either order: the ip
comparison holds ids equal up to such ties (``_assert_equal_up_to_ties``).

The delta scans are held within 1e-5 of the reference's ``_scan_dists``
and ``_scan_dists_sq8``; merge failures quarantine as in the reference;
and a served trace across a background merge pays no first-use event on
the request path.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.angles import sample_angle_profile as j_profile
from repro.core.hnsw import build_hnsw as j_hnsw
from repro.core.index import AnnIndex as JIndex
from repro.core.spec import SearchSpec as JSpec
from repro.data.vectors import make_dataset
from repro.mutate import MutableAnnIndex as JMutable
from repro.mutate import MutateConfig as JConfig
from repro.mutate import delta as jdelta

from repro_torch import fault
from repro_torch.core import search as S
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.mutate import (DeltaSegment, MergeQuarantinedError,
                                MutableAnnIndex, MutateConfig,
                                delta_scan_compile_count)
from repro_torch.mutate import delta as tdelta
from repro_torch.serve import MutableIndexSession, ServeFrontend, make_session

N0 = 1000
GRAPH_KW = {"hnsw": dict(m=8, efc=48), "nsg": dict(r=16, c=64, l=24,
                                                    knn_k=16)}
SPEC = dict(k=10, efs=32, router="crouting", beam_width=4)
COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor ops beside other test processes
    on a shared CPU: one intra-op thread each keeps them from
    oversubscribing the cores (the setting is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.disarm()


@pytest.fixture(scope="module")
def data():
    return {metric: make_dataset(n_base=1200, n_query=24, dim=32,
                                 n_clusters=12, metric=metric, seed=4)
            for metric in ("l2", "ip")}


@pytest.fixture(scope="module")
def bases(data):
    """metric -> (reference AnnIndex, its payload) over the first N0 rows."""
    out = {}
    for metric, ds in data.items():
        g = j_hnsw(ds.base[:N0], metric=metric, m=8, efc=48, seed=0)
        j = JIndex(graph=g, profile=j_profile(g, n_sample=8, efs=32, seed=1))
        out[metric] = (j, j._payload())
    return out


def _configs(graph, **kw):
    base = dict(delta_capacity=64, auto_merge="off", graph=graph,
                graph_kw=dict(GRAPH_KW[graph]))
    base.update(kw)
    return JConfig(**base), MutateConfig(**base)


def _assert_equal_up_to_ties(ids_a, d_a, ids_b, d_b, tie=1e-6):
    """Ids equal except where the two orders differ inside a tie: a
    mismatched id must sit in the other row at a distance within ``tie``,
    or tie with the row's k-th distance (a swap across the cut)."""
    np.testing.assert_allclose(d_a, d_b, rtol=1e-5, atol=1e-5)
    for r in np.flatnonzero((ids_a != ids_b).any(axis=1)):
        for i in np.flatnonzero(ids_a[r] != ids_b[r]):
            j = np.flatnonzero(ids_b[r] == ids_a[r, i])
            near = j.size and abs(d_b[r, j[0]] - d_a[r, i]) <= tie
            cut = abs(d_a[r, i] - d_b[r, -1]) <= tie
            assert near or cut, (r, i, ids_a[r], ids_b[r], d_a[r], d_b[r])


def _compare(jm, tm, queries, metric):
    np.testing.assert_array_equal(tm.live_ids(), jm.live_ids())
    jids, jd, jst = jm.search(queries, spec=JSpec(engine="jnp", **SPEC))
    for engine in ("torch", "fused"):
        ids, d, st = tm.search(queries, spec=SearchSpec(engine=engine,
                                                        **SPEC))
        if metric == "l2":
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
            for c in COUNTERS:
                np.testing.assert_array_equal(getattr(st, c),
                                              np.asarray(getattr(jst, c)))
        else:
            _assert_equal_up_to_ties(ids, d, np.asarray(jids),
                                     np.asarray(jd))
        np.testing.assert_array_equal(st.extra["delta_scanned"],
                                      jst.extra["delta_scanned"])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("graph", ["hnsw", "nsg"])
def test_mutation_sequence_matches_reference(data, bases, graph, metric):
    ds = data[metric]
    j, payload = bases[metric]
    jcfg, tcfg = _configs(graph)
    jm = JMutable(JIndex._from_payload(payload), config=jcfg)
    tm = MutableAnnIndex(AnnIndex.from_payload(payload, device="cpu"),
                         config=tcfg)
    rng = np.random.default_rng(7)
    q = ds.queries
    nxt = N0

    def step(kind, arg=None):
        nonlocal nxt
        if kind == "insert":
            rows = ds.base[nxt:nxt + arg]
            nxt += arg
            np.testing.assert_array_equal(tm.insert(rows), jm.insert(rows))
        elif kind == "delete":
            kill = rng.choice(jm.live_ids(), arg, replace=False)
            assert jm.delete(kill) == tm.delete(kill) == arg
        else:
            assert jm.merge() and tm.merge()
        _compare(jm, tm, q, metric)

    step("insert", 40)
    step("delete", 12)
    step("merge")
    step("insert", 30)
    step("delete", 6)
    step("insert", 20)
    step("merge")
    assert jm.epoch == tm.epoch == 2
    assert tm._state.snapshot.index.graph.kind == graph


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("use_sq8", [False, True])
def test_delta_scans_match_reference(metric, use_sq8):
    rng = np.random.default_rng(3)
    cap, d = 48, 16
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    if metric == "ip":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    live = rng.random(cap) < 0.7
    q = rng.normal(size=(6, d)).astype(np.float32)
    if use_sq8:
        jseg = jdelta.DeltaSegment.empty(cap, d, metric).insert(
            vecs, np.arange(cap))
        codes, lo, scale = jseg._sq8()
        want = np.asarray(jdelta._scan_dists_sq8(
            codes, lo, scale, jnp.asarray(live), jnp.asarray(q), metric))
        got = tdelta._scan_dists_sq8(
            *(torch.as_tensor(np.array(a)) for a in (codes, lo, scale)),
            torch.as_tensor(live), torch.as_tensor(q), metric).numpy()
    else:
        want = np.asarray(jdelta._scan_dists(
            jnp.asarray(vecs), jnp.asarray(live), jnp.asarray(q), metric))
        got = tdelta._scan_dists(torch.as_tensor(vecs), torch.as_tensor(live),
                                 torch.as_tensor(q), metric).numpy()
    assert np.isinf(got[:, ~live]).all() and np.isinf(want[:, ~live]).all()
    np.testing.assert_allclose(got[:, live], want[:, live], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_sq8", [False, True])
def test_delta_topk_matches_reference(use_sq8):
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(40, 12)).astype(np.float32)
    ids = np.arange(100, 140)
    q = rng.normal(size=(5, 12)).astype(np.float32)
    jseg = jdelta.DeltaSegment.empty(64, 12, "l2").insert(vecs, ids)
    tseg = DeltaSegment.empty(64, 12, "l2").insert(vecs, ids)
    for e in (103, 120, 139):
        jseg, _ = jseg.delete(e)
        tseg, found = tseg.delete(e)
        assert found
    a = jseg.topk(q, 10, use_sq8=use_sq8)
    b = tseg.topk(q, 10, use_sq8=use_sq8, device="cpu")
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_allclose(b[1], a[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b[2], a[2])
    assert not np.isin(b[0], [103, 120, 139]).any()
    with pytest.raises(ValueError, match="overflow"):
        tseg.insert(np.zeros((25, 12), np.float32), np.arange(25))


def test_delta_scan_first_uses_count_new_shapes_only():
    seg = DeltaSegment.empty(32, 8, "l2").insert(
        np.ones((4, 8), np.float32), np.arange(4))
    q = np.zeros((3, 8), np.float32)
    seg.topk(q, 2, device="cpu")
    c0 = delta_scan_compile_count()
    seg.topk(q, 2, device="cpu")
    seg.insert(np.ones((1, 8), np.float32), [9]).topk(q, 5, device="cpu")
    assert delta_scan_compile_count() == c0     # fill level is data
    seg.topk(np.zeros((4, 8), np.float32), 2, device="cpu")
    assert delta_scan_compile_count() == c0 + 1  # a new batch shape


# --------------------------------------------------------------------------
# port-side behaviour: merge policy, failures, persistence, serving
# --------------------------------------------------------------------------
def _port(data, bases, graph="hnsw", engine="torch", **cfg_kw):
    _, payload = bases["l2"]
    _, tcfg = _configs(graph, **cfg_kw)
    return MutableAnnIndex(AnnIndex.from_payload(payload, device="cpu"),
                           config=tcfg,
                           spec=SearchSpec(engine=engine, **SPEC))


def test_overflow_triggers_sync_merge_and_off_raises(data, bases):
    ds = data["l2"]
    mi = _port(data, bases, auto_merge="sync", merge_threshold=2.0,
               tombstone_threshold=2.0)
    mi.insert(ds.base[N0:N0 + 60])
    assert mi.epoch == 0
    mi.insert(ds.base[N0 + 60:N0 + 70])       # 60 + 10 > 64: must merge
    assert mi.epoch == 1 and mi.n_live == N0 + 70
    off = _port(data, bases, auto_merge="off")
    off.insert(ds.base[N0:N0 + 64])
    with pytest.raises(ValueError, match="auto_merge"):
        off.insert(ds.base[N0 + 64:N0 + 65])
    with pytest.raises(KeyError):
        off.delete([N0 + 5000])


def test_merge_retry_recovers_within_budget(data, bases):
    ds = data["l2"]
    mi = _port(data, bases, auto_merge="sync", merge_retries=3,
               merge_backoff_s=0.001)
    fault.arm("mutate.merge.build", kind="raise", max_fires=2)
    mi.insert(ds.base[N0:N0 + 50])            # past 0.75 * 64: sync merge
    assert mi.epoch == 1 and mi.merge_retries_used == 2
    assert not mi.quarantined and mi.merge_error is None


def test_exhausted_retries_quarantine_not_poison(data, bases):
    ds = data["l2"]
    mi = _port(data, bases, auto_merge="background", merge_retries=1,
               merge_backoff_s=0.001, quarantine_cooldown_s=60.0)
    fault.arm("mutate.merge.build", kind="raise")
    mi.insert(ds.base[N0:N0 + 50])            # spawns the failing merge
    mi._merge_thread.join(timeout=60)
    assert mi.quarantined and isinstance(mi.merge_error, fault.FaultInjected)
    assert mi.epoch == 0, "a failed merge must never swap"
    ids, _, _ = mi.search(ds.queries[:2])
    assert (ids >= 0).all()
    mi.delete(int(ids[0, 0]))
    mi.insert(ds.base[N0 + 50:N0 + 60])       # the delta still has room
    with pytest.raises(MergeQuarantinedError, match="quarantined"):
        mi.insert(ds.base[N0 + 60:N0 + 70])   # genuinely full
    fault.disarm("mutate.merge.build")
    mi.clear_quarantine()
    mi.maybe_merge()
    mi.wait_for_merge()
    assert mi.epoch == 1
    mi.insert(ds.base[N0 + 60:N0 + 70])       # the refused write lands now


def test_swap_fault_leaves_the_old_snapshot_serving(data, bases):
    ds = data["l2"]
    mi = _port(data, bases, auto_merge="off")
    mi.insert(ds.base[N0:N0 + 20])
    fault.arm("mutate.merge.swap", kind="raise", hits={0})
    with pytest.raises(fault.FaultInjected):
        mi.merge()
    assert mi.epoch == 0 and mi.n_live == N0 + 20
    assert mi.merge()
    assert mi.epoch == 1 and mi.n_live == N0 + 20


def test_profile_refresh_policy(data, bases):
    ds = data["l2"]
    mi = _port(data, bases, delta_capacity=512, profile_refresh_fraction=0.1)
    p0 = mi._state.snapshot.index.profile
    mi.insert(ds.base[N0:N0 + 50])            # +5% < 10%: carried
    mi.merge()
    assert mi._state.snapshot.index.profile is p0
    mi.insert(ds.base[N0 + 50:N0 + 200])      # 1200 vs 1000: 20% drift
    mi.merge()
    p2 = mi._state.snapshot.index.profile
    assert p2 is not p0 and p2.corpus_n == N0 + 200


def test_save_is_snapshot_only_and_warns(tmp_path, data, bases):
    ds = data["l2"]
    mi = _port(data, bases)
    mi.insert(ds.base[N0:N0 + 30])
    mi.delete(list(range(10)))
    path = str(tmp_path / "mut.npz")
    with pytest.warns(UserWarning, match="snapshot-only"):
        mi.save(path)
    assert AnnIndex.load(path, device="cpu").graph.n == N0
    with pytest.raises(ValueError, match="snapshot-only"):
        mi.save(path, strict=True)
    mi.merge()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mi.save(path)
    assert JIndex.load(path).graph.n == N0 + 20   # the reference loads it


def test_cache_hygiene_across_merge_cycles(data, bases):
    ds = data["l2"]
    mi = _port(data, bases)
    mi.search(ds.queries[:4])
    for cycle in range(3):
        mi.insert(ds.base[N0 + cycle * 8:][:8])
        mi.merge()
        mi.search(ds.queries[:4])
    S._purge_dead_cache_entries()
    assert not [k for k, v in S._ENGINE_CACHE.items() if v[0]() is None]
    assert not [k for k, v in S._ARRAYS_CACHE.items() if v[0]() is None]
    gid = id(mi._state.snapshot.index.graph)
    assert len([k for k in S._ENGINE_CACHE if k[0] == gid]) == 1


@pytest.mark.parametrize("graph", ["hnsw", "nsg"])
def test_serving_across_background_merge_pays_no_first_use(data, bases,
                                                           graph):
    """A frontend over the mutable index serves a ragged trace while a
    background merge (HNSW, or NSG whose acquisition runs the fused
    engine) rebuilds and swaps: every request resolves, deleted ids never
    come back, and no request pays a first-use event — the merge pre-warms
    every noted shape on the fresh graph, and the count stays flat."""
    ds = data["l2"]
    mi = _port(data, bases, graph=graph, engine="fused",
               auto_merge="background", delta_capacity=48)
    spec = SearchSpec(engine="fused", **SPEC)
    assert isinstance(make_session(mi, spec), MutableIndexSession)
    fe = ServeFrontend(mi, spec, buckets=(1, 8, 32))
    warm = mi.compile_count()
    assert warm > 0 and fe.telemetry.recompiles_after_warmup == 0
    rng = np.random.default_rng(3)
    futs, dead = [], set()
    for step in range(16):
        n = [1, 5, 8, 20][step % 4]
        futs.append((fe.submit(ds.queries[rng.integers(0, 24, n)]),
                     set(dead)))
        fe.flush()
        mi.insert(ds.base[N0 + step * 6:N0 + step * 6 + 6])
        if step % 4 == 0:
            kill = rng.choice(mi.live_ids(), 2, replace=False)
            mi.delete(kill)
            dead.update(int(x) for x in kill)
    mi.wait_for_merge()
    fe.flush()
    for f, dead_at_submit in futs:
        ids, _, st = f.result(timeout=120)
        assert not np.isin(ids, sorted(dead_at_submit)).any()
        assert (st.extra["delta_scanned"] >= 0).all()
    assert mi.merges_completed >= 1
    assert mi.last_merge["n"] > 0 and mi.last_merge["build_secs"] > 0
    assert fe.telemetry.recompiles_after_warmup == 0
    assert mi.compile_count() == warm
    h = fe.health()["backend"]
    assert h["kind"] == "mutable" and h["epoch"] == mi.epoch
