"""The port's ``MutableShardedAnnIndex`` against the JAX package's.

Three shard graphs (300 rows each, HNSW m=8, built by the JAX package and
carried across with ``AnnIndex.from_payload``) are wrapped by both
packages' ``MutableShardedAnnIndex`` and driven through one seeded
sequence of inserts and deletes with synchronous staggered merges (one
shard a trigger).  After every step the routing (``_ext_to_shard``), the
epochs and the live ids must be equal, and the searches (reference
``engine="jnp"``, port ``torch`` and ``fused``) return equal ids,
distances within 1e-5 and equal counters.  A search with
``shard.search.1`` armed degrades the same way in both; a directory saved
or logged by either package loads and recovers in the other.
"""
import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro.core.angles import sample_angle_profile as j_profile
from repro.core.hnsw import build_hnsw as j_hnsw
from repro.core.index import AnnIndex as JIndex
from repro.core.spec import SearchSpec as JSpec
from repro.data.vectors import make_dataset
from repro.mutate import MutableShardedAnnIndex as JSharded
from repro.mutate import MutateConfig as JConfig

from repro_torch import fault
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.fault import DegradedSearchError, MergeQuarantinedError
from repro_torch.mutate import MutableShardedAnnIndex, MutateConfig
from repro_torch.serve import (MutableShardedIndexSession, ServeFrontend,
                               make_session)

N_SHARDS, PER_SHARD = 3, 300
N0 = N_SHARDS * PER_SHARD
SPEC = dict(k=10, efs=32, router="crouting", beam_width=4)
COUNTERS = ("dist_calls", "est_calls", "hops", "rerank_calls", "sq8_calls")
CFG = dict(delta_capacity=32, merge_threshold=0.5, auto_merge="sync",
           graph="hnsw", graph_kw=dict(m=8, efc=48))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small searches run beside other test
    processes on a shared CPU (the setting is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.disarm()
    jfault.disarm()


@pytest.fixture(scope="module")
def ds():
    return make_dataset(n_base=1200, n_query=24, dim=32, n_clusters=12,
                        seed=4)


@pytest.fixture(scope="module")
def payloads(ds):
    out = []
    for s in range(N_SHARDS):
        g = j_hnsw(ds.base[s * PER_SHARD:(s + 1) * PER_SHARD], m=8, efc=48,
                   seed=s)
        out.append(JIndex(graph=g, profile=j_profile(
            g, n_sample=8, efs=32, seed=1))._payload())
    return out


def _pair(payloads, **kw):
    cfg = dict(CFG, **kw)
    j = JSharded([JIndex._from_payload(p) for p in payloads],
                 config=JConfig(**cfg))
    t = MutableShardedAnnIndex(
        [AnnIndex.from_payload(p, device="cpu") for p in payloads],
        config=MutateConfig(**cfg))
    return j, t


def _routing(m):
    """external id -> shard for the live ids (a deleted id keeps its
    entry until a recovery re-derives the map from the live ids)."""
    return {int(e): s for s, sh in enumerate(m.shards)
            for e in sh.live_ids() if m._ext_to_shard[int(e)] == s}


def _same_state(j, t):
    assert _routing(t) == _routing(j)
    assert len(_routing(t)) == t.n_live
    assert t._next_ext == j._next_ext and t.epochs == j.epochs
    assert t.n_live == j.n_live
    for js, ts in zip(j.shards, t.shards):
        np.testing.assert_array_equal(ts.live_ids(), js.live_ids())


def _same_search(j, t, queries, engines=("torch", "fused")):
    jids, jd, jst = j.search(queries, spec=JSpec(engine="jnp", **SPEC))
    for engine in engines:
        ids, d, st = t.search(queries, spec=SearchSpec(engine=engine,
                                                       **SPEC))
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
        for c in COUNTERS:
            np.testing.assert_array_equal(getattr(st, c),
                                          np.asarray(getattr(jst, c)))
        np.testing.assert_array_equal(st.extra["delta_scanned"],
                                      np.asarray(jst.extra["delta_scanned"]))
        assert (st.shards_failed, st.degraded) == (jst.shards_failed,
                                                   jst.degraded)
        assert st.iters == jst.iters
    return jids


def test_sequence_matches_reference(ds, payloads):
    j, t = _pair(payloads)
    assert t.n_live == N0
    _same_state(j, t)
    rng = np.random.default_rng(9)
    nxt, dead, staggered = N0, [], False
    for step in range(6):
        rows = ds.base[nxt:nxt + 16]
        nxt += 16
        merged = sum(t.epochs)
        np.testing.assert_array_equal(t.insert(rows), j.insert(rows))
        # one trigger merges at most one shard
        assert sum(t.epochs) - merged <= 1
        kill = [int(e) for e in rng.choice(j.shards[step % 3].live_ids(), 3,
                                           replace=False)]
        assert t.delete(kill) == j.delete(kill) == 3
        dead += kill
        _same_state(j, t)
        staggered |= len(set(t.epochs)) > 1
        ids = _same_search(j, t, ds.queries)
        assert not np.isin(ids, dead).any()
    # the shards merged out of phase with each other
    assert max(t.epochs) >= 1 and staggered
    # least-loaded routing put the inserts where the reference did
    assert [sh.n_live for sh in t.shards] == [sh.n_live for sh in j.shards]


def test_degraded_search_matches_reference(ds, payloads):
    j, t = _pair(payloads)
    rows = ds.base[N0:N0 + 8]
    t.insert(rows)
    j.insert(rows)
    q = ds.queries[:12]
    spec = SearchSpec(engine="fused", **SPEC)
    jspec = JSpec(engine="jnp", **SPEC)
    fault.arm("shard.search.1", kind="raise")
    jfault.arm("shard.search.1", kind="raise")
    ids, d, st = t.search(q, spec)
    jids, jd, jst = j.search(q, spec=jspec)
    assert st.degraded and st.shards_failed == 1
    assert (jst.degraded, jst.shards_failed) == (True, 1)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
    # the survivors' composition: shards 0 and 2 alone
    parts = [t.shards[s].search(q, spec) for s in (0, 2)]
    all_ids = np.concatenate([p[0] for p in parts], axis=1)
    all_d = np.concatenate([p[1] for p in parts], axis=1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, np.take_along_axis(all_ids, order, 1))
    assert not np.isin(ids, np.arange(PER_SHARD, 2 * PER_SHARD)).any()
    fault.arm("shard.search", kind="raise")
    with pytest.raises(DegradedSearchError):
        t.search(q, spec)


def test_straggler_past_the_deadline_is_dropped(ds, payloads):
    t = MutableShardedAnnIndex(
        [AnnIndex.from_payload(p, device="cpu") for p in payloads],
        config=MutateConfig(**CFG), shard_timeout_s=1.0)
    spec = SearchSpec(engine="torch", **SPEC)
    t.search(ds.queries[:4], spec)           # first uses off the clock
    fault.arm("shard.search.2", kind="delay", delay_s=3.0)
    ids, _, st = t.search(ds.queries[:4], spec)
    assert st.degraded and st.shards_failed == 1
    assert not np.isin(ids, np.arange(2 * PER_SHARD, N0)).any()


def test_background_merges_stagger_and_serve(ds, payloads):
    """Background merges: at most one shard merges at a time, the frontend
    serves across the swaps with no first use on the request path, and no
    deleted id comes back."""
    t = MutableShardedAnnIndex(
        [AnnIndex.from_payload(p, device="cpu") for p in payloads],
        config=MutateConfig(**dict(CFG, auto_merge="background")))
    spec = SearchSpec(engine="fused", **SPEC)
    fe = ServeFrontend(t, spec, buckets=(1, 8, 32))
    assert isinstance(fe._base.engine, MutableShardedIndexSession)
    rng = np.random.default_rng(3)
    dead = []
    for step in range(6):
        t.insert(ds.base[N0 + 16 * step:N0 + 16 * (step + 1)])
        kill = [int(e) for e in rng.choice(t.shards[step % 3].live_ids(), 2,
                                           replace=False)]
        t.delete(kill)
        dead += kill
        assert sum(th.is_alive() for th in t._merge_threads.values()) <= 1
        fut = fe.submit(ds.queries[:5])
        fe.flush()
        assert not np.isin(fut.result(timeout=60)[0], dead).any()
    t.wait_for_merges()
    assert max(t.epochs) >= 1
    fut = fe.submit(ds.queries[:7])
    fe.flush()
    assert not np.isin(fut.result(timeout=60)[0], dead).any()
    assert fe.telemetry.summary()["recompiles_after_warmup"] == 0
    h = fe.health()["backend"]
    assert h["kind"] == "mutable-sharded" and h["n_shards"] == N_SHARDS
    assert make_session(t).splits_stats is False


def test_pick_shard_routes_around_full_quarantined_shards(payloads):
    t = MutableShardedAnnIndex(
        [AnnIndex.from_payload(p, device="cpu") for p in payloads],
        config=MutateConfig(**dict(CFG, auto_merge="off")))
    assert t._pick_shard(4) == 0                 # all equal: the first
    for sh in t.shards:
        sh._quarantined_until = float("inf")
    assert t.quarantined_shards == (0, 1, 2)
    with pytest.raises(MergeQuarantinedError):
        t._pick_shard(CFG["delta_capacity"] + 1)
    t.clear_quarantine()
    assert t.quarantined_shards == ()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_and_logged_dirs_cross_packages(ds, payloads, tmp_path,
                                              writer):
    """``save`` in one package, ``load`` in the other; a durable directory
    logged by one ``recover``s in the other, with equal routing, live ids
    and searches."""
    j, t = _pair(payloads, auto_merge="off")
    for m in (j, t):
        m.insert(ds.base[N0:N0 + 20])
        m.delete([3, 400, 905])
    src = j if writer == "jax" else t
    src.save(str(tmp_path / "saved"))
    if writer == "jax":
        back = MutableShardedAnnIndex.load(
            str(tmp_path / "saved"), config=MutateConfig(**CFG),
            device="cpu")
        _same_state(j, back)
        _same_search(j, back, ds.queries[:8], engines=("torch",))
    else:
        back = JSharded.load(str(tmp_path / "saved"),
                             config=JConfig(**CFG))
        _same_state(back, t)
        _same_search(back, t, ds.queries[:8], engines=("torch",))

    # a live durable directory: created, mutated, closed, recovered
    d = str(tmp_path / "live")
    if writer == "jax":
        w = JSharded([JIndex._from_payload(p) for p in payloads],
                     config=JConfig(**CFG), durable_dir=d)
    else:
        w = MutableShardedAnnIndex(
            [AnnIndex.from_payload(p, device="cpu") for p in payloads],
            config=MutateConfig(**CFG), durable_dir=d)
    w.insert(ds.base[N0:N0 + 12])
    w.delete([5, 650])
    w.close()
    if writer == "jax":
        r = MutableShardedAnnIndex.recover(d, config=MutateConfig(**CFG),
                                           device="cpu")
        _same_state(w, r)
        _same_search(w, r, ds.queries[:8], engines=("torch",))
    else:
        r = JSharded.recover(d, config=JConfig(**CFG))
        _same_state(r, w)
        _same_search(r, w, ds.queries[:8], engines=("torch",))
    r.close()
