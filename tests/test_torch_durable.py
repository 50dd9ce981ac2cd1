"""The port's write-ahead log, checkpoints and recovery against the JAX
package's.

The on-disk formats are the reference's byte for byte: the same records
encode to the same frames, the same manifest to the same file, and a
durable directory written by either package's ``MutableAnnIndex`` (WAL
segments, checkpoints from ``checkpoint()`` and from a merge, a manifest)
is recovered by the other into equal live ids and equal searches.  The
five-site crash sweep (``wal.append``, ``wal.fsync``, ``wal.rotate``,
``checkpoint.write``, ``manifest.rename``, the reference's
``CHAOS_SITES``) shows no acknowledged mutation lost and no delete
resurrected, and the port recovers the same live ids as the reference
does after the same crash.  The WAL framing, torn-tail and mid-log rules,
fsync policies, group commit and the poisoned writer are the copies'
own tests.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro.core.index import AnnIndex as JIndex
from repro.core.spec import SearchSpec as JSpec
from repro.durable import manifest as jmanifest
from repro.durable import wal as jwal
from repro.mutate import MutableAnnIndex as JMutable
from repro.mutate import MutateConfig as JConfig

from repro_torch import fault
from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.durable import (Manifest, SegmentWriter, WalFailedError,
                                 damage_file, read_manifest, read_npz_verified,
                                 read_segment, write_manifest)
from repro_torch.durable import wal
from repro_torch.fault import CorruptIndexError, FaultInjected
from repro_torch.mutate import MutableAnnIndex, MutateConfig

SPEC = dict(k=5, efs=24, router="crouting")
HNSW_KW = dict(m=8, efc=48)
CHAOS_SITES = ["wal.append", "wal.fsync", "wal.rotate", "checkpoint.write",
               "manifest.rename"]


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
def _disarm_all():
    yield
    fault.disarm()
    jfault.disarm()


@pytest.fixture(scope="module")
def payload(small_ds):
    return JIndex.build(small_ds.base[:400], graph="hnsw", **HNSW_KW
                        )._payload()


def _cfg(**kw):
    base = dict(delta_capacity=64, auto_merge="off", graph="hnsw",
                graph_kw=dict(HNSW_KW))
    base.update(kw)
    return base


PACKAGES = {
    "jax": (lambda p: JIndex._from_payload(p), JMutable, JConfig, jfault),
    "torch": (lambda p: AnnIndex.from_payload(p, device="cpu"),
              MutableAnnIndex, MutateConfig, fault),
}


def _durable(pkg, payload, dirname, **cfg_kw):
    make_index, cls, config, _ = PACKAGES[pkg]
    return cls(make_index(payload), config=config(**_cfg(**cfg_kw)),
               durable_dir=str(dirname))


def _recover(pkg, dirname, **cfg_kw):
    _, cls, config, _ = PACKAGES[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return cls.recover(str(dirname), config=config(**_cfg(**cfg_kw)), **kw)


def _search(pkg, mi, queries):
    if pkg == "jax":
        return mi.search(queries, spec=JSpec(engine="jnp", **SPEC))
    return mi.search(queries, spec=SearchSpec(engine="torch", **SPEC))


# --------------------------------------------------------------------------
# byte-for-byte formats
# --------------------------------------------------------------------------
def test_wal_frames_equal_reference_bytes():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(5, 7)).astype(np.float32)
    ids = np.arange(40, 45)
    assert (wal.frame(wal.encode_insert(3, ids, vecs))
            == jwal.frame(jwal.encode_insert(3, ids, vecs)))
    assert (wal.frame(wal.encode_delete(4, ids[:2]))
            == jwal.frame(jwal.encode_delete(4, ids[:2])))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_written_by_either_reads_in_both(tmp_path, writer):
    m = dict(checkpoint="checkpoint-00000003.npz",
             segments=["wal-00000002.log", "wal-00000003.log"], next_lsn=41,
             meta={"kind": "mutable-index"})
    if writer == "jax":
        jmanifest.write_manifest(str(tmp_path), jmanifest.Manifest(**m))
    else:
        write_manifest(str(tmp_path), Manifest(**m))
    assert read_manifest(str(tmp_path)) == Manifest(**m)
    assert jmanifest.read_manifest(str(tmp_path)) == jmanifest.Manifest(**m)


def test_segments_written_by_either_read_in_both(tmp_path):
    vecs = np.arange(12, dtype=np.float32).reshape(3, 4)
    for name, mod in (("t.log", wal), ("j.log", jwal)):
        w = mod.SegmentWriter(str(tmp_path / name), fsync="every")
        w.append(mod.encode_insert, np.array([7, 8, 9]), vecs)
        w.wait_durable(w.append(mod.encode_delete, np.array([8])))
        w.close()
    assert (tmp_path / "t.log").read_bytes() == (tmp_path / "j.log"
                                                  ).read_bytes()
    recs, _, torn = read_segment(str(tmp_path / "j.log"), final=True)
    jrecs, _, _ = jwal.read_segment(str(tmp_path / "t.log"), final=True)
    assert not torn and [r.lsn for r in recs] == [r.lsn for r in jrecs]
    np.testing.assert_array_equal(recs[0].vectors, jrecs[0].vectors)


# --------------------------------------------------------------------------
# cross-package recovery
# --------------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_directory_recovers_in_the_other_package(tmp_path, small_ds, payload,
                                                 writer, reader):
    """Acked inserts and deletes across a ``checkpoint()`` and a merge
    (``checkpoint_on_merge``: rotate + publish) and after them; the other
    package recovers equal live ids, ``next_ext`` and searches."""
    d = tmp_path / "d"
    mi = _durable(writer, payload, d)
    ids = mi.insert(small_ds.base[400:430])
    mi.delete([0, 5, int(ids[2])])
    mi.checkpoint()
    mi.insert(small_ds.base[430:450])
    mi.merge()
    ids = mi.insert(small_ds.base[450:460])
    mi.delete([7, int(ids[1])])
    mi.close()
    back = _recover(reader, d)
    np.testing.assert_array_equal(back.live_ids(), mi.live_ids())
    assert back._next_ext == mi._next_ext and back.epoch == mi.epoch == 1
    a = _search(writer, mi, small_ds.queries[:8])
    b = _search(reader, back, small_ds.queries[:8])
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]),
                               rtol=1e-5, atol=1e-5)
    # the recovered index keeps logging in its own package's hands
    back.insert(small_ds.base[460:462])
    back.close()
    again = _recover(writer, d)
    np.testing.assert_array_equal(again.live_ids(), back.live_ids())


# --------------------------------------------------------------------------
# the kill-at-every-site sweep, on both packages
# --------------------------------------------------------------------------
def _chaos_run(pkg, site, dirname, small_ds, payload):
    """Acked mutations -> crash at ``site`` -> recover.  Returns
    (acked_live_ids, deleted_ids, recovered_index)."""
    mod = PACKAGES[pkg][3]
    mi = _durable(pkg, payload, dirname)
    ids = mi.insert(small_ds.base[400:430])     # acked
    deleted = [int(ids[1]), int(ids[7]), 11]
    mi.delete(deleted)                          # acked
    acked = mi.live_ids()
    mod.arm(site, kind="raise", hits={0})
    crashed = False
    try:
        mi.insert(small_ds.base[430:440])       # never acked if it raises
    except (mod.FaultInjected, wal.WalFailedError, jwal.WalFailedError):
        crashed = True
    if not crashed:
        # sites on the checkpoint path only fire there
        try:
            mi.checkpoint()
        except (mod.FaultInjected, wal.WalFailedError, jwal.WalFailedError):
            crashed = True
    assert crashed, f"failpoint {site} never fired"
    mod.disarm()
    return acked, deleted, _recover(pkg, dirname)


@pytest.mark.parametrize("site", CHAOS_SITES)
def test_crash_sweep_zero_acked_loss_matches_reference(site, tmp_path,
                                                       small_ds, payload):
    acked, deleted, back = _chaos_run("torch", site, tmp_path / "t",
                                      small_ds, payload)
    recovered = set(map(int, back.live_ids()))
    missing = set(map(int, acked)) - recovered
    assert not missing, f"{site}: lost acked ids {sorted(missing)}"
    raised = recovered & set(deleted)
    assert not raised, f"{site}: resurrected deleted ids {sorted(raised)}"
    _, _, jback = _chaos_run("jax", site, tmp_path / "j", small_ds, payload)
    np.testing.assert_array_equal(back.live_ids(), jback.live_ids())
    # the recovered index is fully operational (mutate + search + ack)
    back.insert(small_ds.base[440:442])
    out, _, _ = _search("torch", back, small_ds.queries[:2])
    assert (out >= 0).all()


def test_midlog_corruption_refuses_replay(tmp_path, small_ds, payload):
    mi = _durable("torch", payload, tmp_path / "d", wal_fsync="off")
    mi.insert(small_ds.base[400:410])
    fault.arm("wal.append", kind="corrupt", hits={0})
    mi.insert(small_ds.base[410:415])           # damaged frame
    fault.disarm()
    mi.insert(small_ds.base[415:420])           # valid bytes AFTER it
    mi.close()
    for pkg in ("torch", "jax"):
        with pytest.raises((CorruptIndexError, jfault.CorruptIndexError),
                           match="mid-log|CRC"):
            _recover(pkg, tmp_path / "d")


def test_torn_tail_recovery_via_truncate_failpoint(tmp_path, small_ds,
                                                   payload):
    mi = _durable("torch", payload, tmp_path / "d")
    mi.insert(small_ds.base[400:420])
    acked = mi.live_ids()
    fault.arm("wal.append", kind="truncate", hits={0})
    with pytest.raises(FaultInjected):
        mi.insert(small_ds.base[420:425])      # torn mid-frame, never acked
    fault.disarm()
    with pytest.raises(WalFailedError):
        mi.insert(small_ds.base[425:430])
    back = _recover("torch", tmp_path / "d")
    np.testing.assert_array_equal(back.live_ids(), acked)
    back.close()
    np.testing.assert_array_equal(_recover("jax", tmp_path / "d").live_ids(),
                                  acked)


def test_double_recovery_idempotence(tmp_path, small_ds, payload):
    mi = _durable("torch", payload, tmp_path / "d")
    ids = mi.insert(small_ds.base[400:420])
    mi.delete([int(ids[0]), 3])
    mi.close()
    r1 = _recover("torch", tmp_path / "d")
    ids2 = r1.insert(small_ds.base[420:430])
    r1.delete([int(ids2[1]), int(ids[5]), 9])
    want = r1.live_ids()
    r1.close()
    r2 = _recover("torch", tmp_path / "d")
    np.testing.assert_array_equal(r2.live_ids(), want)
    assert r2._next_ext == r1._next_ext
    for e in (int(ids[0]), 3, int(ids2[1]), int(ids[5]), 9):
        with pytest.raises(KeyError):
            r2.delete([e])


def test_checkpoint_rotates_and_prunes(tmp_path, small_ds, payload):
    mi = _durable("torch", payload, tmp_path / "d")
    mi.insert(small_ds.base[400:420])
    name = mi.checkpoint()
    assert set(os.listdir(tmp_path / "d")) == {"MANIFEST", name,
                                                "wal-00000002.log"}
    m = read_manifest(str(tmp_path / "d"))
    assert m.checkpoint == name and m.segments == ["wal-00000002.log"]
    mi.delete([0])
    mi.close()
    back = _recover("torch", tmp_path / "d")
    np.testing.assert_array_equal(back.live_ids(), mi.live_ids())
    damage_file(str(tmp_path / "d" / name), "truncate")
    with pytest.raises(CorruptIndexError):
        read_npz_verified(str(tmp_path / "d" / name))
    with pytest.raises(CorruptIndexError):
        _recover("torch", tmp_path / "d")


def test_replay_merges_when_delta_overflows(tmp_path, small_ds, payload):
    mi = _durable("torch", payload, tmp_path / "d", delta_capacity=16,
                  checkpoint_on_merge=False)
    for i in range(5):
        mi.insert(small_ds.base[400 + 10 * i:410 + 10 * i])
        if mi._state.delta.room < 10:
            mi.merge()          # no checkpoint: the log keeps everything
    mi.close()
    back = _recover("torch", tmp_path / "d", delta_capacity=16,
                    checkpoint_on_merge=False)
    np.testing.assert_array_equal(back.live_ids(), mi.live_ids())


def test_create_refuses_existing_state_and_plain_index_has_no_log(
        tmp_path, small_ds, payload):
    _durable("torch", payload, tmp_path / "d")
    with pytest.raises(ValueError, match="already holds durable state"):
        _durable("torch", payload, tmp_path / "d")
    mi = MutableAnnIndex(AnnIndex.from_payload(payload, device="cpu"),
                         config=MutateConfig(**_cfg()))
    mi.insert(small_ds.base[400:410])
    assert mi._durable is None
    with pytest.raises(ValueError, match="durable store"):
        mi.checkpoint()


# --------------------------------------------------------------------------
# the WAL copy's own rules
# --------------------------------------------------------------------------
def test_torn_tail_tolerated_only_on_final_segment(tmp_path):
    p = str(tmp_path / "w.log")
    w = SegmentWriter(p, fsync="off")
    w.append(wal.encode_delete, np.array([1]))
    w.append(wal.encode_delete, np.array([2]))
    w.close()
    good = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(wal.frame(wal.encode_delete(2, np.array([3])))[:9])
    recs, valid_len, torn = read_segment(p, final=True)
    assert torn and valid_len == good and len(recs) == 2
    with pytest.raises(CorruptIndexError, match="non-final"):
        read_segment(p, final=False)


def test_crc_damage_midlog_raises_final_frame_tolerated(tmp_path):
    p = str(tmp_path / "w.log")
    w = SegmentWriter(p, fsync="off")
    for i in range(3):
        w.append(wal.encode_delete, np.array([i]))
    w.close()
    size = os.path.getsize(p)
    frame_len = size // 3

    def flip(at):
        with open(p, "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0xFF]))

    flip(size - 1)
    recs, valid_len, torn = read_segment(p, final=True)
    assert torn and len(recs) == 2 and valid_len == 2 * frame_len
    flip(frame_len - 1)
    with pytest.raises(CorruptIndexError, match="mid-log"):
        read_segment(p, final=True)


@pytest.mark.parametrize("policy", ["every", "interval", "off"])
def test_fsync_policies_ack_and_replay(tmp_path, policy):
    p = str(tmp_path / "w.log")
    w = SegmentWriter(p, fsync=policy, interval_s=0.001)
    lsns = [w.append(wal.encode_delete, np.array([i])) for i in range(5)]
    for lsn in lsns:
        w.wait_durable(lsn)
    w.close()
    recs, _, torn = read_segment(p, final=True)
    assert not torn and [r.lsn for r in recs] == lsns


def test_group_commit_concurrent_acks(tmp_path):
    p = str(tmp_path / "w.log")
    w = SegmentWriter(p, fsync="interval", interval_s=0.002)
    errs = []

    def one(i):
        try:
            w.wait_durable(w.append(wal.encode_delete, np.array([i])))
        except Exception as e:   # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    w.close()
    assert not errs
    recs, _, torn = read_segment(p, final=True)
    assert not torn and [r.lsn for r in recs] == list(range(16))


def test_fsync_failure_poisons_writer(tmp_path):
    p = str(tmp_path / "w.log")
    w = SegmentWriter(p, fsync="every")
    lsn = w.append(wal.encode_delete, np.array([1]))
    fault.arm("wal.fsync", kind="raise", hits={0})
    with pytest.raises(FaultInjected):
        w.wait_durable(lsn)
    fault.disarm()
    with pytest.raises(WalFailedError):
        w.append(wal.encode_delete, np.array([2]))
    with pytest.raises(WalFailedError):
        w.wait_durable(lsn)


def test_manifest_damage_detected(tmp_path):
    d = str(tmp_path)
    write_manifest(d, Manifest(checkpoint=None, segments=["wal-00000001.log"],
                               next_lsn=17))
    path = os.path.join(d, "MANIFEST")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw.replace(b"17", b"18"))
    with pytest.raises(CorruptIndexError, match="CRC"):
        read_manifest(d)
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CorruptIndexError):
        read_manifest(d)
