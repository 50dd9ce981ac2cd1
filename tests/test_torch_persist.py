"""Index persistence in the port: ``AnnIndex.save``/``load`` against the
JAX package's, the format version gate, the integrity checks and the
failpoints of the atomic write.

A file saved by either package loads in the other with every payload array
equal (same dtype and bytes) and the same search results (ids equal,
distances within rtol/atol 1e-5, the engines' tolerance in
``test_torch_search.py``); the stamped content checksum is the
reference's ``payload_checksum`` of the same payload.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.index import AnnIndex as JIndex
from repro.core.spec import SearchSpec as JSpec
from repro.durable.atomic import payload_checksum as j_checksum

from repro_torch import fault
from repro_torch.core.index import FORMAT_VERSION, AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.durable.atomic import (atomic_write_npz, damage_file,
                                        payload_checksum, read_npz)
from repro_torch.fault import CorruptIndexError


@pytest.fixture(scope="module")
def jidx(hnsw_index, hnsw_profile):
    return JIndex(graph=hnsw_index, profile=hnsw_profile)


@pytest.fixture(scope="module")
def tidx(jidx):
    return AnnIndex.from_payload(jidx._payload(), device="cpu")


def _same_payload(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _same_search(j, t, queries):
    ji, jd, js = j.search(queries, spec=JSpec(k=10, efs=48,
                                              router="crouting"))
    ti, td, ts = t.search(queries, spec=SearchSpec(k=10, efs=48,
                                                   router="crouting",
                                                   engine="torch"))
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(jd, td, rtol=1e-5, atol=1e-5)
    for c in ("dist_calls", "est_calls", "hops"):
        np.testing.assert_array_equal(getattr(js, c), getattr(ts, c))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_saved_by_one_package_loads_in_the_other(
        tmp_path, small_ds, jidx, tidx, writer):
    path = str(tmp_path / "idx.npz")
    if writer == "jax":
        jidx.save(path)
        j, t = jidx, AnnIndex.load(path, device="cpu")
    else:
        tidx.save(path)
        j, t = JIndex.load(path), tidx
    _same_payload(j._payload(), t._payload())
    assert t.profile.theta_star == jidx.profile.theta_star
    assert t.device == torch.device("cpu")
    _same_search(j, t, small_ds.queries[:16])


def test_checksum_and_format_version_are_the_references(tmp_path, tidx):
    path = str(tmp_path / "idx.npz")
    tidx.save(path)
    z = read_npz(path)
    assert int(z["format_version"]) == FORMAT_VERSION == 3
    body = {k: v for k, v in z.items() if k != "checksum"}
    assert int(z["checksum"]) == payload_checksum(body) == j_checksum(body)
    assert z["checksum"].dtype == np.uint64


def test_a_future_version_raises_value_error(tmp_path, tidx):
    path = str(tmp_path / "future.npz")
    payload = tidx._payload()
    payload["format_version"] = np.asarray(FORMAT_VERSION + 1)
    atomic_write_npz(path, payload)
    with pytest.raises(ValueError, match="newer"):
        AnnIndex.load(path, device="cpu")


@pytest.mark.parametrize("kind", ["truncate", "corrupt", "stale_checksum"])
def test_a_damaged_file_raises_corrupt_index_error(tmp_path, tidx, kind):
    path = str(tmp_path / "idx.npz")
    tidx.save(path)
    if kind == "stale_checksum":
        z = read_npz(path)
        z["entry_point"] = np.asarray(int(z["entry_point"]) + 1)
        np.savez(path, **z)            # keeps the old checksum entry
    else:
        damage_file(path, kind)
    with pytest.raises(CorruptIndexError):
        AnnIndex.load(path, device="cpu")


@pytest.mark.parametrize("site", ["index.save.write", "index.save.rename"])
def test_a_crash_while_saving_leaves_the_earlier_file(tmp_path, small_ds,
                                                      tidx, site):
    path = str(tmp_path / "idx.npz")
    tidx.save(path)
    other = AnnIndex.build(small_ds.base[:200], graph="knn", k=6,
                           profile=False, device="cpu")
    fault.arm(site, kind="raise")
    try:
        with pytest.raises(fault.FaultInjected):
            other.save(path)
        assert fault.fires(site) == 1
    finally:
        fault.disarm()
    assert os.listdir(tmp_path) == ["idx.npz"]       # no temp file left
    _same_payload(AnnIndex.load(path, device="cpu")._payload(),
                  tidx._payload())


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_damage_armed_at_the_write_site_is_caught_on_load(tmp_path, tidx,
                                                          kind):
    path = str(tmp_path / "idx.npz")
    with fault.scoped({"index.save.write": fault.FaultSpec(kind=kind)}):
        tidx.save(path)
    with pytest.raises(CorruptIndexError):
        AnnIndex.load(path, device="cpu")


def test_nsg_round_trip_and_the_payload_version_rules(tmp_path, small_ds):
    idx = AnnIndex.build(small_ds.base[:300], graph="nsg", r=10, c=30, l=12,
                         knn_k=10, device="cpu")
    path = str(tmp_path / "nsg.npz")
    idx.save(path)
    back = AnnIndex.load(path, device="cpu")
    assert back.graph.kind == "nsg" and back.graph.upper_neighbors is None
    _same_payload(idx._payload(), back._payload())
    spec = SearchSpec(k=5, efs=20, router="finger", engine="fused")
    a, b = idx.search(small_ds.queries, spec), back.search(small_ds.queries,
                                                           spec)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2].extra["finger_est_calls"],
                                  b[2].extra["finger_est_calls"])
    # v1 payloads (no stamp) may lack the later profile fields; v2+ may not
    v1 = {k: v for k, v in idx._payload().items()
          if k not in ("format_version", "theta_nq", "theta_secs",
                       "theta_corpus_n")}
    old = AnnIndex.from_payload(v1, device="cpu")
    assert old.profile.n_sample_queries == 0 and old.profile.corpus_n == 0
    v2 = dict(v1, format_version=np.asarray(2))
    with pytest.raises(KeyError):
        AnnIndex.from_payload(v2, device="cpu")


def test_load_defaults_to_the_gpu(tmp_path, tidx):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised when no GPU is present")
    path = str(tmp_path / "idx.npz")
    tidx.save(path)
    with pytest.raises(RuntimeError, match="cuda"):
        AnnIndex.load(path)


@pytest.mark.gpu
def test_load_on_gpu_searches_like_the_saved_index(tmp_path, small_ds, tidx):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    path = str(tmp_path / "idx.npz")
    tidx.save(path)
    back = AnnIndex.load(path)
    assert back.device.type == "cuda"
    spec = SearchSpec(k=10, efs=48, router="crouting", beam_width=4)
    a = back.search(small_ds.queries, spec)
    b = back.search(small_ds.queries, spec.replace(engine="torch"))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2].dist_calls, b[2].dist_calls)
