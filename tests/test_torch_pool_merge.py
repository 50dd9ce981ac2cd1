"""The pool contract of the port's ``pool_merge`` and its kernel variants.

The two-stage search path writes exact distances into the result pool in
place at beam selection (the stage-2 rerank), so ``ops.pool_merge`` is
handed pools that are not sorted; its kernel must order the whole union.
The probe below watches the merges of small two-stage searches on the CPU
and fails if none of them saw an unsorted pool, so that no later design of
the kernel can assume a sorted one.  The plain version is held against
``repro.kernels.ref.pool_merge_ref`` on shuffled pools, and the Python
choosers of the CUDA variants (``pool_merge`` and ``l2_distance``) are
checked as plain functions; the kernels themselves run only on the card
(``tests/test_torch_kernels.py`` and ``tests/test_torch_l2_distance.py``,
``gpu``-marked, and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.core.index import AnnIndex
from repro_torch.core.spec import SearchSpec
from repro_torch.data.vectors import make_dataset
from repro_torch.kernels import l2_distance as L2K
from repro_torch.kernels import ops
from repro_torch.kernels import pool_merge as PMK


def _is_sorted(d, i):
    """Per row: whether (d, i) is sorted lexicographically."""
    d0, d1, i0, i1 = d[:, :-1], d[:, 1:], i[:, :-1], i[:, 1:]
    return ((d0 < d1) | ((d0 == d1) & (i0 <= i1))).all(dim=1)


@pytest.fixture(scope="module")
def small_hnsw():
    ds = make_dataset(n_base=1500, n_query=16, dim=32, n_clusters=16, seed=5)
    return AnnIndex.build(ds.base, graph="hnsw", m=8, efc=48, device="cpu"), ds


@pytest.mark.parametrize("spec", [
    dict(router="crouting", estimate="both", beam_width=4),
    dict(router="none", estimate="sq8", beam_width=1)])
def test_two_stage_searches_merge_unsorted_pools(small_hnsw, spec,
                                                 monkeypatch):
    idx, ds = small_hnsw
    seen = []
    orig = ops.pool_merge

    def watch(pool_d, pool_i, new_d, new_i):
        seen.append(bool(_is_sorted(pool_d, pool_i).all()))
        return orig(pool_d, pool_i, new_d, new_i)

    monkeypatch.setattr(ops, "pool_merge", watch)
    idx.search(ds.queries, spec=SearchSpec(k=10, efs=32, engine="fused",
                                           **spec))
    assert seen, "the fused engine merged through ops.pool_merge"
    assert not all(seen), (
        f"no merge of the two-stage path saw an unsorted pool "
        f"({len(seen)} merges): the stage-2 rerank writes pool_d in place")


def _shuffled_inputs(seed, B, P, L):
    rng = np.random.default_rng(seed)
    n = 10 * (P + L)
    pd = np.round(rng.uniform(0, 3, size=(B, P)), 1).astype(np.float32)
    pi = (rng.integers(0, n, size=(B, P)) * 4
          + rng.integers(0, 2, size=(B, P))).astype(np.int32)
    pd[:, P // 2:], pi[:, P // 2:] = np.inf, n * 4
    nd = np.round(rng.uniform(0, 3, size=(B, L)), 1).astype(np.float32)
    ni = (rng.integers(0, n, size=(B, L)) * 4 + 2).astype(np.int32)
    nd[:, ::3], ni[:, ::3] = np.inf, n * 4
    perm = np.argsort(rng.random((B, P)), axis=1)     # sentinels included
    return (np.take_along_axis(pd, perm, axis=1),
            np.take_along_axis(pi, perm, axis=1), nd, ni)


@pytest.mark.parametrize("B,P,L", [(4, 16, 16), (8, 100, 128), (3, 200, 32),
                                   (2, 300, 400)])
def test_shuffled_pool_matches_jax_oracle(B, P, L):
    pd, pi, nd, ni = _shuffled_inputs(B + P + L, B, P, L)
    assert not _is_sorted(torch.as_tensor(pd), torch.as_tensor(pi)).any()
    td, ti = ops.pool_merge(*map(torch.as_tensor, (pd, pi, nd, ni)))
    jd, ji = jref.pool_merge_ref(*map(jnp.asarray, (pd, pi, nd, ni)))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert _is_sorted(td, ti).all()


@pytest.mark.parametrize("P,L,want", [
    (1, 1, ("warp", 32)), (16, 16, ("warp", 32)), (64, 32, ("warp", 128)),
    (100, 32, ("warp", 256)), (100, 128, ("warp", 256)),
    (200, 128, ("warp", 512)), (256, 256, ("warp", 512)),
    (256, 257, ("block", 1024)), (300, 400, ("block", 1024)),
    (2000, 2000, ("block", 4096)), (2048, 2048, ("block", 4096))])
def test_pool_merge_variant_follows_the_network_length(P, L, want):
    assert PMK.choose_variant(P, L) == want


def test_pool_merge_beyond_the_block_variant_raises():
    with pytest.raises(ValueError, match="exceeds"):
        PMK.choose_variant(2048, 2049)


@pytest.mark.parametrize("Q,C,d,elem,ptr,want", [
    (1, 1_000_000, 128, 4, 0, "stream"), (2, 8192, 128, 4, 1536, "stream"),
    (L2K.STREAM_MAX_Q, 1_000_000, 128, 4, 0, "stream"),
    (L2K.STREAM_MAX_Q + 1, 1_000_000, 128, 4, 0, "tiled"),
    (32, 1_000_000, 128, 4, 0, "tiled"),
    (1, 1_000_000, 128, 2, 0, "stream"), (1, 4096, 100, 4, 0, "stream"),
    (1, 4096, 100, 2, 0, "tiled"),      # 200-byte bf16 rows
    (1, 4096, 33, 4, 0, "tiled"), (1, 4096, 960, 4, 0, "stream"),
    (1, 4096, 128, 4, 8, "tiled"),      # base off 16-byte alignment
    (16, 1_000_000, 1024, 4, 0, "stream"),
    (16, 1_000_000, 1028, 4, 0, "tiled"),                   # query bytes
    (0, 4096, 128, 4, 0, "tiled"),
    # few candidate tiles: the stream kernel pays at any C up to Q = 4,
    # beyond only from C = 4096 * Q
    (4, 1, 128, 4, 0, "stream"), (5, 20_479, 128, 4, 0, "tiled"),
    (5, 20_480, 128, 4, 0, "stream"), (8, 8192, 128, 4, 0, "tiled"),
    (8, 32_768, 128, 4, 0, "stream"), (12, 32_768, 128, 4, 0, "tiled"),
    (12, 65_536, 128, 4, 0, "stream"), (16, 65_535, 128, 4, 0, "tiled"),
    (16, 65_536, 128, 4, 0, "stream")])
def test_l2_distance_variant_follows_q_and_alignment(Q, C, d, elem, ptr,
                                                     want):
    assert L2K.choose_variant(Q, C, d, elem, ptr) == want
