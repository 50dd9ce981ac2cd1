"""FINGER baseline (Chen et al., WWW'23) — residual-subspace distance estimate.

A NumPy copy of ``repro.core.finger``: on the same graph and seed it
builds the same tables bit for bit (``ensure_finger_arrays`` moves them to
the device for the engine-integrated ``finger`` router).

For every edge (c -> n) FINGER decomposes n into a component parallel to c and
a residual, and estimates at query time (paper Eq. 1):

    |q - n|^2 ~= (t_q - t_n)^2 |c|^2 + |q_res|^2 + |n_res|^2
                 - 2 |q_res| |n_res| cos(pi * rho)

where rho is the hamming distance ratio between sign-LSH signatures of the
residuals.  Deviations from the original (documented in DESIGN.md §7): global
random hyperplanes instead of per-node subspaces.  Signatures of q_res w.r.t.
node c are formed as sign(Hq - t_q * Hc), so the per-expansion cost is O(r),
with Hq computed once per query.

Construction stores, per edge: t_n, |n_res|, packed signature bits; per node:
|c|^2 and Hc — this is the memory overhead the paper's Table 7 highlights.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Tuple

import numpy as np

from repro_torch.core.graph import GraphIndex
from repro_torch.core.ref_search import (STATUS_UNVISITED, STATUS_VISITED,
                                         SearchStats)


@dataclasses.dataclass
class FingerIndex:
    graph: GraphIndex
    hyperplanes: np.ndarray    # [r, d]
    node_c2: np.ndarray        # [N] |c|^2
    node_hc: np.ndarray        # [N, r] H @ c
    edge_t: np.ndarray         # [N, M] projection coefficient t_n
    edge_res_norm: np.ndarray  # [N, M] |n_res|
    edge_sig: np.ndarray       # [N, M, r//64] packed sign bits
    build_secs: float = 0.0

    def extra_bytes(self) -> int:
        return int(self.node_c2.nbytes + self.node_hc.nbytes + self.edge_t.nbytes
                   + self.edge_res_norm.nbytes + self.edge_sig.nbytes)


def _pack_signs(x: np.ndarray) -> np.ndarray:
    """x [..., r] floats -> packed uint64 [..., r//64]."""
    bits = (x > 0).astype(np.uint64)
    r = bits.shape[-1]
    words = r // 64
    out = np.zeros(bits.shape[:-1] + (words,), dtype=np.uint64)
    for w in range(words):
        for b in range(64):
            out[..., w] |= bits[..., w * 64 + b] << np.uint64(b)
    return out


_POPCOUNT = np.array([bin(i).count("1") for i in range(65536)], dtype=np.int32)


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = a ^ b
    h = np.zeros(x.shape[:-1], dtype=np.int32)
    for w in range(x.shape[-1]):
        v = x[..., w]
        for s in (0, 16, 32, 48):
            h += _POPCOUNT[((v >> np.uint64(s)) & np.uint64(0xFFFF)).astype(np.int64)]
    return h


def build_finger(g: GraphIndex, r_bits: int = 64, seed: int = 0) -> FingerIndex:
    t0 = time.time()
    assert r_bits % 64 == 0
    n, d = g.n, g.dim
    m = g.max_degree
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(r_bits, d)).astype(np.float32)
    vecs = g.vectors
    c2 = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    hc = (vecs @ H.T).astype(np.float32)
    edge_t = np.zeros((n, m), np.float32)
    edge_rn = np.zeros((n, m), np.float32)
    edge_sig = np.zeros((n, m, r_bits // 64), np.uint64)
    for i in range(n):
        nbrs = g.neighbors[i]
        k = int((nbrs < n).sum())
        if k == 0:
            continue
        ids = nbrs[:k].astype(np.int64)
        nv = vecs[ids]                       # [k, d]
        t = (nv @ vecs[i]) / max(c2[i], 1e-12)
        res = nv - t[:, None] * vecs[i][None, :]
        edge_t[i, :k] = t
        edge_rn[i, :k] = np.linalg.norm(res, axis=1)
        edge_sig[i, :k] = _pack_signs(res @ H.T)
    return FingerIndex(graph=g, hyperplanes=H, node_c2=c2, node_hc=hc,
                       edge_t=edge_t, edge_res_norm=edge_rn, edge_sig=edge_sig,
                       build_secs=time.time() - t0)


def finger_search(fi: FingerIndex, q: np.ndarray, entry: int, efs: int,
                  max_hops: int = 10**9) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Greedy search with FINGER distance-estimate pruning (L2 metric)."""
    g = fi.graph
    n = g.n
    vecs = g.vectors
    status = np.zeros(n, np.uint8)
    stats = SearchStats()
    Hq = fi.hyperplanes @ q                  # once per query
    r_bits = fi.hyperplanes.shape[0]

    def exact(i):
        stats.dist_calls += 1
        d = q - vecs[i]
        return float(np.dot(d, d))

    d0 = exact(entry)
    status[entry] = STATUS_VISITED
    C = [(d0, entry)]
    T = [(-d0, entry)]
    while C and stats.hops < max_hops:
        dc, c = heapq.heappop(C)
        upper = -T[0][0]
        if dc > upper and len(T) >= efs:
            break
        stats.hops += 1
        nbrs = g.neighbors[c]
        k = int((nbrs < n).sum())
        if k == 0:
            continue
        ids = nbrs[:k].astype(np.int64)
        c2 = max(float(fi.node_c2[c]), 1e-12)
        t_q = float(np.dot(q, vecs[c])) / c2
        q_res2 = max(float(np.dot(q, q)) - t_q * t_q * c2, 0.0)
        q_rn = np.sqrt(q_res2)
        sig_q = _pack_signs((Hq - t_q * fi.node_hc[c])[None, :])[0]

        st = status[ids]
        fresh = st == STATUS_UNVISITED
        pool_full = len(T) >= efs
        if pool_full and fresh.any():
            sel = np.nonzero(fresh)[0]
            t_n = fi.edge_t[c, sel]
            n_rn = fi.edge_res_norm[c, sel]
            rho = _hamming(sig_q[None, :], fi.edge_sig[c, sel]) / r_bits
            stats.est_calls += len(sel)
            est = ((t_q - t_n) ** 2 * c2 + q_res2 + n_rn**2
                   - 2.0 * q_rn * n_rn * np.cos(np.pi * rho))
            pruned = sel[est >= upper]
            status[ids[pruned]] = STATUS_VISITED  # FINGER prunes permanently
            stats.pruned_ids.update(int(ids[p]) for p in pruned)
        for slot in range(k):
            nid = int(ids[slot])
            if status[nid] == STATUS_VISITED:
                continue
            status[nid] = STATUS_VISITED
            dn = exact(nid)
            if dn < upper or len(T) < efs:
                heapq.heappush(C, (dn, nid))
                heapq.heappush(T, (-dn, nid))
                if len(T) > efs:
                    heapq.heappop(T)
                upper = -T[0][0]
    out = sorted(((-d, i) for d, i in T))
    ids_out = np.full(efs, -1, np.int64)
    ds_out = np.full(efs, np.inf, np.float32)
    for j, (d, i) in enumerate(out[:efs]):
        ids_out[j] = i
        ds_out[j] = d
    return ids_out, ds_out, stats
