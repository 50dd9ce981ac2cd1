"""Deterministic synthetic batches for every family (smoke tests, examples,
and the end-to-end train driver).  All generators are pure functions of seed.

A copy of ``repro.data.synthetic`` (NumPy only): its batches equal the
reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


# --------------------------------------------------------------------------
# LM token stream
# --------------------------------------------------------------------------
def lm_batch(vocab: int, batch: int, seq: int, seed: int = 0) -> Dict:
    """Markov-ish synthetic tokens (structured enough that loss decreases)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    # inject learnable bigram structure: half the positions repeat prev+1
    rep = rng.random((batch, seq)) < 0.5
    nxt = (base[:, :-1] + 1) % vocab
    base[:, 1:][rep] = nxt[rep]
    return {"tokens": base[:, :-1], "labels": base[:, 1:]}


class LMStream:
    """Deterministic, checkpointable token stream (cursor = step index)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.step = 0

    def next(self) -> Dict:
        b = lm_batch(self.vocab, self.batch, self.seq,
                     seed=self.seed * 1_000_003 + self.step)
        self.step += 1
        return b

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])
        self.seed = int(state["seed"])


# --------------------------------------------------------------------------
# graphs
# --------------------------------------------------------------------------
def random_graph_batch(n_nodes: int, n_edges: int, d_feat: int,
                       n_classes: int, n_graphs: int = 1, seed: int = 0,
                       task: str = "node_class") -> Dict:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    graph_ids = np.sort(rng.integers(0, n_graphs, size=n_nodes)).astype(np.int32) \
        if n_graphs > 1 else np.zeros(n_nodes, np.int32)
    batch = {
        "node_feat": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "pos": rng.normal(size=(n_nodes, 3)).astype(np.float32) * 3.0,
        "atom_z": rng.integers(1, 20, size=n_nodes).astype(np.int32),
        "edge_src": src, "edge_dst": dst,
        "node_mask": np.ones(n_nodes, np.float32),
        "edge_mask": np.ones(n_edges, np.float32),
        "labels": rng.integers(0, n_classes, size=n_nodes).astype(np.int32),
        "label_mask": np.ones(n_nodes, np.float32),
        "graph_ids": graph_ids,
    }
    if task == "graph_class":
        batch["g_labels"] = rng.integers(0, n_classes, size=n_graphs).astype(np.int32)
    else:
        batch["g_labels"] = rng.normal(size=n_graphs).astype(np.float32)
    return batch


def neighbor_sample(adj_src: np.ndarray, adj_dst: np.ndarray, n_nodes: int,
                    seeds: np.ndarray, fanouts, seed: int = 0) -> Dict:
    """Real k-hop uniform neighbor sampler (GraphSAGE-style) over a CSR-ified
    edge list.  Returns the sampled subgraph with node renumbering."""
    rng = np.random.default_rng(seed)
    order = np.argsort(adj_dst, kind="stable")
    sorted_src = adj_src[order]
    starts = np.searchsorted(adj_dst[order], np.arange(n_nodes + 1))
    node_set = list(seeds)
    node_pos = {int(s): i for i, s in enumerate(seeds)}
    sub_src, sub_dst = [], []
    frontier = list(seeds)
    for fan in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = starts[u], starts[u + 1]
            if hi <= lo:
                continue
            cand = sorted_src[lo:hi]
            take = cand if len(cand) <= fan else rng.choice(cand, fan, replace=False)
            for v in take:
                v = int(v)
                if v not in node_pos:
                    node_pos[v] = len(node_set)
                    node_set.append(v)
                    nxt.append(v)
                sub_src.append(node_pos[v])
                sub_dst.append(node_pos[u])
        frontier = nxt
    return {
        "nodes": np.asarray(node_set, np.int64),
        "edge_src": np.asarray(sub_src, np.int32),
        "edge_dst": np.asarray(sub_dst, np.int32),
    }


# --------------------------------------------------------------------------
# recsys (Criteo-like)
# --------------------------------------------------------------------------
def dlrm_batch(n_dense: int, vocab_sizes, batch: int, seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    sparse = np.stack(
        [rng.integers(0, v, size=batch) for v in vocab_sizes], axis=1
    ).astype(np.int32)
    dense = rng.lognormal(size=(batch, n_dense)).astype(np.float32)
    # learnable structure: label correlates with one dense feature
    logit = (dense[:, 0] - np.median(dense[:, 0])) + 0.1 * rng.normal(size=batch)
    return {"dense": dense, "sparse_ids": sparse,
            "labels": (logit > 0).astype(np.float32)}
