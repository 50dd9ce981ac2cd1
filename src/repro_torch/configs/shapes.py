"""Shape sets of the port's families (copied from ``repro.configs.shapes``)."""
from __future__ import annotations

from repro_torch.configs import ShapeSpec

LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256),
              "training"),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32),
              "inference-prefill"),
    ShapeSpec("decode_32k", "serve", dict(seq_len=32768, global_batch=128),
              "inference-decode: 1 new token, KV cache of seq_len"),
    ShapeSpec("long_500k", "serve", dict(seq_len=524288, global_batch=1),
              "long-context decode; O(S) per token with sequence-sharded KV "
              "(full-attention archs: see DESIGN.md §5 long_500k note)"),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
              "full-batch (cora-like)"),
    ShapeSpec("minibatch_lg", "train",
              dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
                   fanout1=15, fanout2=10, d_feat=602, n_classes=41,
                   # sampled-subgraph static bounds: 1024*(1+15+150) nodes
                   sub_nodes=169_984, sub_edges=168_960),
              "sampled-training (reddit-like, real neighbor sampler)"),
    ShapeSpec("ogb_products", "train",
              dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                   n_classes=47),
              "full-batch-large"),
    ShapeSpec("molecule", "train",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
              "batched-small-graphs"),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65_536), "training"),
    ShapeSpec("serve_p99", "serve", dict(batch=512), "online-inference"),
    ShapeSpec("serve_bulk", "serve", dict(batch=262_144), "offline-scoring"),
    ShapeSpec("retrieval_cand", "retrieval",
              dict(batch=1, n_candidates=1_000_000),
              "retrieval-scoring: batched dot, never a loop; CRouting-ANN "
              "variant in examples/dlrm_retrieval_torch.py"),
)

ANNS_SHAPES = (
    ShapeSpec("serve_1b", "anns_serve",
              dict(n_total=1_000_000_000, dim=128, max_degree=32,
                   batch=1024, efs=128, k=10),
              "SIFT-1B-scale sharded CRouting serving (paper's own system)"),
    ShapeSpec("serve_100m_gist", "anns_serve",
              dict(n_total=100_000_000, dim=960, max_degree=32,
                   batch=256, efs=128, k=10),
              "GIST-dim high-d sharded serving"),
)
