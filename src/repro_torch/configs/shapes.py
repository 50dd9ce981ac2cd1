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
