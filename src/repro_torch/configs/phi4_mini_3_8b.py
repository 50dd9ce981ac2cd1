"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

SPEC = ArchSpec(
    arch_id="phi4-mini-3.8b",
    family="lm",
    model_cfg=LMConfig(name="phi4-mini-3.8b", n_layers=32, d_model=3072,
                       n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064),
    shapes=LM_SHAPES,
    source="arXiv:2412.08905; hf",
    smoke_cfg=LMConfig(name="phi4-smoke", n_layers=2, d_model=48,
                       n_heads=3, n_kv_heads=1, d_ff=128, vocab=512,
                       dtype="float32", block_q=16, block_k=32, loss_chunk=16),
)
