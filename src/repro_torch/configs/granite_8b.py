"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

SPEC = ArchSpec(
    arch_id="granite-8b",
    family="lm",
    model_cfg=LMConfig(name="granite-8b", n_layers=36, d_model=4096,
                       n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152),
    shapes=LM_SHAPES,
    source="arXiv:2405.04324; hf",
    smoke_cfg=LMConfig(name="granite-8b-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
                       dtype="float32", block_q=16, block_k=32, loss_chunk=16),
)
