"""granite-moe-1b-a400m [moe] — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, MoeSpec

SPEC = ArchSpec(
    arch_id="granite-moe-1b-a400m",
    family="lm",
    model_cfg=LMConfig(name="granite-moe-1b-a400m", n_layers=24, d_model=1024,
                       n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
                       moe=MoeSpec(n_experts=32, top_k=8)),
    shapes=LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    smoke_cfg=LMConfig(name="granite-moe-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
                       moe=MoeSpec(n_experts=4, top_k=2),
                       dtype="float32", block_q=16, block_k=32, loss_chunk=16),
)
