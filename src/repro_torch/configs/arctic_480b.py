"""arctic-480b [moe] — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, MoeSpec

SPEC = ArchSpec(
    arch_id="arctic-480b",
    family="lm",
    model_cfg=LMConfig(name="arctic-480b", n_layers=35, d_model=7168,
                       n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
                       moe=MoeSpec(n_experts=128, top_k=2, dense_residual=True)),
    shapes=LM_SHAPES,
    source="hf:Snowflake/snowflake-arctic-base; hf",
    smoke_cfg=LMConfig(name="arctic-smoke", n_layers=2, d_model=56,
                       n_heads=7, n_kv_heads=1, d_ff=64, vocab=512,
                       moe=MoeSpec(n_experts=8, top_k=2, dense_residual=True),
                       dtype="float32", block_q=16, block_k=32, loss_chunk=16),
)
