"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

SPEC = ArchSpec(
    arch_id="qwen1.5-4b",
    family="lm",
    model_cfg=LMConfig(name="qwen1.5-4b", n_layers=40, d_model=2560,
                       n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936,
                       qkv_bias=True),
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    smoke_cfg=LMConfig(name="qwen-smoke", n_layers=2, d_model=40,
                       n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
                       qkv_bias=True, head_dim=10,
                       dtype="float32", block_q=16, block_k=32, loss_chunk=16),
)
