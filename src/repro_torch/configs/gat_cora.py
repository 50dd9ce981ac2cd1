"""gat-cora [gnn] — 2L, d_hidden=8, 8 heads, attn aggregator [arXiv:1710.10903]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GnnConfig

SPEC = ArchSpec(
    arch_id="gat-cora",
    family="gnn",
    model_cfg=GnnConfig(name="gat-cora", arch="gat", n_layers=2, d_hidden=8,
                        n_heads=8, task="node_class"),
    shapes=GNN_SHAPES,
    source="arXiv:1710.10903; paper",
    smoke_cfg=GnnConfig(name="gat-smoke", arch="gat", n_layers=2, d_hidden=4,
                        n_heads=2, n_classes=4, task="node_class"),
)
