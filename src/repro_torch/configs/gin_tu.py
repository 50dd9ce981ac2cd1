"""gin-tu [gnn] — 5L, d=64, sum aggregator, learnable eps [arXiv:1810.00826]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GnnConfig

SPEC = ArchSpec(
    arch_id="gin-tu",
    family="gnn",
    model_cfg=GnnConfig(name="gin-tu", arch="gin", n_layers=5, d_hidden=64,
                        task="node_class"),
    shapes=GNN_SHAPES,
    source="arXiv:1810.00826; paper",
    smoke_cfg=GnnConfig(name="gin-smoke", arch="gin", n_layers=2, d_hidden=16,
                        n_classes=4, task="node_class"),
)
