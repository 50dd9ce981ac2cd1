"""egnn [gnn] — 4L, d=64, E(n)-equivariant [arXiv:2102.09844]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GnnConfig

SPEC = ArchSpec(
    arch_id="egnn",
    family="gnn",
    model_cfg=GnnConfig(name="egnn", arch="egnn", n_layers=4, d_hidden=64,
                        task="graph_reg"),
    shapes=GNN_SHAPES,
    source="arXiv:2102.09844; paper",
    smoke_cfg=GnnConfig(name="egnn-smoke", arch="egnn", n_layers=2,
                        d_hidden=16, task="graph_reg"),
)
