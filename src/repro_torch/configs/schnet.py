"""schnet [gnn] — 3 interactions, d=64, 300 RBF, cutoff 10 [arXiv:1706.08566]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GnnConfig

SPEC = ArchSpec(
    arch_id="schnet",
    family="gnn",
    model_cfg=GnnConfig(name="schnet", arch="schnet", n_layers=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0, task="graph_reg"),
    shapes=GNN_SHAPES,
    source="arXiv:1706.08566; paper",
    smoke_cfg=GnnConfig(name="schnet-smoke", arch="schnet", n_layers=2,
                        d_hidden=16, n_rbf=8, cutoff=5.0, task="graph_reg"),
)
