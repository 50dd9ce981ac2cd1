"""dlrm-mlperf [recsys] — MLPerf DLRM (Criteo 1TB) [arXiv:1906.00091]."""
from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.dlrm import DlrmConfig

SPEC = ArchSpec(
    arch_id="dlrm-mlperf",
    family="recsys",
    model_cfg=DlrmConfig(),
    shapes=RECSYS_SHAPES,
    source="arXiv:1906.00091; paper (MLPerf reference config)",
    smoke_cfg=DlrmConfig(name="dlrm-smoke", vocab_cap=1000),
)
