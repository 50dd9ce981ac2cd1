"""The paper's own system config: sharded CRouting-HNSW serving (the five
Table-2 dataset stand-ins are ``repro_torch.data.vectors.paper_dataset``)."""
import dataclasses

from repro_torch.configs import ArchSpec
from repro_torch.configs.shapes import ANNS_SHAPES


@dataclasses.dataclass(frozen=True)
class AnnsConfig:
    name: str = "crouting-hnsw"
    graph: str = "hnsw"
    m: int = 32            # paper §5.1: HNSW M=32, efc=256
    efc: int = 256
    router: str = "crouting"
    percentile: float = 90.0   # paper §5.5: best at the 90th percentile
    vec_dtype: str = "float32"  # "bfloat16" = beyond-paper storage


SPEC = ArchSpec(
    arch_id="crouting-anns",
    family="anns",
    model_cfg=AnnsConfig(),
    shapes=ANNS_SHAPES,
    source="this paper (CRouting, CS.DB 2025)",
    smoke_cfg=AnnsConfig(name="crouting-smoke", m=8, efc=32),
)
