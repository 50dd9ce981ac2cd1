"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

The counterpart of ``repro.configs``: the five LM archs, the four GNN
archs, the dlrm-mlperf recsys model and the paper's own ANNS serving
config, in the reference's order.  Each module defines SPEC (an ArchSpec).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    shape_id: str
    step: str                 # train | prefill | serve | retrieval | anns_serve
    dims: Dict[str, int]
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str               # lm | gnn | recsys | anns
    model_cfg: Any
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""          # provenance [arXiv / hf]
    smoke_cfg: Optional[Any] = None   # reduced config for CPU smoke tests

    def shape(self, shape_id: str) -> ShapeSpec:
        for s in self.shapes:
            if s.shape_id == shape_id:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {shape_id!r}")


_MODULES = {
    "granite-8b": "granite_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "arctic-480b": "arctic_480b",
    "schnet": "schnet",
    "gat-cora": "gat_cora",
    "egnn": "egnn",
    "gin-tu": "gin_tu",
    "dlrm-mlperf": "dlrm_mlperf",
    "crouting-anns": "crouting_paper",
}

_CACHE: Dict[str, ArchSpec] = {}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _CACHE:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
        _CACHE[arch_id] = mod.SPEC
    return _CACHE[arch_id]


def list_archs(include_anns: bool = False):
    ids = [a for a in _MODULES if a != "crouting-anns"]
    return ids + (["crouting-anns"] if include_anns else [])
