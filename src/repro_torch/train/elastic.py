"""Elastic scaling: resume the same logical job on a different device count.

The counterpart of ``repro.train.elastic``.  Checkpoints are
device-agnostic (full logical arrays per leaf); on restore, leaves are
placed on the devices given for the *new* layout, so a job checkpointed on
N cards restarts on fewer (or on the CPU) without conversion.

remesh_plan() also covers the *data* dimension: global batch stays fixed, so
per-device batch and grad-accumulation factor are re-derived from the new
device count — keeping the optimization trajectory identical (same tokens
per step), which is what makes elastic restarts loss-transparent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.tree import tree_map


@dataclasses.dataclass
class RemeshPlan:
    old_devices: int
    new_devices: int
    global_batch: int
    data_parallel: int       # batch-sharding width (<= new_devices)
    per_device_batch: int
    grad_accum: int

    @property
    def tokens_per_step_preserved(self) -> bool:
        return self.per_device_batch * self.data_parallel * self.grad_accum \
            == self.global_batch


def remesh_plan(global_batch: int, new_devices: int,
                old_devices: Optional[int] = None,
                max_per_device_batch: int = 64) -> RemeshPlan:
    """Re-derive (DP width, per-device batch, grad-accum) for a new device
    count, holding the global batch constant.  When devices > batch, the
    surplus axis becomes model parallelism (DP width caps at the batch)."""
    dp = new_devices
    while dp > 1 and (global_batch % dp or global_batch < dp):
        dp -= 1
    per_dev = global_batch // dp
    accum = 1
    while per_dev > max_per_device_batch and per_dev % 2 == 0:
        per_dev //= 2
        accum *= 2
    return RemeshPlan(old_devices=old_devices or new_devices,
                      new_devices=new_devices, global_batch=global_batch,
                      data_parallel=dp, per_device_batch=per_dev,
                      grad_accum=accum)


def reshard_tree(tree: Any, devices: Any) -> Any:
    """Place each leaf of ``tree`` on its device in ``devices`` (a tree of
    the same structure)."""
    return tree_map(lambda x, d: x.to(d), tree, devices)
