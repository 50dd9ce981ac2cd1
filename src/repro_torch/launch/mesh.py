"""Shard slots over the local cards (the counterpart of
``repro.launch.mesh.make_local_mesh``).

A FUNCTION, not a module-level constant: importing this module touches no
device state.  Where the JAX package builds a device mesh for one
``shard_map`` step, the port's sharded index runs a per-shard loop, so its
"mesh" is a list of slots, one a shard, each naming the device that shard's
tensors live on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """``n`` shard slots along one named axis."""

    axis_name: str
    devices: Tuple[torch.device, ...]


def make_local_mesh(n: int = 1, name: str = "data",
                    device: DeviceLike = None) -> LocalMesh:
    """``n`` slots over the visible cards, round robin (one H100 holds them
    all), or ``n`` slots on ``device`` where it names one (``"cpu"``,
    ``"cuda:1"``).  ``device=None`` means
    the GPU and raises without one."""
    if n < 1:
        raise ValueError("a mesh needs at least one slot")
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return LocalMesh(name, (dev,) * n)
    n_cards = torch.cuda.device_count()
    return LocalMesh(name, tuple(torch.device("cuda", s % n_cards)
                                 for s in range(n)))
