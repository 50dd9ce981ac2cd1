"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA device with no GPU present
raises instead of carrying on quietly on the CPU.  Resolving a CUDA device
also turns TF32 off for matmuls and cuDNN: the K-NN graph's stored edge
distances and the ground truth come from fp32 matrix products, and TF32
would move them (and with them the prune decisions).  ``"meta"`` is
accepted too: the dry run (``launch/dryrun.py``) builds its cells there,
with shapes and no data.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for CUDA without a GPU;
    ``cpu`` and ``meta`` as they are."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         "'meta'")
    return dev
