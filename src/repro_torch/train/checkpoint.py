"""Fault-tolerant checkpoints, in the JAX package's layout.

Layout per step:
    <dir>/step_<N>/
        manifest.json        — key paths, shapes, dtypes, data cursor,
                               content hashes
        shard_0.npz          — flat arrays a0..a<n-1>
    <dir>/LATEST             — atomic pointer (write tmp + rename)

The counterpart of ``repro.train.checkpoint``.  Leaves are flattened in
JAX's order (sorted dict keys, then ``AdamWState``'s fields in order) and
the manifest's ``paths`` are JAX's key strings, so an fp32 checkpoint
written by either package restores in the other.  bf16 leaves are stored
as their 16-bit patterns (uint16, manifest dtype ``bfloat16``): the port
reads its own back bit for bit without ``ml_dtypes``.

Fault-tolerance contract (tests/test_torch_train.py):
  * atomic publish: a crash mid-write never corrupts LATEST;
  * resume restores params/opt state bit-exactly + the data-stream cursor;
  * restore places each leaf on the device of ``like``'s leaf, or on the
    devices given (elastic restore: checkpoints are device-agnostic);
  * content hashes detect partial/corrupt shard files.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_unflatten, treedef_str)


def _to_array(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_array(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    data_cursor: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """state: tree dict (e.g. {'params':…, 'opt':…}). Returns the step dir."""
    flat = tree_flatten_with_path(state)
    arrays = [_to_array(leaf) for _, leaf in flat]
    dtypes = [str(leaf.dtype).replace("torch.", "") for _, leaf in flat]
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    shard_path = os.path.join(tmp_dir, "shard_0.npz")
    np.savez(shard_path, **{f"a{i}": a for i, a in enumerate(arrays)})
    with open(shard_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()

    manifest = {
        "step": step,
        "paths": [path for path, _ in flat],
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "treedef": treedef_str(state),
        "n_leaves": len(arrays),
        "data_cursor": data_cursor or {},
        "extra": extra or {},
        "hashes": {"shard_0.npz": digest},
    }
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)                       # atomic publish
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    return int(name.split("_")[1])


def restore_checkpoint(ckpt_dir: str, like: Dict[str, Any],
                       step: Optional[int] = None,
                       shardings: Optional[Any] = None,
                       verify_hash: bool = True):
    """Restore into the structure of ``like`` (a tree of tensors).  Each
    leaf goes to the device of ``like``'s leaf, or, if ``shardings`` (a tree
    of devices shaped as ``like``) is given, to its device there — the
    elastic-restore path.  Returns (state, data cursor, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    shard_path = os.path.join(step_dir, "shard_0.npz")
    if verify_hash:
        with open(shard_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != manifest["hashes"]["shard_0.npz"]:
            raise IOError(f"checkpoint shard corrupt at step {step}")
    with np.load(shard_path) as z:
        arrays = [z[f"a{i}"] for i in range(manifest["n_leaves"])]
    leaves = tree_leaves(like)
    if len(leaves) != len(arrays):
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{len(arrays)} leaves vs {len(leaves)}")
    for l, a in zip(leaves, arrays):
        if tuple(l.shape) != a.shape:
            raise ValueError(f"shape mismatch {tuple(l.shape)} vs {a.shape}")
    devices = (tree_leaves(shardings) if shardings is not None
               else [l.device for l in leaves])
    tensors = [_from_array(a, dt).to(d) for a, dt, d in
               zip(arrays, manifest["dtypes"], devices)]
    return (tree_unflatten(like, tensors), manifest["data_cursor"],
            manifest["step"])


def gc_checkpoints(ckpt_dir: str, keep: int = 3):
    """Keep the newest `keep` step dirs (never the one LATEST points at)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
