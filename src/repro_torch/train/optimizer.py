"""AdamW + schedules over parameter trees of tensors.

The counterpart of ``repro.train.optimizer``.  State is a tree mirroring
params; the update math is fp32, moments are stored in ``state_dtype``
(``bfloat16`` halves optimizer memory for the largest models), gradients
come in the parameter dtype, and the bias corrections come from the step
counter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" for memory-tight models
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio (fp32 tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree):
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(l.float().square().sum() for l in leaves))


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                          device=p.device), params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 donate: bool = False):
    """Returns (new_params, new_state, metrics).  With ``donate`` the new
    parameters and moments are written into ``params`` and ``state``'s
    tensors, leaf by leaf, and returned in them (bit for bit the values
    the functional form returns): the counterpart of a jitted step that
    donates its parameters and state, so a step holds each once."""
    dt = getattr(torch, cfg.state_dtype)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                         max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        d = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        newp = p32 - lr * (d + cfg.weight_decay * p32)
        return newp.to(p.dtype), m32.to(dt), v32.to(dt)

    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state.mu), tree_leaves(state.nu))
    if donate:
        for p, g, m, v in leaves:
            for old, new in zip((p, m, v), upd(p, g, m, v)):
                old.copy_(new)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
            "grad_norm": gnorm, "lr": lr}
    out = [upd(p, g, m, v) for p, g, m, v in leaves]
    newp = tree_unflatten(params, [o[0] for o in out])
    newm = tree_unflatten(params, [o[1] for o in out])
    newv = tree_unflatten(params, [o[2] for o in out])
    return newp, AdamWState(step=step, mu=newm, nu=newv), {
        "grad_norm": gnorm, "lr": lr}
