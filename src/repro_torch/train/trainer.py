"""Fault-tolerant training loop (DESIGN.md §6).

The counterpart of ``repro.train.trainer``:
  * gradient accumulation (microbatching) inside the step;
  * periodic checkpoints w/ deterministic data cursor;
  * crash/restart resume that is BIT-EXACT vs an uninterrupted run as
    long as the step itself is repeatable (see ``models.transformer``);
  * elastic restore onto other devices (``shardings`` at restore);
  * straggler/heartbeat hook: a step-deadline watchdog that records
    slow steps and (in multi-host deployments) triggers re-scheduling.

The step runs eagerly (the reference jits it and donates params and
optimizer state; here the old trees are dropped as the new ones come).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map, value_and_grad


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_ckpts: int = 3
    grad_accum: int = 1
    log_every: int = 10
    step_deadline_s: float = 0.0     # >0: watchdog flags stragglers
    # int8 all-reduce (train/compress.py); not read, as in the reference
    grad_compress: bool = False


def make_accum_train_step(loss_fn, ocfg: opt.AdamWConfig, n_accum: int):
    """Gradient-accumulation step: batch [A, b, ...] microbatches in turn;
    fp32 gradient sums, divided by ``n_accum``."""

    def train_step(params, opt_state, batch):
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        n_micro = next(iter(batch.values())).shape[0]
        losses = []
        for i in range(n_micro):
            loss, g = value_and_grad(loss_fn, params,
                                     {k: v[i] for k, v in batch.items()})
            g_sum = tree_map(torch.add, g_sum, g)
            losses.append(loss)
        grads = tree_map(lambda g: g / n_accum, g_sum)
        new_p, new_s, metrics = opt.adamw_update(grads, opt_state, params,
                                                 ocfg)
        metrics["loss"] = torch.stack(losses).mean()
        return new_p, new_s, metrics

    return train_step


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 params, opt_state, data_stream,
                 shardings: Optional[Any] = None):
        self.cfg = cfg
        self.step_fn = train_step
        self.params = params
        self.opt_state = opt_state
        self.stream = data_stream
        self.shardings = shardings
        self.device = tree_leaves(params)[0].device
        self.step = 0
        self.history: list = []
        self.straggler_events: list = []

    # ------------------------------------------------------------------
    def maybe_resume(self) -> bool:
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        state, cursor, step = ckpt.restore_checkpoint(
            self.cfg.ckpt_dir,
            {"params": self.params, "opt": self.opt_state},
            shardings=self.shardings)
        self.params, self.opt_state = state["params"], state["opt"]
        self.stream.restore(cursor)
        self.step = step
        return True

    def _checkpoint(self):
        ckpt.save_checkpoint(
            self.cfg.ckpt_dir, self.step,
            {"params": self.params, "opt": self.opt_state},
            data_cursor=self.stream.state())
        ckpt.gc_checkpoints(self.cfg.ckpt_dir, self.cfg.keep_ckpts)

    # ------------------------------------------------------------------
    def run(self, n_steps: Optional[int] = None,
            crash_at: Optional[int] = None) -> Dict:
        """crash_at: raise after that step (fault-injection for tests).
        ``final_loss`` is None when no step was left to run (a resume of a
        finished run; the reference raises IndexError there)."""
        target = self.step + (n_steps or self.cfg.total_steps - self.step)
        while self.step < target:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.stream.next().items()}
            t0 = time.time()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if self.cfg.step_deadline_s and dt > self.cfg.step_deadline_s:
                # straggler watchdog: in a multi-host deployment this is the
                # signal to preempt/reschedule the slow host
                self.straggler_events.append({"step": self.step, "secs": dt})
            self.step += 1
            self.history.append(loss)
            if self.step % self.cfg.log_every == 0:
                print(f"step {self.step}: loss={loss:.4f} ({dt:.2f}s)")
            if self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
            if crash_at is not None and self.step >= crash_at:
                raise RuntimeError(f"injected crash at step {self.step}")
        self._checkpoint()
        return {"final_loss": self.history[-1] if self.history else None,
                "history": self.history,
                "stragglers": self.straggler_events}
