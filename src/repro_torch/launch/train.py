"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of ``repro.launch.train``, on the GPU unless ``--device
cpu``.  Runs the arch's REDUCED config (``smoke_cfg``) end-to-end on one
device; ``--full`` uses the assigned config.  Checkpoints every
``--ckpt-every`` steps and at the end; ``--resume`` continues from the
newest one in ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import LMStream
from repro_torch.device import resolve_device
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("launch.train drives LM archs; see examples/ for "
                         "others")
    cfg = spec.model_cfg if args.full else spec.smoke_cfg
    dev = resolve_device(args.device)

    from repro_torch.models import transformer as T
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    state = opt.adamw_init(params, ocfg)
    stream = LMStream(cfg.vocab, args.batch, args.seq, seed=0)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10),
        T.make_train_step(cfg, ocfg), params, state, stream)
    if args.resume and trainer.maybe_resume():
        print(f"resumed from step {trainer.step}")
    out = trainer.run()
    if out["final_loss"] is None:
        print(f"done: at step {trainer.step}, no step left to run")
    else:
        print(f"done: final loss {out['final_loss']:.4f} "
              f"(start {out['history'][0]:.4f})")


if __name__ == "__main__":
    main()
