"""Train a ~100M-parameter LM for a few hundred steps on synthetic data with
checkpoint/restart: the PyTorch port's counterpart of examples/train_lm.py.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --resume   # restart
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The config is a scaled-down granite (same family as the assigned arch),
the reference example's: 16L x d=576 x ff=2304 x vocab=16384.  On the GPU
unless ``--device cpu``.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.data.synthetic import LMStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG_100M = T.LMConfig(name="granite-100m", n_layers=16, d_model=576,
                      n_heads=9, n_kv_heads=3, d_ff=2304, vocab=16384,
                      dtype="float32", block_q=64, block_k=128, loss_chunk=64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_100m"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = CFG_100M
    dev = resolve_device(args.device)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params on {dev}")
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    state = opt.adamw_init(params, ocfg)
    stream = LMStream(cfg.vocab, args.batch, args.seq, seed=0)

    tr = Trainer(TrainerConfig(total_steps=args.steps, ckpt_every=100,
                               ckpt_dir=args.ckpt_dir, log_every=10,
                               step_deadline_s=60.0),
                 T.make_train_step(cfg, ocfg), params, state, stream)
    if args.resume and tr.maybe_resume():
        print(f"resumed at step {tr.step}")
    out = tr.run()
    if out["final_loss"] is None:
        print(f"at step {tr.step}: no step left to run")
        return
    print(f"loss {out['history'][0]:.3f} -> {out['final_loss']:.3f} "
          f"({len(out['stragglers'])} straggler events)")


if __name__ == "__main__":
    main()
