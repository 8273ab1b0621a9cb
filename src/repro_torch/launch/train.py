"""Training launcher of the port, on one card.

    python -m repro_torch.launch.train --arch olmo-1b --steps 100 \
        [--smoke] [--workdir DIR] [--microbatches N] \
        [--remat none|block|dots] [--device cuda]

The counterpart of the JAX package's `launch/train.py`.  One device, so
the model trains in f32, as that launcher does on one device.  `--smoke`
swaps in the reduced same-family config (CPU-sized); without it the full
config runs on the card (olmo-1b: 1.18e9 parameters, 18.8 GB for the f32
parameters, gradients and both moments, at the default batch of 8 x 256
tokens).  `--device` defaults to ``cuda`` and raises when CUDA is
absent; ``--device cpu`` runs the plain versions.  Checkpoints go under
`--workdir` (default ``build/repro_train`` below the current directory).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import REMAT
from repro_torch.training.trainer import Trainer

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--workdir", default="build/repro_train")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    # one device: f32, as the JAX package's launcher on one device
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    tc = TrainConfig(
        learning_rate=args.lr, warmup_steps=10, total_steps=args.steps,
        microbatches=args.microbatches, remat=args.remat,
        checkpoint_every=max(args.steps // 4, 10),
    )
    trainer = Trainer(cfg, tc, workdir=f"{args.workdir}/{cfg.name}",
                      batch=args.batch, seq_len=args.seq, device=args.device)
    t0 = time.perf_counter()
    result = trainer.run(args.steps)
    if result.losses:
        print(f"{cfg.name} on {trainer.device}: {len(result.losses)} steps "
              f"in {time.perf_counter() - t0:.1f} s, loss "
              f"{result.losses[0]:.3f} -> {result.losses[-1]:.3f}, "
              f"stragglers={result.straggler_events}")
    return result


if __name__ == "__main__":
    main()
