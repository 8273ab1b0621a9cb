"""End-to-end training driver: a small LM for a few hundred steps on the
deterministic synthetic corpus, with checkpoint/restart fault tolerance.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 200] \
        [--preset tiny] [--device cuda|cpu]

The port's copy of `examples/train_lm.py`, with its presets, options and
output lines, on the port's `Trainer`.  `--preset 100m` is the
~100M-parameter configuration (32 x 1,024 tokens a step), for the card
only; the default `tiny` preset (about 6M parameters, f32, head width 64)
runs on the CPU too, and on the card its attention is the hand-written
flash kernel forward and backward.  Kill the process and re-run with the
same --workdir (default ``build/train_lm`` in the checkout): it resumes
from the newest checkpoint.  `--device` defaults to ``cuda`` and raises
without CUDA; ``--device cpu`` runs the kernels' plain versions.
`main(argv)` returns the printed numbers.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

WORKDIR = Path(__file__).resolve().parents[1] / "build" / "train_lm"


def make_preset(name: str):
    from repro_torch.configs.base import ModelConfig

    if name == "tiny":  # ~6M params — CPU-friendly
        return ModelConfig(
            name="tiny-lm", family="dense", num_layers=4, d_model=256,
            num_heads=4, num_kv_heads=4, d_ff=1024, vocab_size=8192,
            dtype="float32", param_dtype="float32", tie_embeddings=True,
        ), 8, 256
    if name == "100m":
        return ModelConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32768,
            dtype="float32", param_dtype="float32", tie_embeddings=True,
        ), 32, 1024
    raise SystemExit(f"unknown preset {name}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--workdir", default=str(WORKDIR))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without CUDA) or "
                         "'cpu' (the kernels' plain versions; tiny only)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.plan import resolve_device
    from repro_torch.training.trainer import Trainer

    if resolve_device(args.device).type != "cuda" and args.preset == "100m":
        raise SystemExit("--preset 100m is sized for the card; run it with "
                         "--device cuda")
    cfg, batch, seq = make_preset(args.preset)
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), "
          f"batch={batch} seq={seq}, workdir={args.workdir}")
    tc = TrainConfig(
        learning_rate=args.lr, warmup_steps=20, total_steps=args.steps,
        microbatches=1, remat="none", checkpoint_every=50,
    )
    trainer = Trainer(cfg, tc, workdir=args.workdir, batch=batch, seq_len=seq,
                      device=args.device)
    t0 = time.time()
    result = trainer.run(args.steps)
    dt = time.time() - t0
    if result.resumed_from:
        print(f"resumed from checkpoint at step {result.resumed_from}")
    ran = len(result.losses)
    out = {"params": n_params, "resumed_from": result.resumed_from,
           "ran": ran, "losses": list(result.losses), "seconds": dt}
    if ran:
        print(f"ran {ran} steps in {dt:.0f}s ({dt/max(ran,1):.2f}s/step)")
        print(f"loss: first={result.losses[0]:.3f} "
              f"last={result.losses[-1]:.3f} "
              f"min={min(result.losses):.3f}")
        toks = ran * batch * seq
        print(f"tokens seen this run: {toks:,}")
        out["tokens"] = toks
    else:
        print("nothing to do (already trained to --steps)")
    return out


if __name__ == "__main__":
    main()
