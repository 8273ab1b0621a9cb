"""Serving launcher: batched generation with a registered arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The counterpart of `repro.launch.serve`, with the same flags and defaults
plus `--device` (default ``cuda``; it raises when CUDA is absent).  The
config is cut to the smoke size only under `--smoke`.  One H100 (80 GB)
holds at full width and depth, in bf16: yi-9b (17.7 GB), rwkv6-3b (6.2
GB; its `generate` replays the prompt through the RWKV-6 decode),
deepseek-v2-lite-16b (31.3 GB; MLA and MoE, it replays the prompt too),
qwen2-moe-a2.7b (30.3 GB), olmo-1b and qwen3-32b.  A config whose weights
(`spec_bytes` of its specs) exceed the card's memory stops with both
numbers: jamba-1.5-large-398b (about 796 GB) and qwen1.5-110b run here
under `--smoke` only.  hubert-xlarge is an encoder (no decode), and
paligemma-3b's `generate` would need its image patches (`prefill` takes
them, then `decode_step`), so both stop with the reason.  Weights are
random, drawn on the device from seed 0 in the config's `param_dtype`
(bf16 for the full configs, f32 for the smoke ones).  A one-token
`generate` warms up first, then the timed `generate` runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.core.plan import resolve_device
from repro_torch.models import init_params, param_specs, spec_bytes
from repro_torch.models.model import dtype_of
from repro_torch.serving.engine import Engine, ServeConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        print("NOTE: running the reduced smoke config (--smoke)")
        cfg = reduce_for_smoke(cfg)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    if cfg.family == "vlm":
        raise SystemExit(f"{cfg.name}: generate takes token prompts; the "
                         "image prefix goes through prefill with "
                         "{'patches', 'tokens'}, then decode_step")
    specs = param_specs(cfg)
    if device.type == "cuda":
        need = spec_bytes(specs,
                          torch.finfo(dtype_of(cfg.param_dtype)).bits // 8)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: its weights take {need} bytes in "
                f"{cfg.param_dtype}, the card holds {have}; run it with "
                "--smoke")

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(specs, gen, dtype_of(cfg.param_dtype), device)
    eng = Engine(params, cfg, ServeConfig(
        max_new_tokens=args.tokens,
        temperature=args.temperature,
        max_seq=args.prompt_len + args.tokens + 8,
    ), device=device)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    # Warm-up: a 1-token generate builds the kernels and warms the
    # allocator, so the timed region below is steady state.  `generate`
    # returns host arrays, so each call ends with the device's work.
    tc = time.time()
    eng.serve = dataclasses.replace(eng.serve, max_new_tokens=1)
    eng.generate(prompts)
    eng.serve = dataclasses.replace(eng.serve, max_new_tokens=args.tokens)
    warm_s = time.time() - tc
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    total = args.batch * args.tokens
    print(f"{cfg.name} on {device}: warm-up {warm_s:.1f}s; generated "
          f"{total} tokens in {dt:.1f}s ({total / dt:.1f} tok/s, "
          "warm incl. prefill)")
    print("first sequence:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
