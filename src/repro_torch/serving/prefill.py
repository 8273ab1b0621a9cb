"""Prefill: encode a prompt batch, producing next-token logits + KV cache."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.model import forward

__all__ = ["prefill"]


def _pad_seq(entry: dict, seq_axis: int, pad: int) -> dict:
    """Every leaf of one attention cache entry padded with zeros to `pad`
    more rows along `seq_axis`."""
    def p(t: torch.Tensor) -> torch.Tensor:
        widths = [0, 0] * t.dim()
        widths[2 * (t.dim() - 1 - seq_axis) + 1] = pad  # last axis first
        return F.pad(t, widths)

    return {leaf: p(t) for leaf, t in entry.items()}


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            max_seq: int = 0):
    """Returns (last_logits (B, V), cache) ready for `decode_step`.

    `batch` is the model's input batch: ``{"tokens"}``, or the vlm's
    ``{"patches", "tokens"}``, whose cache and ``index`` cover the patches
    and the text.  The forward runs the flash kernel once per layer.
    Every attention cache leaf, K/V (num_groups, B, S, Hk, hd) or MLA's
    latents (num_groups, B, S, R), is padded with zeros to `max_seq` along
    its sequence axis: axis 2 of the grouped leaves, axis 1 of the
    ``dense{l}`` layers'.  ``index`` is the prompt length, as in the JAX
    package's `prefill`.  Stacks with Mamba or RWKV-6 blocks raise, as in
    the JAX package: their forward threads no recurrent state out, and
    `Engine.replay_prefill` builds their cache.
    """
    layout = transformer.layer_layout(cfg)
    if any(bt != "attn" for bt, _ in layout.positions):
        raise NotImplementedError(
            "prefill() supports attention-only stacks; use "
            "Engine.replay_prefill for hybrid and SSM archs")
    logits, _, caches = forward(params, cfg, batch, return_cache=True)
    seq_len = logits.shape[1]
    pad = max(max_seq, seq_len) - seq_len
    cache = {"groups": {key: _pad_seq(entry, 2, pad)
                        for key, entry in caches["groups"].items()}}
    for l in range(cfg.first_k_dense):
        cache[f"dense{l}"] = _pad_seq(caches[f"dense{l}"], 1, pad)
    cache["index"] = torch.tensor(seq_len, dtype=torch.int64,
                                  device=logits.device)
    return logits[:, -1, :].clone(), cache
