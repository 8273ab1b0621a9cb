"""Prefill: encode a prompt batch, producing next-token logits + KV cache."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.model import forward

__all__ = ["prefill"]


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            max_seq: int = 0):
    """Returns (last_logits (B, V), cache) ready for `decode_step`.

    The forward runs the flash kernel once per layer.  Cache tensors
    (num_groups, B, S, Hk, hd) are padded with zeros to `max_seq` along
    their sequence axis, and ``index`` is the prompt length, as in the JAX
    package's `prefill`.
    """
    layout = transformer.layer_layout(cfg)
    if any(bt != "attn" for bt, _ in layout.positions):
        raise NotImplementedError(
            "prefill() supports attention-only stacks; hybrid and SSM "
            "stacks are not ported yet: ROADMAP Queue 1 item 11")
    logits, _, caches = forward(params, cfg, batch, return_cache=True)
    seq_len = logits.shape[1]
    pad = max(max_seq, seq_len) - seq_len
    groups = {
        key: {leaf: F.pad(t, (0, 0, 0, 0, 0, pad))
              for leaf, t in entry.items()}
        for key, entry in caches["groups"].items()}
    index = torch.tensor(seq_len, dtype=torch.int64, device=logits.device)
    return logits[:, -1, :].clone(), {"groups": groups, "index": index}
