"""Batched serving engine (static batching) and prefill replay.

The counterpart of the JAX package's `serving/engine.py`.  The engine
drives `prefill` + `decode_step` for aligned prompt batches: greedy or
temperature sampling, stop on max tokens.  `replay_prefill` builds the
decode cache by replaying the prompt through `decode_step` token by token;
`generate` takes it where the fused prefill does not apply, by the JAX
package's rule (a stack of attention blocks only, no leading dense layers):
rwkv6-3b and jamba-1.5-large-398b (their Mamba and RWKV-6 states come out
of the decode steps only) and deepseek-v2-lite-16b replay their prompts,
one decode step a token; qwen2-moe-a2.7b and the dense models take the
fused prefill.  `generate` takes token prompts; paligemma-3b's image
prefix goes through `prefill` with ``{"patches", "tokens"}`` and then
`decode_step`, and hubert-xlarge, an encoder, has no decode.

Tokens stay on the device until `generate` returns, so a decode step waits
for the host nowhere.  At temperature > 0 the draws come from a
`torch.Generator` seeded from `ServeConfig.seed` on every `generate`: the
softmax law of the JAX package's sampler, not its draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models.model import decode_step, empty_cache
from repro_torch.models.transformer import layer_layout
from repro_torch.serving.prefill import prefill

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy
    max_seq: int = 512
    seed: int = 0


class Engine:
    """Minimal batched engine over a fixed model and its parameters.

    `device` is where the parameters lie and the model runs: ``"cuda"``
    (the default) raises when CUDA is absent, ``"cpu"`` runs the kernels'
    plain versions.
    """

    def __init__(self, params: dict, cfg: ModelConfig, serve: ServeConfig,
                 *, device="cuda"):
        self.device = resolve_device(device)
        where = params["embed"]["tokens"].device
        if where.type != self.device.type:
            raise ValueError(f"the parameters lie on {where}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.serve = serve

    def replay_prefill(self, tokens: torch.Tensor):
        """Prompt (B, S) -> (last logits, decode cache) by sequential
        replay (any arch the model runs)."""
        b, s = tokens.shape
        cache = empty_cache(self.cfg, b, self.serve.max_seq, self.device)
        logits = None
        for t in range(s):
            logits, cache = decode_step(self.params, self.cfg, tokens[:, t],
                                        cache)
        return logits, cache

    def generate(self, prompts) -> np.ndarray:
        """prompts: (B, S) int (aligned).  Returns (B, max_new_tokens)
        int32."""
        cfg, serve = self.cfg, self.serve
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        if tokens.shape[1] + serve.max_new_tokens > serve.max_seq:
            raise ValueError(
                f"a {tokens.shape[1]}-token prompt and {serve.max_new_tokens}"
                f" new tokens do not fit a cache of max_seq={serve.max_seq}")
        use_fused = all(bt == "attn" for bt, _ in layer_layout(cfg).positions)
        if use_fused and not cfg.first_k_dense:
            logits, cache = prefill(self.params, cfg, {"tokens": tokens},
                                    max_seq=serve.max_seq)
        else:
            logits, cache = self.replay_prefill(tokens)
        gen = torch.Generator(device=self.device).manual_seed(serve.seed)
        cur = self._sample(logits, gen)
        out = []
        for _ in range(serve.max_new_tokens):
            out.append(cur)
            logits, cache = decode_step(self.params, cfg, cur, cache)
            cur = self._sample(logits, gen)
        if not out:
            return np.zeros((tokens.shape[0], 0), np.int32)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        if self.serve.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32)
                              / self.serve.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
