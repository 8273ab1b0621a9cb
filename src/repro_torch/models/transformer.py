"""Block composition: (attention | Mamba | RWKV-6) residual blocks, each
with a dense MLP or an MoE FFN (RWKV-6: its channel mix), grouped into
homogeneous layer layouts.

The counterpart of the JAX package's `models/transformer.py`.  A model's
layers are a periodic *layout* of (block_type, is_moe) positions repeated
`num_groups` times, after `first_k_dense` leading dense layers
(DeepSeek's); each position's parameters are stacked over groups on a
leading "layers" axis, the JAX package's tree.  The port's model walks that
axis in a Python loop where the JAX package scans it.  The clustered KV
cache replaces the K/V cache exactly when ``cfg.cluster_kv and not
cfg.use_mla`` (with MLA the latent cache stays), as in the JAX package.
Mamba and RWKV-6 blocks carry recurrent states in the cache (Mamba's
``ssm`` and ``conv``, RWKV-6's ``wkv``, ``x_prev_time`` and
``x_prev_chan``); their decode writes them in place, as attention writes
its K/V, where the JAX package merges new dicts.  jamba's period of 8
mixes Mamba, attention (position 4), dense MLP and MoE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, mamba, rwkv6
from repro_torch.models import cluster_attn as CA
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_specs,
                                       norm_specs)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import ParamSpec

__all__ = ["layer_layout", "block_specs", "block_forward", "block_decode",
           "block_cache_spec", "stack_specs", "LayerLayout"]


@dataclasses.dataclass(frozen=True)
class LayerLayout:
    period: int
    num_groups: int
    first_k_dense: int
    positions: tuple              # tuple[(block_type, is_moe)] of len period

    @property
    def scanned_layers(self) -> int:
        return self.period * self.num_groups


def layer_layout(cfg: ModelConfig) -> LayerLayout:
    period = cfg.attn_period if cfg.attn_period > 1 else 1
    if cfg.num_experts and cfg.moe_period > 1:
        period = math.lcm(period, cfg.moe_period)
    scanned = cfg.num_layers - cfg.first_k_dense
    if scanned % period:
        raise ValueError(f"{cfg.name}: {scanned} layers do not fill periods "
                         f"of {period}")
    positions = tuple(
        (cfg.block_type(cfg.first_k_dense + p),
         cfg.layer_is_moe(cfg.first_k_dense + p))
        for p in range(period))
    for layer in range(cfg.first_k_dense, cfg.num_layers):
        p = (layer - cfg.first_k_dense) % period
        if (cfg.block_type(layer), cfg.layer_is_moe(layer)) != positions[p]:
            raise ValueError(f"{cfg.name}: layer {layer} breaks the layout "
                             f"{positions}")
    return LayerLayout(period=period, num_groups=scanned // period,
                       first_k_dense=cfg.first_k_dense, positions=positions)


def stack_specs(specs, n: int):
    """Prefix every ParamSpec with a ("layers",) group axis of size n."""
    return {key: stack_specs(node, n) if isinstance(node, dict) else
            ParamSpec((n,) + node.shape, ("layers",) + node.axes,
                      init=node.init, scale=node.scale)
            for key, node in specs.items()}


def _clustered(cfg: ModelConfig) -> bool:
    return cfg.cluster_kv and not cfg.use_mla


# ---------------------------------------------------------------------------
# One residual block.
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, block_type: str, is_moe: bool) -> dict:
    specs = {"norm1": norm_specs(cfg), "norm2": norm_specs(cfg)}
    if block_type == "attn":
        specs["attn"] = attention.attn_specs(cfg)
    elif block_type == "mamba":
        specs["mixer"] = mamba.mamba_specs(cfg)
    elif block_type == "rwkv6":
        specs["time_mix"] = rwkv6.rwkv_time_specs(cfg)
    else:
        raise ValueError(f"unknown block type {block_type!r}")
    if block_type == "rwkv6":
        specs["channel_mix"] = rwkv6.rwkv_channel_specs(cfg)
    elif is_moe:
        specs["moe"] = moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    return specs


def block_cache_spec(cfg: ModelConfig, block_type: str, batch: int,
                     max_seq: int, dtype: torch.dtype) -> dict:
    if block_type == "mamba":
        return mamba.mamba_state_spec(cfg, batch, dtype)
    if block_type == "rwkv6":
        return rwkv6.rwkv_state_spec(cfg, batch, dtype)
    if block_type != "attn":
        raise ValueError(f"unknown block type {block_type!r}")
    if _clustered(cfg):
        return CA.cluster_cache_specs(
            batch, cfg.num_kv_heads, cfg.head_dim, cfg.head_dim, max_seq,
            CA.ClusterKVConfig(num_clusters=cfg.cluster_kv_clusters,
                               topc=cfg.cluster_kv_topc),
            dtype)
    return attention.init_kv_cache_spec(cfg, batch, max_seq, dtype)


def _ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, block_type: str,
         is_moe: bool, cache=None):
    """The block's second half: (x + FFN(norm2(x)), aux loss).  RWKV-6's
    FFN is its channel mix; given the decode's `cache`, it reads and
    writes ``x_prev_chan`` there."""
    h = apply_norm(params["norm2"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if block_type == "rwkv6":
        if cache is None:
            y = rwkv6.rwkv_channel_forward(params["channel_mix"], h, cfg)
        else:
            y, _ = rwkv6.rwkv_channel_decode(params["channel_mix"], h, cache,
                                             cfg)
    elif is_moe:
        y, aux = apply_moe(params["moe"], h, cfg)
    else:
        y = apply_mlp(params["mlp"], h, cfg)
    return x + y, aux


def block_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  block_type: str, is_moe: bool, *,
                  positions: Optional[torch.Tensor] = None,
                  return_cache: bool = False):
    """Returns (x, cache_entries_or_None, aux_loss); aux is 0 without MoE.
    The cache entries are the attention's (K/V, or MLA's latents) also
    under `cluster_kv`: the clustered cache is built from them
    (`cluster_attn.build_clustered_cache`).  Mamba and RWKV-6 blocks give
    None: their forward runs from a zero state and threads no state out,
    as in the JAX package (their prompts are replayed, `Engine`)."""
    h = apply_norm(params["norm1"], x, cfg)
    cache = None
    if block_type == "attn":
        y, cache = attention.attn_forward(params["attn"], h, cfg,
                                          positions=positions,
                                          return_cache=return_cache)
    elif block_type == "mamba":
        y = mamba.mamba_forward(params["mixer"], h, cfg)
    else:
        y = rwkv6.rwkv_time_forward(params["time_mix"], h, cfg)
    x, aux = _ffn(params, x + y, cfg, block_type, is_moe)
    return x, cache, aux


def block_decode(params: dict, x: torch.Tensor, cache: dict,
                 index: torch.Tensor, cfg: ModelConfig, block_type: str,
                 is_moe: bool):
    """Single-token step.  Returns (x, cache), the cache updated in place:
    the attention's K/V at `index`, or the recurrent states."""
    h = apply_norm(params["norm1"], x, cfg)
    if block_type == "mamba":
        y, cache = mamba.mamba_decode(params["mixer"], h, cache, cfg)
    elif block_type == "rwkv6":
        y, cache = rwkv6.rwkv_time_decode(params["time_mix"], h, cache, cfg)
    elif _clustered(cfg):
        y, cache = attention.attn_decode_clustered(params["attn"], h, cache,
                                                   index, cfg)
    else:
        y, cache = attention.attn_decode(params["attn"], h, cache, index, cfg)
    x, _ = _ffn(params, x + y, cfg, block_type, is_moe, cache)
    return x, cache
