"""AdamW with a warmup-cosine schedule, over a parameter tree of tensors.

The counterpart of the JAX package's `optim/adamw.py`, op for op in f32:
the same schedule, the same moment updates and bias corrections, weight
decay on matrices only (leaves of two or more dimensions, the stacked
group leaves included, as there).  The JAX package returns new arrays;
the port updates the parameters and both moments in place, since a model
and its optimizer state on one card are most of its memory (olmo-1b in
f32: 18.8 GB for the parameters, the gradients and two moments).  The
moments keep the dtype they were made in (f32 by default, bf16 as the
low-memory option), and every update is computed in f32 and rounded
once into the parameter's and the moments' types, as there (bf16
parameters train in place the same way).  The step count
and the schedule are host values, so a step needs no device-to-host
copy.  There is no sharding: one card holds the whole state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import spec_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "apply_updates", "lr_schedule",
           "global_norm", "clip_by_global_norm", "tree_leaves"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in the order `jax.tree.leaves` gives
    them (sorted keys)."""
    return [leaf for _, leaf in spec_leaves(tree)]


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or a 0-dim tensor), a 0-dim f32
    host tensor: linear warmup, then cosine down to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(_F32).cpu()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * scale


def init_opt_state(params, dtype: torch.dtype = _F32) -> dict:
    """Zero moments of `dtype` beside each parameter, on its device, and
    the step count, a 0-dim int32 host tensor."""
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim, on the
    leaves' device)."""
    sums = [torch.square(x.to(_F32)).sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)); returns
    (grads, norm), norm a 0-dim f32 tensor on the card (no copy to the
    host).  An f32 gradient is scaled in place.  A gradient of another
    type (bf16) becomes a new f32 leaf, its f32 value times the f32
    scale, as `jnp`'s promotion gives it in the JAX package: the scale is
    never rounded to bf16 and neither is the product."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(node: dict) -> dict:
        for key, g in node.items():
            if isinstance(g, dict):
                clip(g)
            elif g.dtype == _F32:
                g.mul_(scale)
            else:
                node[key] = g.to(_F32).mul_(scale)
        return node

    return clip(grads), norm


def apply_updates(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step, in place.  Returns (params, state, lr): the same
    parameter and moment tensors, updated, ``state["step"]`` one more, and
    the step's learning rate (0-dim f32)."""
    step = state["step"] + 1
    step_f = step.to(_F32)
    lr = lr_schedule(cfg, step)
    b1c = float(1.0 - cfg.b1 ** step_f)
    b2c = float(1.0 - cfg.b2 ** step_f)
    lr_f = float(lr)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.to(_F32)
        m32 = cfg.b1 * m.to(_F32) + (1.0 - cfg.b1) * g
        v32 = cfg.b2 * v.to(_F32) + (1.0 - cfg.b2) * g * g
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (standard practice)
            delta = delta + cfg.weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr_f * delta)
        m.copy_(m32)
        v.copy_(v32)
        del g, m32, v32, delta
    state["step"] = step
    return params, state, lr
