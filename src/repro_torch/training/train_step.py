"""The training step: microbatched grads -> clip -> AdamW.

The counterpart of the JAX package's `training/train_step.py`.  Gradient
accumulation is a Python loop over microbatches (the leading batch dim
split into (microbatches, micro_bs, ...)) that adds each microbatch's
gradients into f32 accumulators, as the JAX package's `lax.scan` does, so
activation memory is bounded by one microbatch.  The remat policy selects
what the backward recomputes (`models.model.loss_fn`: "none", "block"
or "dots").  Parameters may be f32 or bf16 (`cfg.param_dtype`): the
accumulator stays f32 either way, and a bf16 gradient of one microbatch
is clipped into f32 (`optim.adamw.clip_by_global_norm`).  On the card the
attention's backward is the hand-written kernel of
`csrc/flash_attention_bwd.cu` (`kernels.ops.attention_bshd`).  The JAX
package's `grad_shardings` pins the accumulator to a layout; the port
gives such a layout as DTensor placements
(`distributed.sharding.sharding_for`), and on one card every placement is
`Replicate`, so a step there has nothing to pin and takes no such
argument.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.model import loss_fn
from repro_torch.models.params import TensorSpec, tree_map, tree_unflatten
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     clip_by_global_norm, tree_leaves)

__all__ = ["make_train_step", "make_grads_fn", "make_adamw_config",
           "train_state_specs"]


def make_adamw_config(tc: TrainConfig) -> AdamWConfig:
    return AdamWConfig(
        learning_rate=tc.learning_rate,
        warmup_steps=tc.warmup_steps,
        total_steps=tc.total_steps,
        weight_decay=tc.weight_decay,
    )


def _split_micro(batch: dict, n: int) -> list:
    """The batch as `n` microbatches along its leading dim."""
    for x in batch.values():
        assert x.shape[0] % n == 0, (x.shape[0], n)
    return [{key: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
             for key, x in batch.items()} for i in range(n)]


def make_grads_fn(cfg: ModelConfig, tc: TrainConfig):
    """Returns grads(params, batch) -> (loss, metrics, grads): a step's
    loss and its gradients before clipping, `grads` a list in
    `tree_leaves` order (f32 accumulators with microbatches, each
    parameter's type without).  The parameters are left as they are."""

    def grads_one_micro(params, leaves, micro):
        loss, metrics = loss_fn(params, cfg, micro, z_loss=tc.z_loss,
                                remat=tc.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def grads_fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {key: torch.as_tensor(x, device=leaves[0].device)
                 for key, x in batch.items()}
        if tc.microbatches == 1:
            return grads_one_micro(params, leaves, batch)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for micro in _split_micro(batch, tc.microbatches):
            loss, _, grads = grads_one_micro(params, leaves, micro)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / tc.microbatches
        return loss_sum * inv, {}, [a.mul_(inv) for a in acc]

    return grads_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The parameters and the optimizer state are updated in
    place (and returned); `metrics` holds the step's 0-dim tensors "loss",
    "grad_norm" and "lr" (and "ce", "z_loss", "aux" with one microbatch).
    The batch may hold NumPy arrays: they go to the parameters' device."""
    adamw = make_adamw_config(tc)
    grads_fn = make_grads_fn(cfg, tc)

    def step(params, opt_state, batch):
        loss, metrics, grads = grads_fn(params, batch)
        grad_tree = tree_unflatten(params, grads)
        del grads
        with torch.no_grad():
            grad_tree, gnorm = clip_by_global_norm(grad_tree, tc.grad_clip)
            params, opt_state, lr = apply_updates(params, grad_tree,
                                                  opt_state, adamw)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return params, opt_state, out

    return step


def train_state_specs(param_tree, dtype: torch.dtype = torch.float32):
    """(shape, dtype) specs of the optimizer state matching a tree of
    parameters or `ParamSpec`s."""
    shaped = tree_map(lambda p: TensorSpec(tuple(p.shape), dtype),
                      param_tree)
    return {"m": shaped, "v": tree_map(lambda s: s, shaped),
            "step": TensorSpec((), torch.int32)}
