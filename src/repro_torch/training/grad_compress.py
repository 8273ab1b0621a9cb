"""Gradient compression for the data-parallel all-reduce.

The counterpart of the JAX package's `training/grad_compress.py`:
  * `int8_compress` / `int8_decompress` — per-tensor symmetric int8
    quantisation with an error-feedback residual (the residual is added
    back into the next step's gradient, so quantisation noise is unbiased
    over time — 1-bit Adam / EF-SGD style);
  * `compressed_psum` — an int8 all-reduce over a `torch.distributed`
    group: quantise, sum every rank's int8 values exactly, dequantise with
    the largest scale, divide by the group's size;
  * `make_ddp_step` — a pure-DP (replicated parameters) SGD step that
    drives the compressed collective end to end; `sync_grads` is its
    gradient synchronisation.

What travels.  The JAX package widens q to int16 and `psum`s it: 2 bytes
an element through a reduction.  No backend here reduces 16-bit integers
(gloo refuses int16, NCCL has no such type) and an int8 reduction wraps
(100 + 100 gives -56), so the port gathers the int8 values themselves
(`all_gather`: each rank sends 1 byte an element and receives 1 byte an
element from each of the n - 1 others) and sums them locally in int32:
the same integer as the JAX package's sum, exactly.  Beside them one f32
scale a tensor goes through a MAX reduction.  A ring all-reduce of f32
moves about 2 (n - 1) / n x 4 bytes an element each way, so the gather
moves fewer bytes for n up to 8.

The JAX `Mesh` and axis name become a group: a `DeviceMesh` and an axis
name, or a `ProcessGroup` (None: the default group).  `psum` and `pmax`
are `all_reduce` SUM and MAX; `pmean` is SUM divided by the group's size,
as `jax.lax.pmean` defines it (gloo has no AVG).  On the card the group
is NCCL and the tensors live there; on the CPU, gloo.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_group
from repro_torch.models.params import tree_unflatten
from repro_torch.optim.adamw import tree_leaves

__all__ = [
    "int8_compress",
    "int8_decompress",
    "compressed_psum",
    "sync_grads",
    "make_ddp_step",
]

_F32 = torch.float32


def int8_compress(x: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """-> (q int8, scale f32 0-dim, new_residual f32).  Error feedback
    included."""
    x = x.to(_F32)
    if residual is not None:
        x = x + residual
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.to(_F32) * scale
    return q, scale, new_residual


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The group's mean of `x` (a new tensor of its type)."""
    total = x.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / dist.get_world_size(group)


def compressed_psum(x: torch.Tensor, group=None,
                    residual: Optional[torch.Tensor] = None):
    """int8 error-feedback mean of `x` over the ranks of `group`.

    Returns (mean-reduced f32 value, new_residual): the sum of every
    rank's q times the largest scale, divided by the group's size.  With
    one rank it is `int8_decompress(q, scale)`.
    """
    q, scale, new_residual = int8_compress(x, residual)
    n = dist.get_world_size(group)
    parts = [torch.empty_like(q) for _ in range(n)]
    dist.all_gather(parts, q, group=group)
    total = parts[0].to(torch.int32)
    for part in parts[1:]:
        total += part
    # Each rank quantised with its own scale; the largest is used, as in
    # the JAX package (a scalar a tensor, negligible bytes).
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    value = total.to(_F32) * scale_max / n
    return value, new_residual


def sync_grads(grads: list, residuals: list, group=None,
               compress: bool = True) -> tuple:
    """(synced gradients, residuals) of lists of tensors: each gradient's
    `compressed_psum` with its residual, or its plain mean over the group
    with the residual as it was."""
    synced, out_r = [], []
    for g, r in zip(grads, residuals):
        if compress:
            g_sync, r = compressed_psum(g, group, r)
        else:
            g_sync = _pmean(g, group)
        synced.append(g_sync)
        out_r.append(r)
    return synced, out_r


def make_ddp_step(loss_fn, mesh=None, axis_name: str = "data",
                  lr: float = 1e-2, compress: bool = True):
    """SGD data-parallel step with compressed gradient sync.

    loss_fn(params, batch) -> 0-dim tensor.  Every rank holds the whole
    parameter tree and calls the step with its own shard of the batch (the
    slice `shard_map` hands each device in the JAX package).  Returns
    step(params, residuals, batch) -> (params, residuals, loss): the
    parameters updated in place, p - lr g computed in f32 and rounded once
    into p's type (the JAX step promotes bf16 parameters to f32 when it
    compresses), the new residuals, and the group's mean loss.
    """
    group = axis_group(mesh, axis_name)

    def step(params, residuals, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss = _pmean(loss, group)
        synced, new_r = sync_grads(grads, tree_leaves(residuals), group,
                                   compress)
        del grads
        with torch.no_grad():
            for p, g in zip(leaves, synced):
                p.copy_(p.to(_F32) - lr * g.to(_F32))
        return params, tree_unflatten(params, new_r), loss

    return step
