"""Pipeline parallelism: GPipe-style microbatch rotation over a ring of
ranks.

The counterpart of the JAX package's `distributed/pipeline.py`.  Stage s
is rank s of a `torch.distributed` group (a `DeviceMesh` axis, or a
`ProcessGroup`); microbatches flow through the stages in the classic
bubble schedule of M + S - 1 ticks for M microbatches on S stages.  At
tick t stage 0 takes microbatch min(t, M - 1), every stage applies its
body, and the results rotate one step around the ring
(`batch_isend_irecv`: each rank sends to the next and receives from the
one before, where the JAX package uses `ppermute`); stage 0 collects the
finished microbatch t - (S - 1) from the last stage.  Every rank returns
stage 0's collection (a broadcast from it), which is what the JAX
package's replicated `out_specs` gives.

`pipeline_apply` is model-agnostic: it takes the per-stage body
`fn(stage_params, x) -> x` and runs the rotation.  It is forward only:
the rotation is not an autograd operation, and nothing in the JAX package
differentiates through its twin either.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_group
from repro_torch.models.params import tree_map

__all__ = ["pipeline_apply"]


def _rotate(buf: torch.Tensor, group, rank: int, s: int) -> torch.Tensor:
    """`buf` of every stage sent to the next stage around the ring; the
    one received from the stage before is returned."""
    if s == 1:
        return buf
    nxt = dist.get_global_rank(group, (rank + 1) % s)
    prev = dist.get_global_rank(group, (rank - 1) % s)
    recv = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf.contiguous(), nxt, group),
        dist.P2POp(dist.irecv, recv, prev, group)])
    for req in reqs:
        req.wait()
    return recv


@torch.no_grad()
def pipeline_apply(fn, stage_params, x: torch.Tensor, mesh=None, *,
                   axis: str = "stage") -> torch.Tensor:
    """Run `fn` as an S-stage pipeline over the ranks of `mesh`'s axis
    `axis` (a `DeviceMesh`), or of a `ProcessGroup` passed as `mesh` (None:
    the default group).  The calling process is the stage of its rank.

    stage_params: a tensor or a nested dict of tensors, each with a
    leading stage axis of S (rank s uses its slice s, as `shard_map`
    hands it out).
    x: (M, B_micro, ...) microbatches, the same on every rank (stage 0
    consumes them); `fn` maps one microbatch to a tensor of its shape and
    type.
    Returns the pipeline output in microbatch order, (M, B_micro, ...), on
    every rank.
    """
    group = axis_group(mesh, axis) or dist.group.WORLD
    s = dist.get_world_size(group)
    rank = dist.get_rank(group)
    m = x.shape[0]
    params = stage_params[rank] if isinstance(stage_params, torch.Tensor) \
        else tree_map(lambda p: p[rank], stage_params)
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m + s - 1):
        if rank == 0:
            buf = x[min(t, m - 1)]
        buf = _rotate(fn(params, buf), group, rank, s)
        done = t - (s - 1)
        if rank == 0 and done >= 0:
            outs[done] = buf
    dist.broadcast(outs, dist.get_global_rank(group, 0), group=group)
    return outs
