"""Worker bodies of the port's multi-rank tests, in processes of their own
(`torch.multiprocessing`'s spawn context) over a group from a `FileStore`:
gloo on the CPU, or NCCL with rank r on card r (the two-card test of
`tests/test_torch_cuda.py`).

This module imports no JAX and nothing of the JAX package, and the test
files that spawn its workers import JAX only in their own process: each
worker reports whether ``jax`` reached its `sys.modules`.  `spawn_ranks`
runs one body on `world` ranks and returns each rank's result; every wait
has its own timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import sys

import numpy as np
import torch
import torch.distributed as dist

JOIN_SECONDS = 60


def _device(rank: int, backend: str) -> torch.device:
    return torch.device("cuda", rank) if backend == "nccl" else \
        torch.device("cpu")


def _main(body: str, rank: int, world: int, store: str, backend: str,
          kwargs: dict, out) -> None:
    torch.set_num_threads(1)
    extra = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        extra["device_id"] = _device(rank, backend)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world, **extra)
    try:
        result = globals()[body](rank, world, _device(rank, backend),
                                 **kwargs)
        out.put((rank, result, "jax" in sys.modules, None))
    except Exception as exc:  # reported to the test, which fails on it
        out.put((rank, None, "jax" in sys.modules, repr(exc)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(body: str, world: int, store: str, backend: str = "gloo",
                **kwargs) -> list:
    """`body(rank, world, device, **kwargs)` on `world` spawned ranks;
    returns the results in rank order.  Raises if a rank failed, imported
    JAX, or did not finish within `JOIN_SECONDS`."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_main, args=(body, r, world, store, backend,
                                             kwargs, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, result, saw_jax, err = out.get(timeout=JOIN_SECONDS)
            if err is not None:
                raise AssertionError(f"rank {rank}: {err}")
            if saw_jax:
                raise AssertionError(f"rank {rank} imported jax")
            got[rank] = result
    finally:
        for p in procs:
            p.join(timeout=JOIN_SECONDS)
            if p.is_alive():
                p.kill()
                p.join(timeout=JOIN_SECONDS)
    for p in procs:
        assert not p.is_alive() and p.exitcode == 0, (p.pid, p.exitcode)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Bodies.
# ---------------------------------------------------------------------------

def compressed_psum_body(rank: int, world: int, device, n: int,
                         seed: int) -> dict:
    """`compressed_psum` of this rank's own vector (each rank's values of
    another magnitude, so the scales differ)."""
    from repro_torch.training.grad_compress import compressed_psum

    rng = np.random.default_rng(seed + rank)
    x = (rng.normal(size=n) * 10.0 ** (rank - 1)).astype(np.float32)
    value, res = compressed_psum(torch.from_numpy(x).to(device))
    return {"x": x, "value": value.cpu().numpy(),
            "residual": res.cpu().numpy()}


def linear_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2)


def ddp_body(rank: int, world: int, device, x: np.ndarray, y: np.ndarray,
             w0: np.ndarray, steps: int, compress: bool) -> dict:
    """`make_ddp_step` on this rank's contiguous share of the batch."""
    from repro_torch.training.grad_compress import make_ddp_step

    share = x.shape[0] // world
    lo = rank * share
    batch = {"x": torch.from_numpy(x[lo:lo + share]).to(device),
             "y": torch.from_numpy(y[lo:lo + share]).to(device)}
    params = {"w": torch.from_numpy(w0.copy()).to(device)}
    residuals = {"w": torch.zeros_like(params["w"])}
    step = make_ddp_step(linear_loss, None, lr=0.1, compress=compress)
    losses = []
    for _ in range(steps):
        params, residuals, loss = step(params, residuals, batch)
        losses.append(float(loss))
    return {"losses": losses, "w": params["w"].detach().cpu().numpy()}


def tanh_stage(params, x):
    return torch.tanh(x @ params)


def pipeline_body(rank: int, world: int, device, w: np.ndarray,
                  x: np.ndarray) -> dict:
    """`pipeline_apply` with stage s = rank s of the default group, and a
    DTensor laid out by `shard` on a ("data",) mesh of the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import shard, use_mesh

    out = pipeline_apply(tanh_stage, torch.from_numpy(w).to(device),
                         torch.from_numpy(x).to(device), None).cpu()
    mesh = init_device_mesh(device.type, (world,),
                            mesh_dim_names=("data",))
    full = torch.arange(4 * world * 3, dtype=torch.float32,
                        device=device).reshape(4 * world, 3)
    with use_mesh(mesh):
        laid = shard(distribute_tensor(full, mesh, [Replicate()]),
                     ("batch", "embed"))
    return {"out": out.numpy(), "local": laid.to_local().cpu().numpy(),
            "placements": [str(p) for p in laid.placements]}
