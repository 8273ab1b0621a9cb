"""Meshes: the production meshes of training and the seeding mesh.

The JAX package's production meshes are (data=16, model=16), 256 chips,
and (pod=2, data=16, model=16), 512 chips, whose "pod" axis carries the
cross-pod data parallelism.  The port builds them as
`torch.distributed.device_mesh.DeviceMesh`es over one rank a card
(`make_production_mesh`), which needs a world of 256 or 512 ranks, and
names the same layouts without devices (`abstract_production_mesh`, an
`AbstractMesh` that `distributed.sharding.resolve_spec` reads with no
process group).  `make_host_mesh` is the one-rank (1, 1) ("data",
"model") mesh on the CPU, over gloo.  Functions, never module-level
constants: importing this module starts no process group.

The seeding mesh: the JAX package's `make_seeding_mesh` builds a 1-D
``("data",)`` device mesh for `shard_map`.  The port drives its shards
from one Python controller (`repro_torch.core.sharded_seeding`), so its
seeding mesh is an ordered tuple of shard devices and nothing more.  A
device may repeat: four shards on ``cuda:0`` run the whole sharded path
on one card, and four shards on ``"cpu"`` do the same in the CPU tests.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import AbstractMesh

__all__ = ["make_production_mesh", "abstract_production_mesh",
           "make_host_mesh", "abstract_host_mesh", "SeedingMesh",
           "make_seeding_mesh"]


def _production_layout(multi_pod: bool) -> tuple:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axis names and sizes, without devices."""
    return AbstractMesh(*_production_layout(multi_pod))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the default process group's ranks, one a
    card: (data=16, model=16), or (pod=2, data=16, model=16) with
    `multi_pod`.  A world of another size raises, naming the ranks it
    needs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = _production_layout(multi_pod)
    need = AbstractMesh(shape, names).size()
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{dict(zip(names, shape))} needs a world of {need} ranks, one "
            f"a card; this one has {have}")
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def abstract_host_mesh() -> AbstractMesh:
    return AbstractMesh((1, 1), ("data", "model"))


def make_host_mesh():
    """A one-rank (1, 1) ("data", "model") mesh on the CPU over gloo (CPU
    tests).  It starts a one-rank gloo group from an in-memory store when
    no default group exists; a default group of more ranks raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"a host mesh is one rank; the default group "
                           f"has {dist.get_world_size()}")
    return DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


@dataclasses.dataclass(frozen=True)
class SeedingMesh:
    """An ordered tuple of shard devices (frozen, hashable): shard i owns
    the i-th contiguous range of the padded points."""

    devices: tuple

    def __post_init__(self):
        devices = tuple(_canonical(d) for d in self.devices)
        if not devices:
            raise ValueError("a seeding mesh needs at least one shard")
        types = {d.type for d in devices}
        if len(types) > 1:
            raise ValueError(f"shards on devices of several types: {types}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """The number of shards D."""
        return len(self.devices)

    @property
    def device_type(self) -> str:
        """``"cuda"`` or ``"cpu"``: every shard is of one type."""
        return self.devices[0].type


def make_seeding_mesh(num_devices: int | None = None, *,
                      device="cuda") -> SeedingMesh:
    """A mesh of `num_devices` shards of `device`'s type.

    With ``device="cuda"`` the default is one shard per visible card, and a
    count puts shard i on ``cuda:(i % device_count)``; a device with an
    index (``"cuda:1"``) puts every shard on that card.  With
    ``device="cpu"`` the default is one shard, and a count gives that many
    CPU shards.  CUDA asked for and absent raises: the mesh never falls
    back to the CPU.
    """
    dev = torch.device(device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a seeding mesh on {device!r} needs CUDA, which is not "
                "available; pass device='cpu' for CPU shards")
        if dev.index is not None:
            return SeedingMesh((dev,) * (num_devices or 1))
        count = torch.cuda.device_count()
        n = count if num_devices is None else num_devices
        return SeedingMesh(tuple(torch.device("cuda", i % count)
                                 for i in range(n)))
    if dev.type == "cpu":
        return SeedingMesh((dev,) * (num_devices or 1))
    raise ValueError(f"no seeding mesh on device {device!r}")
