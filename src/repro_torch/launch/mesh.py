"""The seeding mesh: the shards of the sharded seeding backend.

The JAX package's `make_seeding_mesh` builds a 1-D ``("data",)`` device
mesh for `shard_map`.  The port drives its shards from one Python
controller (`repro_torch.core.sharded_seeding`), so its mesh is an ordered
tuple of shard devices and nothing more.  A device may repeat: four shards
on ``cuda:0`` run the whole sharded path on one card, and four shards on
``"cpu"`` do the same in the CPU tests.  The JAX package's production
meshes (data x model) belong to training, which is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SeedingMesh", "make_seeding_mesh"]


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
