"""Typed seeder registry: one `SeederSpec` per algorithm, with its
capabilities and its per-backend implementations.

The port keeps the pieces of the JAX package's registry that `ClusterPlan`
uses: an algorithm declares whether it wants the Appendix-F quantisation,
and each backend attaches a cached prepare/solve pair.  Registration happens where
the implementations live (`core.device_seeding` for the one backend this
port has so far).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = [
    "BACKENDS",
    "SeederCaps",
    "BackendImpl",
    "SeederSpec",
    "SEEDER_SPECS",
    "register_seeder",
    "register_backend",
    "get_seeder_spec",
]

BACKENDS = ("device",)


@dataclasses.dataclass(frozen=True)
class SeederCaps:
    """Algorithm-level capabilities (identical across backends).

    needs_quantize: runs in the Appendix-F quantised space when enabled.
    """

    needs_quantize: bool = False


@dataclasses.dataclass(frozen=True)
class BackendImpl:
    """One backend's implementation of a seeder: the cached-plan split.

    ``prepare(pts, rng, *, resolution, options, execution) -> artifacts``
    builds the structures (codes, keys, device uploads), consuming from
    ``rng`` exactly the JAX package's draws; ``solve(artifacts, pts, k,
    rng, *, c, schedule, options, execution) -> (indices, extras)`` runs
    the sampling stage only.  ``device_native`` says, as in the JAX
    package, that the whole solve runs on the device (k-means|| reclusters
    its pool on the host, so it is not).  Nothing in the port reads it yet:
    the JAX package's plan keys its device-resident fast path on it, and
    the port's tests hold the flag to the JAX registration.
    """

    prepare: Callable
    solve: Callable
    device_native: bool = False


@dataclasses.dataclass
class SeederSpec:
    """An algorithm plus its per-backend implementations."""

    name: str
    caps: SeederCaps
    impls: dict = dataclasses.field(default_factory=dict)

    def impl(self, backend: str) -> BackendImpl:
        """The backend's `BackendImpl` (KeyError when not implemented)."""
        if backend not in BACKENDS:
            raise KeyError(f"unknown backend {backend!r}; expected {BACKENDS}")
        found = self.impls.get(backend)
        if found is None:
            raise KeyError(f"seeder {self.name!r} has no {backend} "
                           f"implementation; available: {sorted(self.impls)}")
        return found


SEEDER_SPECS: dict[str, SeederSpec] = {}


def register_seeder(name: str,
                    caps: Optional[SeederCaps] = None) -> SeederSpec:
    """Create (or fetch) the spec for `name`."""
    spec = SEEDER_SPECS.get(name)
    if spec is None:
        spec = SeederSpec(name=name, caps=caps or SeederCaps())
        SEEDER_SPECS[name] = spec
    return spec


def register_backend(name: str, backend: str, impl: BackendImpl) -> None:
    """Attach one backend implementation to seeder `name`."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; expected {BACKENDS}")
    register_seeder(name).impls.setdefault(backend, impl)


def get_seeder_spec(name: str) -> SeederSpec:
    """The registered spec for `name` (KeyError lists what exists)."""
    spec = SEEDER_SPECS.get(name)
    if spec is None:
        raise KeyError(f"unknown seeder {name!r}; available: "
                       f"{sorted(SEEDER_SPECS)}")
    return spec
