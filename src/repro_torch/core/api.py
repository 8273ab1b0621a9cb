"""Public clustering facade.

Two entry points, as in the JAX package:

  * **Plan/execute (preferred)** — `ClusterSpec` + `ExecutionSpec` bind
    into a `ClusterPlan` (`repro_torch.core.plan`): `prepare(points)`
    caches the host-side artifacts by data fingerprint, and
    `fit`/`refit`/`fit_batch` run the solve stage, returning `FitResult`s
    of tensors on the plan's device.
  * **Legacy facade (deprecated)** — `fit(points, KMeansConfig(...))`
    returning a host-side `KMeans`.  It runs the registered seed_fn of the
    (seeder, backend) pair with capability-driven kwargs, so for the same
    seed it opens the same centers as `ClusterPlan.fit`.

Both default to the ``"device"`` backend on ``"cuda"``, where the JAX
package defaults to ``"cpu"``: the port's entry points run on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np

from repro_torch.core import device_seeding  # noqa: F401  registers "device"
from repro_torch.core import sharded_seeding  # noqa: F401  registers "sharded"
from repro_torch.core import registry
from repro_torch.core.batch_schedule import BatchSchedule
from repro_torch.core.lloyd import LloydResult, assign, lloyd
from repro_torch.core.plan import (
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    FitResult,
    PreparedData,
    data_fingerprint,
    ensure_host_f64,
    resolve_device,
)
from repro_torch.core.preprocess import quantize
from repro_torch.core.registry import (
    BACKENDS,
    SEEDER_SPECS,
    SeederSpec,
    capability_table,
)
from repro_torch.core.seeding import SEEDERS, SeedingResult, clustering_cost
# Streaming ops attach to the registered BackendImpls at import time, so
# this comes after the backend-registering imports above.
from repro_torch.core import streaming  # noqa: F401  attaches streaming ops

__all__ = [
    "KMeansConfig", "KMeans", "fit", "resolve_seeder", "BACKENDS",
    "BatchSchedule", "ClusterPlan", "ClusterSpec", "ExecutionSpec",
    "FitResult", "PreparedData", "SEEDER_SPECS", "SeederSpec",
    "capability_table", "data_fingerprint", "ensure_host_f64",
]


def resolve_seeder(name: str, backend: str = "device"):
    """Seeder lookup behind a backend selector.

    ``backend="device"`` (the default; the JAX package's is ``"cpu"``,
    but the port's entry points run on the card unless asked for the CPU)
    returns the facade that runs the seeder on a device through its
    registered prepare and solve; ``backend="sharded"`` the same over a
    seeding mesh of shards (``mesh=`` a `SeedingMesh`, default
    ``make_seeding_mesh(device=device)``); ``backend="cpu"`` the faithful
    NumPy implementation.  Composite keys like ``"rejection/device"`` resolve
    through `SEEDERS` directly.
    """
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if name not in SEEDER_SPECS:
        return SEEDERS[name]
    return registry.resolve(name, backend)


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """Legacy per-call configuration (deprecated; see `ClusterSpec`).

    Frozen and hashable: `seeder_kwargs` accepts a mapping and is stored as
    a sorted tuple of (key, value) pairs.  `backend` defaults to
    ``"device"`` (the JAX package's default is ``"cpu"``), and `device`,
    the port's own field, places the device and sharded seeders
    (``"cuda"`` unless the caller asks for ``"cpu"``; a sharded fit's
    shards are ``make_seeding_mesh(device=device)`` unless
    `seeder_kwargs` gives a ``mesh``).
    """

    k: int
    seeder: str = "rejection"           # any registered seeder name
    backend: str = "device"             # "cpu" (NumPy) | "device" | "sharded"
    lloyd_iters: int = 0                # 0 = seeding only (paper experiments)
    quantize: bool = True               # Appendix-F aspect-ratio control
    c: float = 2.0                      # LSH approximation factor (rejection)
    # Candidate-batch schedule of the rejection seeders (None = the
    # adaptive default); ignored by seeders without a speculative batch.
    schedule: Optional[BatchSchedule] = None
    seed: int = 0
    seeder_kwargs: Any = ()
    device: str = "cuda"

    def __post_init__(self):
        if isinstance(self.seeder_kwargs, dict):
            object.__setattr__(self, "seeder_kwargs",
                               tuple(sorted(self.seeder_kwargs.items())))
        else:
            object.__setattr__(self, "seeder_kwargs",
                               tuple(self.seeder_kwargs))

    def to_specs(self) -> tuple[ClusterSpec, ExecutionSpec]:
        """The plan-API equivalent of this config (migration helper); a
        ``mesh`` in `seeder_kwargs` moves to the `ExecutionSpec`."""
        options = dict(self.seeder_kwargs)
        mesh = options.pop("mesh", None)
        return (
            ClusterSpec(k=self.k, seeder=self.seeder, c=self.c,
                        schedule=self.schedule, lloyd_iters=self.lloyd_iters,
                        quantize=self.quantize, seed=self.seed,
                        options=options),
            ExecutionSpec(backend=self.backend, device=self.device,
                          mesh=mesh),
        )


@dataclasses.dataclass
class KMeans:
    config: KMeansConfig
    centers: np.ndarray
    seeding: SeedingResult
    refinement: Optional[LloydResult]
    cost: float

    def predict(self, points: np.ndarray) -> np.ndarray:
        """Nearest-center index per point (float64, on the host)."""
        idx, _ = assign(points, self.centers)
        return idx


def fit(points: np.ndarray, config: KMeansConfig) -> KMeans:
    """Deprecated one-shot facade (use `ClusterPlan` for repeated fits).

    Draws from ``np.random.default_rng(config.seed)`` as `ClusterPlan.fit`
    does (quantisation, then the seeder), and every capability decision
    (quantise? pass `c`? pass the schedule?) comes from the registry, so
    both open the same centers.  Centers, cost and the optional Lloyd
    refinement are float64 NumPy on the host.
    """
    warnings.warn(
        "fit(points, KMeansConfig(...)) is deprecated; build a ClusterPlan "
        "(ClusterSpec + ExecutionSpec) to cache the prepare stage across "
        "fits", DeprecationWarning, stacklevel=2)
    seed_fn = resolve_seeder(config.seeder, config.backend)
    kwargs = dict(config.seeder_kwargs)
    if config.backend in ("device", "sharded"):
        resolve_device(config.device)      # raises when CUDA is absent
        kwargs.setdefault("device", config.device)
    rng = np.random.default_rng(config.seed)
    pts = ensure_host_f64(points)
    seed_pts = pts
    spec = SEEDER_SPECS.get(config.seeder)
    caps = spec.caps if spec is not None else registry.SeederCaps()
    if caps.needs_quantize and config.quantize:
        seed_pts = quantize(pts, rng).points
        kwargs.setdefault("resolution", 1.0)
    if caps.accepts_c:
        kwargs.setdefault("c", config.c)
    if caps.accepts_schedule and config.schedule is not None:
        kwargs.setdefault("schedule", config.schedule)
    result = seed_fn(seed_pts, config.k, rng, **kwargs)
    # Centers are reported in original coordinates.
    centers = pts[result.indices].copy()
    refinement = None
    if config.lloyd_iters > 0:
        refinement = lloyd(pts, centers, max_iters=config.lloyd_iters)
        centers = refinement.centers
        cost = refinement.cost
    else:
        cost = clustering_cost(pts, centers)
    return KMeans(config=config, centers=centers, seeding=result,
                  refinement=refinement, cost=cost)
