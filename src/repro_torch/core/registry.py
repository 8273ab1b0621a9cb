"""Typed seeder registry: one `SeederSpec` per algorithm, with its
capabilities and its per-backend implementations.

An algorithm declares whether it wants the Appendix-F quantisation,
whether it takes the LSH approximation factor ``c`` or a `BatchSchedule`;
each backend attaches its ``run`` seed_fn and, where it has one, a cached
prepare/solve pair.  Registration happens where the implementations live:
`core.seeding` registers the faithful CPU algorithms (NumPy, as in the JAX
package), `core.device_seeding` the seeders on the card and
`core.sharded_seeding` the seeders over a mesh of shards.  This module
depends on none of them, so everything can import it without cycles.

The legacy ``SEEDERS`` dict of `core.seeding` is filled by the same
registration calls, with the composite ``"<name>/<backend>"`` keys (the
bare name for cpu), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

__all__ = [
    "BACKENDS",
    "SeederCaps",
    "BackendImpl",
    "SeederSpec",
    "SEEDER_SPECS",
    "register_seeder",
    "register_backend",
    "get_seeder_spec",
    "resolve",
    "capability_table",
]

BACKENDS = ("cpu", "device", "sharded")


@dataclasses.dataclass(frozen=True)
class SeederCaps:
    """Algorithm-level capabilities (identical across backends).

    needs_quantize: runs in the Appendix-F quantised space when enabled.
    accepts_c: takes the LSH approximation factor ``c`` (rejection).
    accepts_schedule: takes a `BatchSchedule` for its candidate blocks.
    """

    needs_quantize: bool = False
    accepts_c: bool = False
    accepts_schedule: bool = False


@dataclasses.dataclass(frozen=True)
class BackendImpl:
    """One backend's implementation of a seeder.

    ``run(points, k, rng, **kw) -> SeedingResult`` is the host-facing
    seed_fn every backend provides; the legacy `fit` facade calls it.
    ``prepare(pts, rng, *, resolution, options, execution) -> artifacts``
    builds the structures (codes, keys, device uploads), consuming from
    ``rng`` exactly the JAX package's draws; ``solve(artifacts, pts, k,
    rng, *, c, schedule, options, execution) -> (indices, extras)`` runs
    the sampling stage only.  Both ``None`` (the CPU algorithms, which
    build their structures and sample in one pass) means the plan falls
    back to ``run``.  ``device_native`` says, as in the JAX package, that
    the whole solve runs on the device (k-means|| reclusters its pool on
    the host, so it is not); the port's tests hold the flag to the JAX
    registration.

    ``prepare_stacked(pts, rng, *, options, execution) -> StackedLane``
    builds one dataset's canonically rescaled, shape-bucket-padded lane
    for `ClusterPlan.fit_batch(datasets=...)`; ``solve_stacked(lanes, k,
    lane_seeds, *, c, schedule, options, execution) -> ((B, k) indices,
    extras)`` solves the lanes of one shape bucket together, lane j's
    generator seeded with ``lane_seeds[j]``.  Both ``None`` means the
    backend solves multiple datasets by looping the solo path.

    ``streaming`` is the mutable-data split
    (`repro_torch.core.streaming.StreamingOps`): ``prepare``/``extend``/
    ``retire``/``solve`` over a capacity-padded `StreamState` whose leaf
    weights are patched by `TiledSampleTree` scatter updates instead of
    re-fingerprinting.  ``None`` means `ClusterPlan.extend`/`retire` are
    unavailable on this backend.  Ops with ``native=False`` (the sharded
    fallback) re-shard on the next solve with a logged reason instead of
    patching.
    """

    run: Callable
    prepare: Optional[Callable] = None
    solve: Optional[Callable] = None
    device_native: bool = False
    prepare_stacked: Optional[Callable] = None
    solve_stacked: Optional[Callable] = None
    streaming: Optional[Any] = None

    @property
    def preparable(self) -> bool:
        """True when the backend exposes the cached prepare/solve split."""
        return self.prepare is not None and self.solve is not None

    @property
    def supports_stacked(self) -> bool:
        """True when B *different* datasets can be solved as stacked
        lanes."""
        return (self.prepare_stacked is not None
                and self.solve_stacked is not None)

    @property
    def supports_streaming(self) -> bool:
        """True when the backend exposes streaming extend/retire ops."""
        return self.streaming is not None


@dataclasses.dataclass
class SeederSpec:
    """An algorithm plus its per-backend implementations.

    ``fallback`` names the seeder a server degrades to when this one keeps
    failing (``None`` ends the chain): ``rejection -> kmeans|| ->
    kmeans++``, links that share the O(log k) guarantee.
    """

    name: str
    caps: SeederCaps
    doc: str = ""
    impls: dict = dataclasses.field(default_factory=dict)
    fallback: Optional[str] = None

    def impl(self, backend: str) -> BackendImpl:
        """The backend's `BackendImpl` (KeyError when not implemented)."""
        if backend not in BACKENDS:
            raise KeyError(f"unknown backend {backend!r}; expected {BACKENDS}")
        found = self.impls.get(backend)
        if found is None:
            raise KeyError(f"seeder {self.name!r} has no {backend} "
                           f"implementation; available: {sorted(self.impls)}")
        return found

    @property
    def backends(self) -> tuple[str, ...]:
        """Backends with a registered implementation, in BACKENDS order."""
        return tuple(b for b in BACKENDS if b in self.impls)


SEEDER_SPECS: dict[str, SeederSpec] = {}


def register_seeder(name: str, caps: Optional[SeederCaps] = None,
                    doc: str = "",
                    fallback: Optional[str] = None) -> SeederSpec:
    """Create (or fetch) the spec for `name`.  A later registration may
    fill in `fallback` on an existing spec (the first non-None wins)."""
    spec = SEEDER_SPECS.get(name)
    if spec is None:
        spec = SeederSpec(name=name, caps=caps or SeederCaps(), doc=doc,
                          fallback=fallback)
        SEEDER_SPECS[name] = spec
    elif spec.fallback is None and fallback is not None:
        spec.fallback = fallback
    return spec


def register_backend(name: str, backend: str, impl: BackendImpl, *,
                     legacy_registry: Optional[dict] = None) -> None:
    """Attach one backend implementation to seeder `name`.

    `legacy_registry` (the flat ``SEEDERS`` dict) also receives the
    composite ``"<name>/<backend>"`` key (the bare name for cpu).
    """
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; expected {BACKENDS}")
    register_seeder(name).impls.setdefault(backend, impl)
    if legacy_registry is not None:
        key = name if backend == "cpu" else f"{name}/{backend}"
        legacy_registry.setdefault(key, impl.run)


def get_seeder_spec(name: str) -> SeederSpec:
    """The registered spec for `name` (KeyError lists what exists)."""
    spec = SEEDER_SPECS.get(name)
    if spec is None:
        raise KeyError(f"unknown seeder {name!r}; available: "
                       f"{sorted(SEEDER_SPECS)}")
    return spec


def resolve(name: str, backend: str = "device") -> Callable:
    """The host-facing ``seed_fn`` for (algorithm, backend).  The default
    backend is the card's, where the JAX package's is ``"cpu"``: the
    port's entry points run on the card unless asked for the CPU."""
    return get_seeder_spec(name).impl(backend).run


def capability_table() -> str:
    """Markdown capability matrix generated from the live registry, with
    the JAX package's columns; a backend whose streaming ops are not
    native reads "<backend> (fallback)"."""
    header = ("| seeder | backends | device-native | cached prepare "
              "| stacked | streaming | quantize | accepts `c` "
              "| accepts schedule | degrades to |")
    rows = [header, "|---" * 10 + "|"]
    for name in sorted(SEEDER_SPECS):
        spec = SEEDER_SPECS[name]
        native = [b for b in spec.backends if spec.impls[b].device_native]
        prep = [b for b in spec.backends if spec.impls[b].preparable]
        stacked = [b for b in spec.backends
                   if spec.impls[b].supports_stacked]
        streaming = [b if spec.impls[b].streaming.native
                     else f"{b} (fallback)" for b in spec.backends
                     if spec.impls[b].supports_streaming]
        fallback = f"`{spec.fallback}`" if spec.fallback else "—"
        rows.append(
            f"| `{name}` | {', '.join(spec.backends)} "
            f"| {', '.join(native) or '—'} "
            f"| {', '.join(prep) or '—'} "
            f"| {', '.join(stacked) or '—'} "
            f"| {', '.join(streaming) or '—'} "
            f"| {'yes' if spec.caps.needs_quantize else '—'} "
            f"| {'yes' if spec.caps.accepts_c else '—'} "
            f"| {'yes' if spec.caps.accepts_schedule else '—'} "
            f"| {fallback} |")
    return "\n".join(rows)
