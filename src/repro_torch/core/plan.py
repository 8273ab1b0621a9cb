"""Plan/execute API: prepare a clustering problem once, fit it many times.

    spec = ClusterSpec(k=64, seeder="rejection", seed=0)
    plan = ClusterPlan(spec, ExecutionSpec(backend="device"))   # on cuda
    res  = plan.fit(points)       # prepare (cached by fingerprint) + solve
    res2 = plan.refit(seed=7)     # solve stage only: no re-prepare
    batch = plan.fit_batch([0, 1, 2, 3])   # lane i == refit(seed=i)
    lanes = plan.fit_batch(datasets=[a, b])  # stacked lanes, one solve
    prep = plan.prepare_streaming(points)  # a mutable stream
    plan.extend(more, prepared=prep); plan.retire(ids, prepared=prep)
    res3 = plan.fit_prepared(prep)  # over the live rows

Three stages, as in the JAX package's `core/plan.py`:

  * **plan** — `ClusterSpec` (algorithm parameters) and `ExecutionSpec`
    (backend, device, dtype, tile) are frozen dataclasses; a `ClusterPlan`
    binds them to one `BackendImpl` from the registry.
  * **prepare** — the host work (Appendix-F quantisation, multi-tree codes,
    LSH keys, device upload) runs once per data fingerprint and is cached.
    The rng draws it consumes are snapshotted, and they are the JAX
    package's draws in its order, so the artifacts are bit-identical.
  * **execute** — `fit` / `refit` / `fit_prepared` / `fit_batch` /
    `fit_batch_prepared` run only the sampling stage against the cached
    artifacts.  B solves of one shape (B seeds of one dataset, or B
    datasets of one shape bucket) run as one lane-batched solve, where the
    JAX package runs one vmapped program.

A stream (`prepare_streaming`, `extend`, `retire`; `core.streaming`) is a
`PreparedData` whose artifacts are patched in place; its solves cover the
live rows, and its cost masks out the retired ones.

Three backends: ``"device"`` (the default) runs the seeders on
`ExecutionSpec.device` through the hand-written kernels; ``"sharded"``
runs them over the shards of `ExecutionSpec.mesh` (`core.sharded_seeding`;
the plan resolves a mesh of the device's type when none is given);
``"cpu"`` runs the faithful NumPy seeders of `core.seeding` on the host,
which build their structures and sample in one pass, so only the
quantisation is cached for them.  The device is explicit:
`ExecutionSpec.device` defaults to ``"cuda"`` and a plan raises when CUDA
is absent, unless the caller asked for ``"cpu"`` — then every kernel
wrapper runs its plain PyTorch version.  Results are `FitResult`s holding
tensors on that device (the cpu backend's gather and cost run there too).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.batch_schedule import BatchSchedule
from repro_torch.core.lloyd import lloyd
from repro_torch.core.preprocess import quantize

__all__ = [
    "ClusterSpec",
    "ExecutionSpec",
    "ClusterPlan",
    "FitResult",
    "PreparedData",
    "ensure_host_f64",
    "data_fingerprint",
    "resolve_device",
    "resolve_execution",
]


def ensure_host_f64(points) -> np.ndarray:
    """Float64 C-contiguous host array of `points` (NumPy or a tensor on
    any device), copying only when the input does not conform."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    return np.ascontiguousarray(points, dtype=np.float64)


def data_fingerprint(points) -> str:
    """Content fingerprint keying the prepare cache (blake2b over the
    shape, dtype and every byte of the host copy)."""
    arr = ensure_host_f64(points)
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((arr.shape, str(arr.dtype))).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def resolve_device(name) -> torch.device:
    """`torch.device(name)`, raising when CUDA is asked for and absent: the
    port never falls back to the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "ExecutionSpec(device='cpu') to run the plain versions on the CPU")
    return dev


def _freeze_options(options) -> tuple:
    if isinstance(options, dict):
        return tuple(sorted(options.items()))
    return tuple(options)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Algorithm parameters: *what* to solve (frozen, hashable)."""

    k: int
    seeder: str = "rejection"           # a `registry.SEEDER_SPECS` key
    c: float = 2.0                      # LSH approximation factor
    schedule: Optional[BatchSchedule] = None
    lloyd_iters: int = 0                # 0 = seeding only
    quantize: bool = True               # Appendix-F aspect-ratio control
    seed: int = 0
    options: tuple = ()                 # extra seeder kwargs, (key, value)*

    def __post_init__(self):
        object.__setattr__(self, "options", _freeze_options(self.options))
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    def options_dict(self) -> dict:
        """The extra seeder options as a fresh dict."""
        return dict(self.options)

    def replace(self, **changes) -> "ClusterSpec":
        """A copy of the spec with `changes` applied."""
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Execution placement: *where/how* to solve (frozen, hashable).

    `device` is where the artifacts live and the kernels run: ``"cuda"``
    (the default) launches the hand-written kernels, ``"cpu"`` runs their
    plain PyTorch versions.  `tile` is the sweep kernel's tile of points
    (a multiple of 32, at most 1024).  `mesh`, a
    `repro_torch.launch.mesh.SeedingMesh`, places the sharded backend's
    shards; `None` resolves to ``make_seeding_mesh(device=device)`` when
    a plan is built (`resolve_execution`).
    """

    backend: str = "device"
    device: str = "cuda"
    dtype: str = "float32"
    tile: int = 512
    mesh: Any = None

    def __post_init__(self):
        if self.backend not in registry.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"{registry.BACKENDS}")


def resolve_execution(execution: ExecutionSpec) -> ExecutionSpec:
    """The execution a backend sees.  On the sharded backend the mesh is
    resolved (``make_seeding_mesh(device=execution.device)`` when None)
    and checked: its shards must be of `execution.device`'s type, and each
    must exist on this machine.  Other backends keep theirs as given."""
    if execution.backend != "sharded":
        return execution
    mesh = execution.mesh
    if mesh is None:
        from repro_torch.launch.mesh import make_seeding_mesh

        mesh = make_seeding_mesh(device=execution.device)
    want = torch.device(execution.device).type
    if mesh.device_type != want:
        raise ValueError(f"a mesh of {mesh.device_type} shards for an "
                         f"execution on {execution.device!r}")
    for dev in mesh.devices:
        resolve_device(dev)
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"shard device {dev} does not exist: "
                               f"{torch.cuda.device_count()} card(s) visible")
    return dataclasses.replace(execution, mesh=mesh)


@dataclasses.dataclass
class FitResult:
    """Clustering result: tensors on the device the solve ran on.

    `centers` are in original coordinates regardless of the quantised
    seeding space; `cost` is a 0-d f32 tensor.  `fit_batch` stacks a
    leading batch axis on all three.
    """

    indices: Any                  # (k,) int32 — or (B, k) from fit_batch
    centers: Any                  # (k, d)     — or (B, k, d)
    cost: Any                     # scalar f32 — or (B,)
    k: int = 0
    prepare_seconds: float = 0.0  # of the (cached) prepare this fit used
    solve_seconds: float = 0.0
    extras: dict = dataclasses.field(default_factory=dict)

    def block_until_ready(self) -> "FitResult":
        """Wait for the card's work behind the result (a no-op on the CPU
        and for the NumPy arrays of `to_numpy`); returns self."""
        if isinstance(self.indices, torch.Tensor) and self.indices.is_cuda:
            torch.cuda.synchronize(self.indices.device)
        return self

    def to_numpy(self) -> "FitResult":
        """Host copy: the same FitResult with NumPy arrays, and a float
        cost for a single problem."""
        cost = self.cost.cpu().numpy()
        return dataclasses.replace(
            self, indices=self.indices.cpu().numpy().astype(np.int64),
            centers=self.centers.cpu().numpy(),
            cost=float(cost) if cost.ndim == 0 else cost)

    def predict(self, points) -> torch.Tensor:
        """Nearest-center index per point, (n,) int32 on the centers'
        device (expanded BLAS form in the centers' dtype)."""
        if self.centers.dim() != 2:
            raise ValueError("predict() needs a single-problem FitResult "
                             "(index into a fit_batch result first)")
        pts = torch.as_tensor(points, dtype=self.centers.dtype,
                              device=self.centers.device)
        return torch.argmin(_pairwise_d2(pts, self.centers),
                            dim=1).to(torch.int32)


def _pairwise_d2(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances, expanded BLAS form (shared by predict and
    the cost)."""
    d2 = ((points ** 2).sum(dim=1, keepdim=True)
          - 2.0 * points @ centers.T
          + (centers ** 2).sum(dim=1)[None, :])
    return d2.clamp_min(0.0)


def _cost_program(points: torch.Tensor, centers: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  chunk: int = 65536) -> torch.Tensor:
    """sum_x min_c ||x - c||^2 as a 0-d tensor, in row chunks so the
    (rows, k) distance block stays bounded.  A stream's (n,) f32 live
    `mask` weights each row's term: its retired rows stay in place (global
    ids are stable) and count 0."""
    total = torch.zeros((), dtype=points.dtype, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        d2 = _pairwise_d2(points[lo: lo + chunk], centers).min(dim=1).values
        if mask is not None:
            d2 = d2 * mask[lo: lo + chunk]
        total += d2.sum()
    return total


@dataclasses.dataclass
class PreparedData:
    """One data fingerprint's cached prepare-stage output."""

    fingerprint: str
    pts: np.ndarray                   # original coords, host float64
    seed_pts: np.ndarray              # seeding-space coords (maybe quantised)
    resolution: Optional[float]       # quantisation grid passed to seeders
    artifacts: Any                    # BackendImpl.prepare output (or None)
    rng_state: dict                   # np.Generator state after prep draws
    prepare_seconds: float
    points_dev: Any = None            # device copy for gather/cost
    # A mutable `core.streaming.StreamState` makes this handle
    # extendable/retirable in place.  Mutation invalidates the content
    # fingerprint, so the cache re-keys a mutated handle on `generation`
    # (``<fp>/stream<seq>#g<generation>``, see `ClusterPlan.extend`) and a
    # stale content key can never alias it.
    streaming: Any = None
    generation: int = 0


def _load_backend(backend: str) -> None:
    """Importing a backend module registers its impls (idempotent)."""
    if backend == "device":
        import repro_torch.core.device_seeding  # noqa: F401
    elif backend == "sharded":
        import repro_torch.core.sharded_seeding  # noqa: F401
    else:
        import repro_torch.core.seeding  # noqa: F401


class ClusterPlan:
    """A clustering problem bound to a backend: prepare once, fit many times.

    Construction validates the (seeder, backend) pair against the registry
    and the device against the machine; `prepare` caches host artifacts by
    data fingerprint; `fit`/`refit`/`fit_prepared` run the solve stage.
    `fault_plan` is a `core.resilience.FaultPlan` (chaos testing; the
    `ClusterEngine` forwards its own to every plan it builds).
    """

    def __init__(self, cluster: ClusterSpec,
                 execution: Optional[ExecutionSpec] = None, *,
                 fault_plan=None):
        if not isinstance(cluster, ClusterSpec):
            raise TypeError(f"expected ClusterSpec, got "
                            f"{type(cluster).__name__}")
        execution = execution if execution is not None else ExecutionSpec()
        _load_backend(execution.backend)
        spec = registry.get_seeder_spec(cluster.seeder)
        self.cluster = cluster
        self.device = resolve_device(execution.device)
        self.execution = resolve_execution(execution)
        self.caps = spec.caps
        self.impl = spec.impl(execution.backend)
        self._prepared: dict[str, PreparedData] = {}
        self._active: Optional[PreparedData] = None
        self._lock = threading.Lock()      # cache dict + stats counters
        self.stats = {"prepare_calls": 0, "prepare_hits": 0,
                      "prepare_builds": 0, "solves": 0, "extends": 0,
                      "retires": 0}
        self._stream_seq = 0           # uniquifies streaming cache keys
        # Chaos hook (resilience.FaultPlan): seeded failure/latency
        # injection at the top of the prepare build and the solve; None
        # (the default) costs nothing on the hot path.
        self.fault_plan = fault_plan

    def _fault_inject(self, stage: str, detail: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.inject(
                stage, f"{self.cluster.seeder}/{self.execution.backend}/"
                       f"{stage}/{detail}")

    # -- prepare stage ------------------------------------------------------

    def prepare(self, points) -> "ClusterPlan":
        """Build (or fetch) the artifacts for `points` and make them the
        plan's active data.  Returns the plan for chaining."""
        prep = self.prepare_data(points)
        with self._lock:
            self._active = prep
        return self

    def prepare_stacked(self, points) -> PreparedData:
        """Thread-safe *stacked-lane* prepare (canonical rescale + padding).

        The multi-dataset twin of `prepare_data`: builds (or fetches, keyed
        by ``<fingerprint>/stacked``) the dataset's `StackedLane` artifacts
        -- the exact power-of-two rescale into the unit ball plus the
        `shape_bucket` row padding -- so a later `fit_batch_prepared` call
        can solve it with other same-bucket datasets as lanes of one solve.
        Requires an impl with the stacked capability (see the capability
        table).
        """
        if not self.impl.supports_stacked:
            raise ValueError(
                f"{self.cluster.seeder!r} on backend "
                f"{self.execution.backend!r} has no stacked lanes; use "
                "prepare_data + fit_batch(datasets=...) (solo loop)")
        return self._prepare_cached(points, stacked=True)

    def prepare_streaming(self, points) -> PreparedData:
        """Prepare `points` as a *mutable stream* (extend/retire in place).

        The streaming twin of `prepare_data`: the backend's streaming ops
        (see the capability table) freeze an exact power-of-two scale and
        build capacity-padded artifacts that `extend`/`retire` mutate
        incrementally -- new rows are encoded against the frozen trees/LSH
        and the leaf weights are patched by scatter updates, never
        re-fingerprinted.  Every call builds a fresh, independent stream
        (its cache key carries a per-plan sequence number and the mutation
        generation, so a content-fingerprint hit can never alias it), and
        makes it the plan's active data; `forget` releases it.
        """
        ops = self._streaming_ops()
        self._fault_inject("prepare", "stream")
        t0 = time.perf_counter()
        pts = ensure_host_f64(points)
        rng = np.random.default_rng(self.cluster.seed)
        state = ops.prepare(pts, rng, **self._stream_prepare_kw())
        with self._lock:
            seq = self._stream_seq
            self._stream_seq += 1
        fp = f"{data_fingerprint(pts)}/stream{seq}#g{state.generation}"
        prep = PreparedData(
            fingerprint=fp, pts=pts, seed_pts=pts, resolution=None,
            artifacts=None, rng_state=rng.bit_generator.state,
            prepare_seconds=time.perf_counter() - t0, streaming=state,
            generation=state.generation)
        with self._lock:
            self._prepared[fp] = prep
            self.stats["prepare_calls"] += 1
            self.stats["prepare_builds"] += 1
            self._active = prep
        return prep

    def _stream_prepare_kw(self) -> dict:
        options = dict(self.cluster.options_dict(),
                       _seeder=self.cluster.seeder)
        return dict(resolution=options.get("resolution"), options=options,
                    execution=self.execution)

    def _streaming_ops(self):
        ops = self.impl.streaming
        if ops is None:
            raise ValueError(
                f"{self.cluster.seeder!r} on backend "
                f"{self.execution.backend!r} has no streaming support (see "
                "the capability table); extend/retire need "
                "prepare_streaming-capable impls")
        return ops

    def extend(self, points, *, prepared: Optional[PreparedData] = None
               ) -> PreparedData:
        """Append `points` to a prepared stream *in place* (no re-prepare).

        New rows are scaled by the stream's frozen power of two, encoded
        against the frozen trees and LSH tables, and their leaf weights
        patched, so the next `fit_prepared`/`refit` draws the exact D^2 law
        over the grown live set (rows outside the frozen grid domain force
        a logged rebuild of the embedding).  `prepared` defaults to the
        plan's active handle; a handle that is not a stream becomes one in
        place first.  The handle is re-keyed in the prepare cache on its
        bumped generation.  Returns the handle.
        """
        ops = self._streaming_ops()
        prep = self._mutable_prep(prepared)
        ops.extend(prep.streaming, ensure_host_f64(points),
                   execution=self.execution)
        self._rekey_mutated(prep)
        with self._lock:
            self.stats["extends"] += 1
        return prep

    def retire(self, indices, *, prepared: Optional[PreparedData] = None
               ) -> PreparedData:
        """Retire rows (by global row id) from a prepared stream in place.

        Retired rows keep their ids (rows are never compacted), but their
        leaf weights drop to exactly 0: they have no mass in the tile
        cumsum, are never proposed, and are masked out of the cost.
        Extend-then-retire of the same rows gives the leaf weights back bit
        for bit.  The same conversion and re-keying as `extend`.  Returns
        the handle.
        """
        ops = self._streaming_ops()
        prep = self._mutable_prep(prepared)
        ops.retire(prep.streaming, np.asarray(indices, dtype=np.int64),
                   execution=self.execution)
        self._rekey_mutated(prep)
        with self._lock:
            self.stats["retires"] += 1
        return prep

    def _mutable_prep(self, prepared: Optional[PreparedData]
                      ) -> PreparedData:
        if prepared is None:
            with self._lock:
                prepared = self._active
            if prepared is None:
                raise RuntimeError(
                    "no prepared data: call plan.prepare_streaming(points) "
                    "(or prepare/fit) before extend/retire")
        if prepared.streaming is None:
            # In-place conversion of a static prep: a stream over its rows
            # from a fresh spec-seeded rng (the artifacts are superseded;
            # the rng replay snapshot stays, so seed=None refits remain
            # deterministic).
            prepared.streaming = self._streaming_ops().prepare(
                prepared.pts, np.random.default_rng(self.cluster.seed),
                **self._stream_prepare_kw())
            prepared.artifacts = None
            prepared.generation = prepared.streaming.generation
        return prepared

    def _rekey_mutated(self, prep: PreparedData) -> None:
        """Re-key a mutated prep on its generation: the content fingerprint
        no longer matches the data, so the stale key is dropped and the
        entry lives under ``<base>#g<generation>`` -- `forget` keeps
        working, and a fresh `prepare_data` of the original points can
        never alias the mutated handle.  The device copy of the rows is
        dropped (the row set changed)."""
        state = prep.streaming
        base = prep.fingerprint.split("#g")[0]
        with self._lock:
            old_key = prep.fingerprint
            prep.generation = state.generation
            new_key = f"{base}#g{state.generation}"
            if self._prepared.pop(old_key, None) is not None:
                self._prepared[new_key] = prep
            prep.fingerprint = new_key
            prep.points_dev = None

    def prepare_data(self, points) -> PreparedData:
        """Thread-safe prepare returning an explicit `PreparedData` handle
        (the plan's active data is left alone).  Re-preparing the same data
        is a cache hit that does no host work."""
        return self._prepare_cached(points, stacked=False)

    def _prepare_cached(self, points, *, stacked: bool) -> PreparedData:
        fp = data_fingerprint(points) + ("/stacked" if stacked else "")
        with self._lock:
            self.stats["prepare_calls"] += 1
            prep = self._prepared.get(fp)
            if prep is not None:
                self.stats["prepare_hits"] += 1
                return prep
        prep = self._build_prepared(fp, points, stacked)
        with self._lock:
            cur = self._prepared.get(fp)
            if cur is not None:            # lost a same-data build race
                self.stats["prepare_hits"] += 1
                return cur
            self._prepared[fp] = prep
            self.stats["prepare_builds"] += 1
        return prep

    def _build_prepared(self, fp: str, points,
                        stacked: bool) -> PreparedData:
        # Injection happens only on a real build: cache hits never
        # re-enter the fault domain (they do no work that could fail).
        self._fault_inject("prepare", fp)
        t0 = time.perf_counter()
        pts = ensure_host_f64(points)
        rng = np.random.default_rng(self.cluster.seed)
        options = self.cluster.options_dict()
        seed_pts, resolution = pts, options.get("resolution")
        artifacts = None
        if stacked:
            # Canonical lane: the exact power-of-two rescale replaces the
            # Appendix-F quantisation as the aspect-ratio control (fixed
            # canonical resolution => fixed level count).
            artifacts = self.impl.prepare_stacked(
                pts, rng, options=options, execution=self.execution)
        else:
            if self.caps.needs_quantize and self.cluster.quantize:
                seed_pts = quantize(pts, rng).points
                resolution = options.get("resolution", 1.0)
            if self.impl.preparable:
                artifacts = self.impl.prepare(
                    seed_pts, rng, resolution=resolution, options=options,
                    execution=self.execution)
        return PreparedData(
            fingerprint=fp, pts=pts, seed_pts=seed_pts,
            resolution=resolution, artifacts=artifacts,
            rng_state=rng.bit_generator.state,
            prepare_seconds=time.perf_counter() - t0,
            points_dev=torch.as_tensor(pts, dtype=getattr(
                torch, self.execution.dtype), device=self.device))

    def cache_info(self) -> dict:
        """Prepare-cache statistics (hits, builds, solves, entries)."""
        with self._lock:
            return dict(self.stats, entries=len(self._prepared))

    def forget(self, prepared: PreparedData) -> bool:
        """Evict one `PreparedData` from the prepare cache (thread-safe).
        The handle stays valid for callers holding it; only the cache entry
        (and the plan's active slot, if it points here) is dropped.
        Returns True when an entry was removed."""
        with self._lock:
            removed = self._prepared.pop(prepared.fingerprint,
                                         None) is not None
            if self._active is prepared:
                self._active = None
        return removed

    def _require(self, points) -> PreparedData:
        if points is not None:
            self.prepare(points)
        with self._lock:
            active = self._active
        if active is None:
            raise RuntimeError("no prepared data: call plan.prepare(points) "
                               "or plan.fit(points) first")
        return active

    # -- execute stage ------------------------------------------------------

    def fit(self, points=None, *, seed: Optional[int] = None) -> FitResult:
        """Seed (+ optional Lloyd) on `points`, or on the prepared data.

        With `seed` unset (or equal to the spec's) the prepare-time rng
        snapshot is replayed, so the solve takes the draw the JAX package's
        solve takes; another `seed` reseeds the solve stage only.
        """
        return self._execute(self._require(points), self.cluster.k, seed)

    def refit(self, *, k: Optional[int] = None,
              seed: Optional[int] = None) -> FitResult:
        """Re-run the solve stage on the already-prepared data: no host
        re-preparation.  The cpu backend's seeders build their tree and
        LSH structures and sample in one pass, so for them only the
        quantisation is cached and each refit rebuilds the rest."""
        with self._lock:
            active = self._active
        if active is None:
            raise RuntimeError("refit() needs a prior prepare()/fit(points)")
        return self._execute(active, k or self.cluster.k, seed)

    def fit_prepared(self, prepared: PreparedData, *,
                     k: Optional[int] = None,
                     seed: Optional[int] = None) -> FitResult:
        """Solve against an explicit `prepare_data` handle (no implicit
        active-data state, so the `ClusterEngine`'s solve worker calls it
        while other threads prepare); same seed semantics as `fit`."""
        # Keyed by fingerprint only (not the solve seed): retries of one
        # request hit the same key, so FaultPlan's per-key failure caps
        # model a transient fault that heals on re-attempt.
        self._fault_inject("solve", prepared.fingerprint)
        return self._execute(prepared, k or self.cluster.k, seed)

    def _solve_rng(self, prep: PreparedData,
                   seed: Optional[int]) -> np.random.Generator:
        rng = np.random.default_rng(
            self.cluster.seed if seed is None else seed)
        if seed is None or seed == self.cluster.seed:
            rng.bit_generator.state = prep.rng_state
        return rng

    def _execute(self, prep: PreparedData, k: int,
                 seed: Optional[int]) -> FitResult:
        t0 = time.perf_counter()
        with self._lock:
            self.stats["solves"] += 1
        rng = self._solve_rng(prep, seed)
        options = self.cluster.options_dict()
        options.pop("resolution", None)
        if prep.streaming is not None:
            idx, extras = self.impl.streaming.solve(
                prep.streaming, k, rng, c=self.cluster.c,
                schedule=self.cluster.schedule, options=options,
                execution=self.execution)
            return self._finish_streaming(prep, k, idx, extras, t0)
        if self.impl.preparable:
            idx, extras = self.impl.solve(
                prep.artifacts, prep.seed_pts, k, rng, c=self.cluster.c,
                schedule=self.cluster.schedule, options=options,
                execution=self.execution)
        else:
            # No cached split (the cpu seeders): the seed_fn with
            # capability-driven kwargs, as the legacy `fit` calls it.
            if prep.resolution is not None:
                options.setdefault("resolution", prep.resolution)
            if self.caps.accepts_c:
                options.setdefault("c", self.cluster.c)
            if self.caps.accepts_schedule and \
                    self.cluster.schedule is not None:
                options.setdefault("schedule", self.cluster.schedule)
            res = self.impl.run(prep.seed_pts, k, rng, **options)
            idx = torch.as_tensor(res.indices, dtype=torch.int32,
                                  device=self.device)
            extras = dict(res.extras)
            extras.setdefault("num_candidates", res.num_candidates)
        centers = prep.points_dev[idx.long()]
        if self.cluster.lloyd_iters > 0:
            host_idx = idx.cpu().numpy().astype(np.int64)
            refinement = lloyd(prep.pts, prep.pts[host_idx],
                               max_iters=self.cluster.lloyd_iters)
            centers = torch.as_tensor(refinement.centers,
                                      dtype=centers.dtype,
                                      device=centers.device)
            cost = torch.tensor(refinement.cost, dtype=torch.float32,
                                device=centers.device)
            extras = dict(extras, lloyd_iterations=refinement.iterations)
        else:
            cost = _cost_program(prep.points_dev, centers)
        return self._finish(idx, centers, cost, k, prep.prepare_seconds, t0,
                            extras)

    def _finish_streaming(self, prep: PreparedData, k: int, idx_raw,
                          extras: dict, t0: float) -> FitResult:
        """`_execute`'s gather and cost over a stream's current rows.

        Global row ids are stable (streams never compact), so the gather
        indexes the whole row block, rebuilt on the device when `n_rows`
        changed, and the cost masks the retired rows out.
        """
        state = prep.streaming
        idx = torch.as_tensor(idx_raw, dtype=torch.int32, device=self.device)
        with state.lock:
            n_rows = state.n_rows
            if prep.points_dev is None or \
                    prep.points_dev.shape[0] != n_rows:
                prep.points_dev = torch.as_tensor(
                    state.host_pts[:n_rows],
                    dtype=getattr(torch, self.execution.dtype),
                    device=self.device)
            pts_dev = prep.points_dev
            mask = state.live_mask_device()
        centers = pts_dev[idx.long()]
        if self.cluster.lloyd_iters > 0:
            host_idx = idx.cpu().numpy().astype(np.int64)
            refinement = lloyd(state.live_points(), state.host_pts[host_idx],
                               max_iters=self.cluster.lloyd_iters)
            centers = torch.as_tensor(refinement.centers,
                                      dtype=centers.dtype,
                                      device=centers.device)
            cost = torch.tensor(refinement.cost, dtype=torch.float32,
                                device=centers.device)
            extras = dict(extras, lloyd_iterations=refinement.iterations)
        else:
            cost = _cost_program(pts_dev, centers, mask)
        return self._finish(idx, centers, cost, k, prep.prepare_seconds, t0,
                            extras)

    # -- multi-problem execution --------------------------------------------

    def fit_batch(self, seeds: Optional[Sequence[int]] = None, points=None,
                  *, datasets: Optional[Sequence[Any]] = None) -> FitResult:
        """Solve B independent seeding problems; a `FitResult` with a
        leading batch axis on indices, centers and cost.

        * ``fit_batch(seeds)`` -- B seeds on ONE prepared dataset; lane i is
          bit-identical to `refit(seed=seeds[i])`.  On the device backend
          the device-native seeders (rejection, fastkmeans++: the impls
          with stacked lanes) run the B lanes as one `solve_stacked` over
          one copy of the artifacts
          (``extras["vmapped"]`` True, as the JAX package's one vmapped
          program reports it); k-means||, the cpu backend, a stream and
          ``lloyd_iters > 0`` loop over `refit` (``vmapped`` False).
          Nothing is re-prepared.
        * ``fit_batch(datasets=[...], seeds=None|[...])`` -- B different
          datasets (one optional seed each, default the spec's).  Where the
          impl `supports_stacked` and ``lloyd_iters == 0``, every dataset
          is canonically rescaled (an exact power-of-two factor into the
          unit ball: distance ratios, and so the D^2 law and the acceptance
          test, are preserved exactly), padded to a `shape_bucket` rung
          and prepare-cached, and the lanes of each bucket run as one
          lane-batched solve (`fit_batch_prepared`); lane i is
          bit-identical to ``fit_batch(datasets=[datasets[i]], ...)``.
          Otherwise each dataset is prepared and fitted in turn (the solo
          loop).  ``extras["stacked"]`` says which path ran.  All datasets
          share the feature dimension d; indices, centers and cost are per
          lane, in each dataset's ORIGINAL coordinates.
        """
        if datasets is not None:
            if points is not None:
                raise ValueError("pass either points= or datasets=, not both")
            return self._fit_batch_datasets(list(datasets), seeds)
        if seeds is None:
            raise ValueError("fit_batch() needs seeds (or datasets=...)")
        prep = self._require(points)
        seeds = [int(s) for s in seeds]
        if not seeds:
            raise ValueError("fit_batch() needs at least one seed")
        if self.impl.supports_stacked and self.cluster.lloyd_iters == 0 \
                and prep.streaming is None:
            return self._fit_batch_lanes(prep, seeds)
        return _stack_results([self.refit(seed=s) for s in seeds], seeds)

    def _fit_batch_lanes(self, prep: PreparedData,
                         seeds: list[int]) -> FitResult:
        """B seeds on one dataset as one lane-batched solve over one copy of
        its artifacts; lane i draws from a generator seeded as
        `refit(seed=seeds[i])`'s is."""
        from repro_torch.core.device_seeding import prepared_lane

        t0 = time.perf_counter()
        with self._lock:
            self.stats["solves"] += len(seeds)
        k = self.cluster.k
        idx, solved = self.impl.solve_stacked(
            [prepared_lane(prep.artifacts)] * len(seeds), k,
            [_lane_seed(self._solve_rng(prep, s)) for s in seeds],
            c=self.cluster.c, schedule=self.cluster.schedule,
            options=self.cluster.options_dict(), execution=self.execution)
        extras: dict = {"seeds": tuple(seeds), "vmapped": True}
        if "trials" in solved:
            extras["trials"] = solved["trials"]
        centers = prep.points_dev[idx.long()]            # (B, k, d)
        cost = torch.stack([_cost_program(prep.points_dev, c)
                            for c in centers])
        return self._finish(idx, centers, cost, k, prep.prepare_seconds, t0,
                            extras)

    @staticmethod
    def _finish(idx, centers, cost, k: int, prepare_seconds: float,
                t0: float, extras: dict) -> FitResult:
        if cost.is_cuda:        # solve_seconds covers the device work too
            torch.cuda.synchronize(cost.device)
        return FitResult(indices=idx, centers=centers, cost=cost, k=k,
                         prepare_seconds=prepare_seconds,
                         solve_seconds=time.perf_counter() - t0,
                         extras=extras)

    # -- multi-DATASET execution (stacked lanes) ----------------------------

    def _fit_batch_datasets(self, datasets: list,
                            seeds: Optional[Sequence[int]]) -> FitResult:
        if not datasets:
            raise ValueError("fit_batch(datasets=...) needs >= 1 dataset")
        b = len(datasets)
        seeds = ([int(s) for s in seeds] if seeds is not None
                 else [self.cluster.seed] * b)
        if len(seeds) != b:
            raise ValueError(f"got {len(seeds)} seeds for {b} datasets")
        if self.impl.supports_stacked and self.cluster.lloyd_iters == 0:
            preps = [self._prepare_cached(pts_i, stacked=True)
                     for pts_i in datasets]
            return self.fit_batch_prepared(preps, seeds=seeds)
        results = [self.fit_prepared(self.prepare_data(pts_i), seed=s)
                   for pts_i, s in zip(datasets, seeds)]
        out = _stack_results(results, seeds)
        out.extras["stacked"] = False
        return out

    def fit_batch_prepared(self, prepared: Sequence[PreparedData], *,
                           seeds: Optional[Sequence[int]] = None
                           ) -> FitResult:
        """Solve B stacked-prepared lanes (one lane-batched solve per shape
        bucket).

        The solve stage of ``fit_batch(datasets=...)`` against explicit
        `prepare_stacked` handles: no implicit state, no host re-prepare.
        Lane i of the stacked `FitResult` is bit-identical to
        ``fit_batch_prepared([prepared[i]], seeds=[seeds[i]])`` in the
        same shape bucket, whatever the other lanes.  `seeds` defaults to
        the spec seed per lane (the solo `refit` stream).  The JAX package
        pads each bucket's lane count to a power of two with copies of
        lane 0, so that its traced programs are reused; an eager solve has
        nothing to reuse, so the port runs the lanes as they are.
        """
        t0 = time.perf_counter()
        preps = list(prepared)
        if not preps:
            raise ValueError("fit_batch_prepared() needs >= 1 lane")
        seeds = ([int(s) for s in seeds] if seeds is not None
                 else [self.cluster.seed] * len(preps))
        if len(seeds) != len(preps):
            raise ValueError(
                f"got {len(seeds)} seeds for {len(preps)} lanes")
        if any(not hasattr(p.artifacts, "shape_key") for p in preps):
            raise ValueError(
                "fit_batch_prepared() needs prepare_stacked handles "
                "(got a solo prepare_data handle)")
        dims = {p.pts.shape[1] for p in preps}
        if len(dims) > 1:
            raise ValueError(
                f"stacked fit_batch needs one feature dimension, got {dims}")
        # One key per lane *composition*: retries of one lane hit the same
        # key, so FaultPlan per-key caps model healing transient faults.
        self._fault_inject("solve", "+".join(p.fingerprint for p in preps))
        with self._lock:
            self.stats["solves"] += len(seeds)
        k = self.cluster.k
        options = self.cluster.options_dict()
        options.pop("resolution", None)
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(preps):
            groups.setdefault(p.artifacts.shape_key, []).append(i)
        idx_lanes: list = [None] * len(preps)
        trials_lanes: dict[int, Any] = {}
        for members in groups.values():
            idx_g, extras_g = self.impl.solve_stacked(
                [preps[i].artifacts for i in members], k,
                [_lane_seed(self._solve_rng(preps[i], seeds[i]))
                 for i in members],
                c=self.cluster.c, schedule=self.cluster.schedule,
                options=options, execution=self.execution)
            for j, i in enumerate(members):
                idx_lanes[i] = idx_g[j]
                if "trials" in extras_g:
                    trials_lanes[i] = extras_g["trials"][j]
        centers = [p.points_dev[idx.long()] for p, idx in zip(preps,
                                                               idx_lanes)]
        costs = [_cost_program(p.points_dev, ctr)
                 for p, ctr in zip(preps, centers)]
        extras: dict = {
            "seeds": tuple(seeds), "stacked": True, "vmapped": True,
            "shape_buckets": len(groups), "donated": False,
            "lane_rows": tuple(p.artifacts.n_real for p in preps),
            "bucket_rows": tuple(p.artifacts.arrays[0].shape[-1]
                                 for p in preps),
        }
        if trials_lanes:
            extras["trials"] = torch.stack(
                [trials_lanes[i] for i in range(len(preps))])
        return self._finish(torch.stack(idx_lanes), torch.stack(centers),
                            torch.stack(costs), k,
                            float(sum(p.prepare_seconds for p in preps)), t0,
                            extras)


def _lane_seed(rng: np.random.Generator) -> int:
    """A lane's generator seed: the one draw the solo solve's `_generator`
    takes from the same solve rng."""
    return int(rng.integers(2 ** 31))


def _stack_results(results: list[FitResult], seeds: list[int]) -> FitResult:
    return FitResult(
        indices=torch.stack([r.indices for r in results]),
        centers=torch.stack([r.centers for r in results]),
        cost=torch.stack([r.cost for r in results]),
        k=results[0].k,
        prepare_seconds=results[0].prepare_seconds,
        solve_seconds=float(sum(r.solve_seconds for r in results)),
        extras={"seeds": tuple(seeds), "vmapped": False})
