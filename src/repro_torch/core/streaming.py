"""Online / streaming clustering: incremental extend/retire over a
prepared plan, drift-triggered reseeding, and dynamic k.

The port of the JAX package's `core/streaming.py`: native streams on the
``"cpu"`` and ``"device"`` backends, and the ``"sharded"`` backend's
fallback, which re-shards the live rows on the next solve instead of
patching.  The prepared artifacts become a *mutable stream* while every
statistical guarantee holds:

  * **Frozen pow2 quantisation.**  `prepare` fixes an exact power-of-two
    scale ``s = canonical_pow2_scale(points) / 2`` (mantissas untouched,
    so every distance ratio -- all that D^2 sampling and the Algorithm-4
    acceptance ratio consume -- is preserved bit for bit) and builds the
    trees in scaled space with the stacked lanes' canonical geometry
    (``max_dist=1.0``, a fixed resolution).  The halved scale leaves a 2x
    domain headroom, so later points inside the frozen grid domain are
    encoded against the frozen trees (`TreeEmbedding.point_codes` /
    `MonotoneLSH.hash_keys` on the new rows only) instead of re-embedding
    all n rows.

  * **Capacity padding + leaf-weight patching.**  The device tensors are
    padded to a `shape_bucket` capacity rung; extend writes columns,
    retire flips weights.  The base leaf weights ``w0`` (``m_init`` on
    live rows, 0 on retired and padding rows) and their coarse heap are
    patched on the touched tiles only, never re-fingerprinted.  The
    seeders take ``w0`` as their base weights: a row at weight 0 has no
    mass in the exact intra-tile cumsum and the sweeps keep it at 0
    (``min(0, d^2) = 0``), so it is never proposed and never perturbs a
    draw -- a refit after any extend/retire history draws the exact D^2
    law over the *live* set.

  * **Out-of-domain growth = correctness-preserving rebuild.**  A point
    outside the frozen grid domain cannot be encoded against the frozen
    shifts; the stream then rebuilds its embedding (new scale, new
    origin) over all rows with a logged reason, keeping the live mask and
    the leaf weights.

As in the JAX package, a streaming refit is law-identical but not
stream-identical to a from-scratch fit: the uniform first center is drawn
through the tree sampler over ``w0`` (exactly uniform on live rows), not
by `torch.randint`.  What IS bit-identical: ``prepare_streaming(A);
extend(B)`` against ``prepare_streaming(A + B)`` when B duplicates rows
of A (the same scale, origin and capacity).

The drift layer (`DriftDetector`, a cost-ratio EMA against the last full
fit), mini-batch refinement (`MiniBatchRefiner`, Sculley 2010) and
dynamic k (`split_merge_k` over the k-means|| oversampling rounds; bias
analysis Makarychev et al., arXiv:2010.14487) compose in
`StreamingController`: refine cheaply between refits, reseed only on
measured degradation.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.batch_schedule import shape_bucket
from repro_torch.core.device_seeding import (
    _generator,
    _pad_axis,
    canonical_pow2_scale,
    device_fast_kmeanspp,
    device_rejection_sampling,
    resolve_schedule,
)
from repro_torch.core.lsh import MonotoneLSH
from repro_torch.core.sample_tree import TiledSampleTree
from repro_torch.core.seeding import clustering_cost, kmeans_parallel
from repro_torch.core.tree_embedding import _num_levels, build_multitree
from repro_torch.kernels.ops import split_codes_u64

__all__ = [
    "StreamingOps",
    "StreamState",
    "DriftPolicy",
    "DriftDetector",
    "MiniBatchRefiner",
    "StreamingController",
    "split_merge_k",
]

logger = logging.getLogger("repro_torch.core.streaming")

# Streams share the stacked lanes' canonical geometry: trees are built in
# the frozen pow2-scaled space with a forced unit diameter bound, so the
# statics (scale, num_levels, m_init) depend only on d.
_STREAM_RESOLUTION = 2.0 ** -10


@dataclasses.dataclass(frozen=True)
class StreamingOps:
    """One backend's streaming implementation (`BackendImpl.streaming`).

    ``prepare(pts, rng, *, resolution, options, execution) -> StreamState``
    builds the mutable stream; ``extend(state, pts, *, execution)`` and
    ``retire(state, indices, *, execution)`` mutate it in place;
    ``solve(state, k, rng, *, c, schedule, options, execution) ->
    (indices, extras)`` draws k centers over the live rows.  ``native``
    is False for the sharded fallback, which re-shards on the next solve
    (with a logged reason) instead of patching artifacts in place.
    """

    prepare: Callable
    extend: Callable
    retire: Callable
    solve: Callable
    native: bool = True


@dataclasses.dataclass
class StreamState:
    """Mutable per-stream artifacts shared by the backend ops.

    Host truth: `host_pts` (original coordinates) and `host_scaled`
    (frozen pow2-scaled coordinates) in capacity-padded arrays, plus the
    `live` mask -- global row ids are stable across retire (rows are
    never compacted).  Device truth (device backend only): capacity-padded
    code/key/point tensors on `device` plus the patched `w0` leaf weights
    and their coarse `base_heap`.  The sharded fallback keeps the
    `artifacts` and `live_snapshot` of its last re-shard and a `dirty`
    flag.  All mutations hold `lock`.
    """

    seeder: str
    backend: str
    scale: float                      # frozen pow2 quantisation factor s
    tile: int
    capacity: int
    n_rows: int
    live: np.ndarray                  # (capacity,) bool
    host_pts: np.ndarray              # (capacity, d) f64, original units
    host_scaled: np.ndarray           # (capacity, d) f64, scaled units
    options: dict
    reseed_root: int                  # seeds deterministic rebuilds
    device: Any = "cpu"               # where the tensors and the mask live
    generation: int = 0
    rebuilds: int = 0
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    # --- device backend ---
    emb: Any = None                   # frozen MultiTreeEmbedding
    lsh: Any = None                   # frozen MonotoneLSH (rejection only)
    statics: tuple = ()               # (scale, num_levels, m_init)
    codes_lo: Any = None              # (T, H-1, capacity) int32
    codes_hi: Any = None
    keys_lo: Any = None               # (L, capacity) int32
    keys_hi: Any = None
    pts_scaled: Any = None            # (capacity, d) f32, solve space
    ts: Any = None                    # TiledSampleTree(capacity, tile)
    w0: Any = None                    # (n_pad,) f32 base leaf weights
    base_heap: Any = None             # patched coarse heap over w0
    mask_dev: Any = None              # (n_rows,) f32 live mask (lazy)
    # --- sharded fallback ---
    artifacts: Any = None
    live_snapshot: Any = None         # live_ids at the last (re-)shard
    dirty: bool = False

    @property
    def dim(self) -> int:
        """Ambient dimension d."""
        return int(self.host_pts.shape[1])

    @property
    def live_count(self) -> int:
        """Number of live (non-retired) rows."""
        return int(self.live[: self.n_rows].sum())

    def live_ids(self) -> np.ndarray:
        """Global ids of the live rows, ascending."""
        return np.flatnonzero(self.live[: self.n_rows])

    def live_points(self) -> np.ndarray:
        """Live rows in original coordinates (copy)."""
        return self.host_pts[self.live_ids()]

    def live_mask_device(self) -> torch.Tensor:
        """(n_rows,) f32 mask on `device` for the masked cost reduction."""
        if self.mask_dev is None or self.mask_dev.shape[0] != self.n_rows:
            self.mask_dev = torch.as_tensor(
                self.live[: self.n_rows], dtype=torch.float32,
                device=self.device)
        return self.mask_dev


def _capacity_for(n: int, tile: int) -> int:
    return shape_bucket(max(n, 1), min_bucket=max(1024, tile))


def _grow_host(a: np.ndarray, capacity: int) -> np.ndarray:
    out = np.zeros((capacity,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _pow2_half_scale(pts: np.ndarray) -> float:
    # Half the canonical factor: spread stays <= 0.5 per coordinate, so
    # the frozen grid domain [origin, origin + 1) has 2x headroom for
    # future points before an out-of-domain rebuild is forced.
    return canonical_pow2_scale(pts) * 0.5


def _scaled_options(options: dict, s: float) -> dict:
    """User options re-expressed in the frozen scaled space.

    `lsh_r` and `resolution` are lengths in original data units; points
    handed to the CPU seeders are pre-scaled by ``s``, so these scale with
    them (the stacked lanes' `lsh_r * s` rule).
    """
    out = dict(options)
    for key in ("lsh_r", "resolution"):
        if out.get(key) is not None:
            out[key] = float(out[key]) * s
    return out


def _patch_weights(state: StreamState, ids: np.ndarray,
                   value: float) -> None:
    """Set `w0[ids] = value` and fix the coarse heap on the touched tiles.

    A leaf scatter, the touched tiles' sums and one
    `SampleTreeTorch.scatter_update`, in place:
    O(|ids| + touched * (tile + log T)), never a full heap rebuild.  The
    weights are exact f32 integers (0 or ``m_init = 16 d``), so each tile
    sum is exact (at most ``tile * m_init``, below 2^24 for d < 2048 at
    tile 512), and `scatter_update` sets every touched ancestor to the
    sum of its children as `ts.init` computes it: the patched heap equals
    ``ts.init(w0)`` bit for bit at any size, even where the upper sums
    pass 2^24.
    """
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size == 0:
        return
    ts = state.ts
    dev = state.w0.device
    state.w0[torch.as_tensor(ids, device=dev)] = value
    touched = torch.as_tensor(np.unique(ids // state.tile), device=dev)
    tsums = state.w0.reshape(ts.num_tiles, state.tile)[touched].sum(dim=1)
    ts.coarse.scatter_update(state.base_heap, touched, tsums)


# ---------------------------------------------------------------------------
# Device backend: native extend/retire against frozen trees + LSH.
# ---------------------------------------------------------------------------

def _dev_statics(d: int) -> tuple:
    # build_multitree with max_dist=1.0 and the canonical resolution:
    # scale = 2 sqrt(d), H = 12, M = 16 d -- shared with the stacked lanes.
    return (2.0 * float(np.sqrt(d)),
            _num_levels(1.0, _STREAM_RESOLUTION),
            16.0 * d)


def _dev_build_embedding(state: StreamState, rng) -> None:
    """(Re)build the frozen embedding/LSH over rows 0..n_rows in scaled
    space and refresh the capacity-padded device tensors."""
    pts_scaled = state.host_scaled[: state.n_rows]
    emb = build_multitree(
        pts_scaled, seed=int(rng.integers(2 ** 31)),
        resolution=_STREAM_RESOLUTION, max_dist=1.0)
    state.emb = emb
    dev = state.device

    def upload(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, state.capacity - state.n_rows)
        return torch.from_numpy(np.ascontiguousarray(np.pad(a, pad))).to(dev)

    lo, hi = split_codes_u64(emb.codes_array()[:, 1:, :])   # (T, H-1, n)
    state.codes_lo, state.codes_hi = upload(lo, 2), upload(hi, 2)
    state.pts_scaled = torch.as_tensor(
        np.pad(pts_scaled, ((0, state.capacity - state.n_rows), (0, 0))),
        dtype=torch.float32, device=dev)
    if state.seeder == "rejection":
        opts = state.options
        lsh_r = opts.get("lsh_r")
        lsh_r = (float(lsh_r) * state.scale if lsh_r is not None
                 else 10.0 * _STREAM_RESOLUTION)
        lsh = MonotoneLSH(
            state.dim, r=lsh_r,
            num_tables=opts.get("num_tables", 15),
            hashes_per_table=opts.get("hashes_per_table", 1),
            seed=int(rng.integers(2 ** 31)), capacity=16)
        state.lsh = lsh
        klo, khi = split_codes_u64(lsh.hash_keys(pts_scaled))   # (n, L)
        state.keys_lo, state.keys_hi = upload(klo.T, 1), upload(khi.T, 1)


def _dev_prepare(pts, rng, *, resolution, options, execution) -> StreamState:
    """Streaming prepare (device): frozen pow2 scale + capacity padding."""
    pts = np.asarray(pts, dtype=np.float64)
    n, d = pts.shape
    tile = execution.tile
    capacity = _capacity_for(n, tile)
    s = _pow2_half_scale(pts)
    state = StreamState(
        seeder=options["_seeder"], backend="device", scale=s, tile=tile,
        capacity=capacity, n_rows=n,
        live=np.zeros(capacity, dtype=bool),
        host_pts=_grow_host(pts, capacity),
        host_scaled=_grow_host(pts * s, capacity),
        options={k: v for k, v in options.items() if k != "_seeder"},
        reseed_root=0, device=torch.device(execution.device))
    state.live[:n] = True
    state.statics = _dev_statics(d)
    _dev_build_embedding(state, rng)
    state.reseed_root = int(rng.integers(2 ** 31))
    ts = TiledSampleTree(capacity, tile=tile)
    state.ts = ts
    state.w0 = torch.zeros(ts.n_pad, dtype=torch.float32, device=state.device)
    state.w0[:n] = state.statics[2]                      # m_init
    state.base_heap = ts.init(state.w0)
    return state


def _dev_in_domain(state: StreamState, scaled: np.ndarray) -> bool:
    """True iff every new scaled row encodes against every frozen tree."""
    for tree in state.emb.trees:
        y = (scaled - tree.origin) + tree.shift
        if (y < 0.0).any() or (y >= 2.0 * tree.max_dist).any():
            return False
    return True


def _dev_grow_capacity(state: StreamState, need: int) -> None:
    """Move to the capacity rung that holds `need` rows: host arrays grow
    on the host, the device tensors are zero-padded on the device."""
    new_cap = _capacity_for(need, state.tile)
    if new_cap <= state.capacity:
        return
    state.host_pts = _grow_host(state.host_pts, new_cap)
    state.host_scaled = _grow_host(state.host_scaled, new_cap)
    state.live = _grow_host(state.live, new_cap)
    state.codes_lo = _pad_axis(state.codes_lo, 2, new_cap)
    state.codes_hi = _pad_axis(state.codes_hi, 2, new_cap)
    state.pts_scaled = _pad_axis(state.pts_scaled, 0, new_cap)
    if state.keys_lo is not None:
        state.keys_lo = _pad_axis(state.keys_lo, 1, new_cap)
        state.keys_hi = _pad_axis(state.keys_hi, 1, new_cap)
    ts = TiledSampleTree(new_cap, tile=state.tile)
    state.ts = ts
    state.w0 = _pad_axis(state.w0, 0, ts.n_pad)
    # Capacity growth re-bases the heap (a new tree shape): a rebuild.
    state.base_heap = ts.init(state.w0)
    state.capacity = new_cap


def _dev_extend(state: StreamState, pts, *, execution) -> None:
    """Append rows: encode against the frozen trees/LSH, write columns,
    patch leaf weights.  Out-of-domain rows force a logged full rebuild
    of the embedding (live mask and weights preserved)."""
    pts = np.asarray(pts, dtype=np.float64)
    b = pts.shape[0]
    if b == 0:
        return
    with state.lock:
        scaled = pts * state.scale
        rebuild = not _dev_in_domain(state, scaled)
        n0 = state.n_rows
        _dev_grow_capacity(state, n0 + b)
        state.host_pts[n0:n0 + b] = pts
        state.host_scaled[n0:n0 + b] = scaled
        state.live[n0:n0 + b] = True
        state.n_rows = n0 + b
        if rebuild:
            logger.warning(
                "stream extend: %d row(s) outside the frozen grid domain; "
                "rebuilding embedding over %d rows (reason=out-of-domain)",
                b, state.n_rows)
            s = _pow2_half_scale(state.host_pts[: state.n_rows])
            state.scale = s
            state.host_scaled[: state.n_rows] = (
                state.host_pts[: state.n_rows] * s)
            rng = np.random.default_rng(
                (state.reseed_root, state.generation))
            _dev_build_embedding(state, rng)
            state.rebuilds += 1
        else:
            dev = state.device
            codes = np.stack([t.point_codes(scaled)
                              for t in state.emb.trees])   # (T, H, b)
            lo, hi = split_codes_u64(codes[:, 1:, :])
            state.codes_lo[:, :, n0:n0 + b] = torch.from_numpy(lo).to(dev)
            state.codes_hi[:, :, n0:n0 + b] = torch.from_numpy(hi).to(dev)
            state.pts_scaled[n0:n0 + b] = torch.as_tensor(
                scaled, dtype=torch.float32, device=dev)
            if state.lsh is not None:
                klo, khi = split_codes_u64(state.lsh.hash_keys(scaled))
                state.keys_lo[:, n0:n0 + b] = torch.from_numpy(klo.T).to(dev)
                state.keys_hi[:, n0:n0 + b] = torch.from_numpy(khi.T).to(dev)
        _patch_weights(state, np.arange(n0, n0 + b), state.statics[2])
        state.mask_dev = None
        state.generation += 1


def _dev_retire(state: StreamState, indices, *, execution) -> None:
    """Retire rows by global id: zero their leaf weights (never sampled,
    never perturbing a draw) and drop them from the cost mask.  Columns
    stay in place -- ids are stable, extend-then-retire round-trips."""
    ids = np.asarray(indices, dtype=np.int64).ravel()
    if ids.size == 0:
        return
    with state.lock:
        _check_retire_ids(state, ids)
        state.live[ids] = False
        _patch_weights(state, ids, 0.0)
        state.mask_dev = None
        state.generation += 1


def _check_retire_ids(state: StreamState, ids: np.ndarray) -> None:
    if (ids < 0).any() or (ids >= state.n_rows).any():
        raise IndexError(
            f"retire ids out of range [0, {state.n_rows})")
    if not state.live[ids].all():
        dead = ids[~state.live[ids]]
        raise ValueError(f"rows already retired: {dead[:8].tolist()}")


def _dev_solve(state: StreamState, k, rng, *, c, schedule, options,
               execution):
    """Solve over the live rows: the device seeders with the stream's
    patched ``w0``/``base_heap`` as their base weights.  The one draw
    from `rng` seeds the generator, where the JAX package draws its key.
    The tensors are read under the lock, as one stream: `w0` and the heap
    are copied, since extend and retire patch them in place; the code,
    key and point columns a concurrent extend writes in place were
    padding at weight 0, which no solve reads, and a capacity growth
    replaces those tensors."""
    if k > state.live_count:
        raise ValueError(
            f"k={k} exceeds {state.live_count} live rows in stream")
    with state.lock:
        codes = (state.codes_lo, state.codes_hi)
        lsh = (state.pts_scaled, state.keys_lo, state.keys_hi)
        base = dict(w0=state.w0.clone(), base0=state.base_heap.clone())
        extras = {"streaming": True, "generation": state.generation,
                  "stream_rebuilds": state.rebuilds}
    scale, num_levels, m_init = state.statics
    gen = _generator(rng, state.device)
    if state.seeder == "rejection":
        sched = resolve_schedule(schedule, options.get("batch"))
        chosen, trials = device_rejection_sampling(
            *codes, *lsh, k, gen, scale=scale, num_levels=num_levels,
            m_init=m_init, c=c, schedule=sched,
            max_rounds=options.get("max_rounds", 32), tile=execution.tile,
            **base)
        extras.update(trials=trials, batch_buckets=sched.buckets())
        return chosen, extras
    chosen = device_fast_kmeanspp(
        *codes, k, gen, scale=scale, num_levels=num_levels, m_init=m_init,
        tile=execution.tile, **base)
    extras.update(num_candidates=k)
    return chosen, extras


# ---------------------------------------------------------------------------
# CPU backend: a host-side stream; solves run the NumPy seeders on the
# compacted live rows (scaled space).
# ---------------------------------------------------------------------------

def _cpu_prepare(pts, rng, *, resolution, options, execution) -> StreamState:
    """Streaming prepare (cpu): scaled host rows + live mask only -- the
    NumPy seeders rebuild their structures per solve, so there is nothing
    on a device to patch."""
    pts = np.asarray(pts, dtype=np.float64)
    n = pts.shape[0]
    tile = execution.tile
    capacity = _capacity_for(n, tile)
    s = _pow2_half_scale(pts)
    state = StreamState(
        seeder=options["_seeder"], backend="cpu", scale=s, tile=tile,
        capacity=capacity, n_rows=n,
        live=np.zeros(capacity, dtype=bool),
        host_pts=_grow_host(pts, capacity),
        host_scaled=_grow_host(pts * s, capacity),
        options={k: v for k, v in options.items() if k != "_seeder"},
        reseed_root=int(rng.integers(2 ** 31)),
        device=torch.device(execution.device))
    state.live[:n] = True
    return state


def _cpu_extend(state: StreamState, pts, *, execution) -> None:
    """Append rows in the frozen scaled space (host arrays only)."""
    pts = np.asarray(pts, dtype=np.float64)
    b = pts.shape[0]
    if b == 0:
        return
    with state.lock:
        n0 = state.n_rows
        new_cap = _capacity_for(n0 + b, state.tile)
        if new_cap > state.capacity:
            state.host_pts = _grow_host(state.host_pts, new_cap)
            state.host_scaled = _grow_host(state.host_scaled, new_cap)
            state.live = _grow_host(state.live, new_cap)
            state.capacity = new_cap
        state.host_pts[n0:n0 + b] = pts
        state.host_scaled[n0:n0 + b] = pts * state.scale
        state.live[n0:n0 + b] = True
        state.n_rows = n0 + b
        state.mask_dev = None
        state.generation += 1


def _cpu_retire(state: StreamState, indices, *, execution) -> None:
    """Retire rows by global id (host mask flip)."""
    ids = np.asarray(indices, dtype=np.int64).ravel()
    if ids.size == 0:
        return
    with state.lock:
        _check_retire_ids(state, ids)
        state.live[ids] = False
        state.mask_dev = None
        state.generation += 1


def _cpu_solve(state: StreamState, k, rng, *, c, schedule, options,
               execution):
    """Solve: run the NumPy seeder on the compacted live rows (stable
    global-id order) and map indices back through `live_ids`."""
    if k > state.live_count:
        raise ValueError(
            f"k={k} exceeds {state.live_count} live rows in stream")
    live_ids = state.live_ids()
    pts_live = state.host_scaled[live_ids]
    opts = _scaled_options({**state.options, **options}, state.scale)
    run = registry.SEEDER_SPECS[state.seeder].impl("cpu").run
    res = run(pts_live, k, rng, c=c, schedule=schedule, **opts)
    idx = live_ids[np.asarray(res.indices, dtype=np.int64)]
    extras = dict(res.extras)
    extras.update(streaming=True, generation=state.generation,
                  num_candidates=res.num_candidates)
    return idx, extras


# ---------------------------------------------------------------------------
# Sharded backend: the fallback -- no native patch path; mutations mark the
# stream dirty and the next solve re-shards the live rows.
# ---------------------------------------------------------------------------

def _sh_impl(state: StreamState):
    return registry.SEEDER_SPECS[state.seeder].impl("sharded")


def _sh_reshard(state: StreamState, *, execution) -> None:
    rng = np.random.default_rng((state.reseed_root, state.generation))
    live_ids = state.live_ids()
    opts = _scaled_options(state.options, state.scale)
    state.artifacts = _sh_impl(state).prepare(
        state.host_scaled[live_ids], rng, resolution=opts.get("resolution"),
        options=opts, execution=execution)
    state.live_snapshot = live_ids
    state.dirty = False


def _sh_prepare(pts, rng, *, resolution, options, execution) -> StreamState:
    """Streaming prepare (sharded): the host stream plus one first split
    onto the shards."""
    state = _cpu_prepare(pts, rng, resolution=resolution, options=options,
                         execution=execution)
    state.backend = "sharded"
    _sh_reshard(state, execution=execution)
    return state


def _mark_dirty(state: StreamState, what: str) -> None:
    with state.lock:
        if not state.dirty:
            logger.warning(
                "sharded backend has no native streaming %s: stream will "
                "re-shard %d live rows on next solve "
                "(reason=mesh-placed artifacts)", what, state.live_count)
        state.dirty = True


def _sh_extend(state: StreamState, pts, *, execution) -> None:
    """Fallback extend: a host append and the dirty flag (the shards'
    artifacts have no in-place patch path; re-shard on the next solve,
    logged once)."""
    pts = np.asarray(pts, dtype=np.float64)
    if pts.shape[0] == 0:
        return
    _cpu_extend(state, pts, execution=execution)
    _mark_dirty(state, "extend")


def _sh_retire(state: StreamState, indices, *, execution) -> None:
    """Fallback retire: a host mask flip and the dirty flag."""
    ids = np.asarray(indices, dtype=np.int64).ravel()
    if ids.size == 0:
        return
    _cpu_retire(state, ids, execution=execution)
    _mark_dirty(state, "retire")


def _sh_solve(state: StreamState, k, rng, *, c, schedule, options,
              execution):
    """Solve: re-shard if dirty (a generator from the stream's reseed root
    and generation), then the sharded solve over the snapshot's rows,
    mapped back to global ids."""
    if k > state.live_count:
        raise ValueError(
            f"k={k} exceeds {state.live_count} live rows in stream")
    with state.lock:
        if state.dirty or state.artifacts is None:
            _sh_reshard(state, execution=execution)
    live_ids = state.live_snapshot
    opts = _scaled_options({**state.options, **options}, state.scale)
    idx, extras = _sh_impl(state).solve(
        state.artifacts, state.host_scaled[live_ids], k, rng, c=c,
        schedule=schedule, options=opts, execution=execution)
    idx = live_ids[idx.cpu().numpy().astype(np.int64)]
    extras = dict(extras)
    extras.update(streaming=True, generation=state.generation,
                  resharded=True)
    return idx, extras


# ---------------------------------------------------------------------------
# Drift detection, mini-batch refinement, dynamic k.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """When to reseed: cost-ratio EMA vs the last full fit.

    ``threshold`` is the smoothed cost ratio above which drift is
    declared (1.25 = 25% degradation); ``ema`` the smoothing factor on
    the per-batch ratio (higher = reacts faster, noisier).
    """

    threshold: float = 1.25
    ema: float = 0.5


class DriftDetector:
    """Cost-ratio EMA drift detector (the reseed trigger).

    `observe_fit(cost)` anchors the baseline after a full refit;
    `observe(cost)` folds a fresh cost measurement into the EMA ratio
    and returns True when the smoothed ratio exceeds the policy
    threshold -- reseed only on measured degradation, never on a
    schedule.
    """

    def __init__(self, policy: Optional[DriftPolicy] = None):
        self.policy = policy or DriftPolicy()
        self.baseline: Optional[float] = None
        self.ratio: float = 1.0

    def observe_fit(self, cost: float) -> None:
        """Anchor the baseline at a full fit's cost; reset the ratio."""
        self.baseline = max(float(cost), 1e-300)
        self.ratio = 1.0

    def observe(self, cost: float) -> bool:
        """Fold one cost sample in; True = drift (reseed recommended)."""
        if self.baseline is None:
            return False
        a = self.policy.ema
        self.ratio = (1.0 - a) * self.ratio + a * (float(cost)
                                                   / self.baseline)
        return self.ratio > self.policy.threshold


class MiniBatchRefiner:
    """Mini-batch k-means center refinement (Sculley 2010).

    Between refits, each ingested batch nudges its nearest centers with
    per-center learning rate 1/count -- O(batch * k * d) per step, no
    full-data pass.  Centers drift toward the current distribution while
    the drift detector decides when a real reseed is warranted.
    """

    def __init__(self, centers: np.ndarray,
                 counts: Optional[np.ndarray] = None):
        self.centers = np.array(centers, dtype=np.float64)
        k = len(self.centers)
        self.counts = (np.zeros(k, dtype=np.int64) if counts is None
                       else np.asarray(counts, dtype=np.int64).copy())

    def step(self, batch: np.ndarray) -> np.ndarray:
        """One mini-batch pass; returns the refined centers (view)."""
        batch = np.asarray(batch, dtype=np.float64)
        if batch.size == 0:
            return self.centers
        d2 = ((batch[:, None, :] - self.centers[None, :, :]) ** 2).sum(-1)
        nearest = d2.argmin(axis=1)
        for j, x in zip(nearest, batch):
            self.counts[j] += 1
            eta = 1.0 / self.counts[j]
            self.centers[j] = (1.0 - eta) * self.centers[j] + eta * x
        return self.centers


def split_merge_k(points: np.ndarray, centers: np.ndarray, rng,
                  *, k_min: int = 1, k_max: Optional[int] = None,
                  split_factor: float = 2.0,
                  merge_factor: float = 0.25) -> np.ndarray:
    """Dynamic k: merge near-duplicate centers, split overloaded ones.

    Merging collapses center pairs closer than ``merge_factor`` times the
    median inter-center distance (count-weighted mean, down to `k_min`).
    Splitting targets the cluster with the largest cost share while it
    exceeds ``split_factor`` times the mean -- its two replacement centers
    come from the k-means|| oversampling rounds (`seeding.kmeans_parallel`
    over the cluster's members), up to `k_max`.  Returns the new (k', d)
    center array.
    """
    pts = np.asarray(points, dtype=np.float64)
    ctrs = np.array(centers, dtype=np.float64)
    k_max = len(ctrs) if k_max is None else int(k_max)

    def _assign():
        d2 = ((pts[:, None, :] - ctrs[None, :, :]) ** 2).sum(-1)
        a = d2.argmin(axis=1)
        return a, d2[np.arange(len(pts)), a]

    # Merge pass.
    while len(ctrs) > max(k_min, 1):
        cd2 = ((ctrs[:, None, :] - ctrs[None, :, :]) ** 2).sum(-1)
        iu = np.triu_indices(len(ctrs), k=1)
        if iu[0].size == 0:
            break
        pair = np.argmin(cd2[iu])
        i, j = iu[0][pair], iu[1][pair]
        med = np.median(np.sqrt(cd2[iu]))
        if np.sqrt(cd2[i, j]) >= merge_factor * max(med, 1e-300):
            break
        a, _ = _assign()
        wi, wj = max((a == i).sum(), 1), max((a == j).sum(), 1)
        ctrs[i] = (wi * ctrs[i] + wj * ctrs[j]) / (wi + wj)
        ctrs = np.delete(ctrs, j, axis=0)

    # Split pass.
    while len(ctrs) < k_max:
        a, d2min = _assign()
        cost = np.bincount(a, weights=d2min, minlength=len(ctrs))
        worst = int(np.argmax(cost))
        if cost[worst] <= split_factor * max(cost.mean(), 1e-300):
            break
        members = pts[a == worst]
        if len(members) < 2:
            break
        res = kmeans_parallel(members, 2, rng, rounds=2)
        ctrs = np.vstack([np.delete(ctrs, worst, axis=0), res.centers])
    return ctrs


class StreamingController:
    """Ties a streaming plan to the drift/refine/reseed policy.

    ``ingest(points)`` extends the stream, refines the centers with one
    mini-batch step, measures the clustering cost of the refined centers
    over the live rows, and -- only when the `DriftDetector` declares
    degradation -- triggers a cheap reseed (`fit_prepared` on the patched
    artifacts: solve-only, no re-prepare).  ``adapt_k()`` runs the
    split/merge pass and reports the suggested k.
    """

    def __init__(self, plan, points, *, seed: Optional[int] = None,
                 drift: Optional[DriftPolicy] = None):
        self.plan = plan
        self.prepared = plan.prepare_streaming(points)
        self.detector = DriftDetector(drift)
        self._base_seed = plan.cluster.seed if seed is None else int(seed)
        self.reseeds = 0
        self._take(plan.fit_prepared(self.prepared, seed=seed))

    def _take(self, result) -> None:
        """Adopt a fit: its centers, a fresh refiner and the baseline."""
        self.result = result
        self.centers = result.centers.cpu().numpy().astype(np.float64)
        self.refiner = MiniBatchRefiner(self.centers)
        self.detector.observe_fit(float(result.cost))

    def cost_now(self) -> float:
        """Clustering cost of the current centers over the live rows."""
        return float(clustering_cost(
            self.prepared.streaming.live_points(), self.centers))

    def ingest(self, points, *, retire=None) -> dict:
        """Extend (and optionally retire), refine, detect, maybe reseed."""
        self.plan.extend(points, prepared=self.prepared)
        if retire is not None and len(retire):
            self.plan.retire(retire, prepared=self.prepared)
        self.centers = self.refiner.step(points).copy()
        cost = self.cost_now()
        drifted = self.detector.observe(cost)
        if drifted:
            self.reseed()
        return {"cost": cost, "ratio": self.detector.ratio,
                "drifted": drifted, "reseeds": self.reseeds,
                "live": self.prepared.streaming.live_count}

    def reseed(self) -> None:
        """Cheap reseed: refit on the patched artifacts (solve-only)."""
        self.reseeds += 1
        seed = int(np.random.default_rng(
            (self._base_seed, self.reseeds)).integers(2 ** 31))
        self._take(self.plan.fit_prepared(self.prepared, seed=seed))

    def adapt_k(self, *, k_min: int = 1,
                k_max: Optional[int] = None) -> np.ndarray:
        """Split/merge pass over the live rows; returns new centers."""
        rng = np.random.default_rng(
            (self._base_seed, self.reseeds, self.prepared.streaming
             .generation))
        self.centers = split_merge_k(
            self.prepared.streaming.live_points(), self.centers, rng,
            k_min=k_min, k_max=k_max)
        return self.centers


# ---------------------------------------------------------------------------
# Registration: attach the ops to the already-registered BackendImpls.
# ---------------------------------------------------------------------------

_DEVICE_OPS = StreamingOps(prepare=_dev_prepare, extend=_dev_extend,
                           retire=_dev_retire, solve=_dev_solve)
_CPU_OPS = StreamingOps(prepare=_cpu_prepare, extend=_cpu_extend,
                        retire=_cpu_retire, solve=_cpu_solve)
_SHARDED_OPS = StreamingOps(prepare=_sh_prepare, extend=_sh_extend,
                            retire=_sh_retire, solve=_sh_solve, native=False)


def _attach() -> None:
    # The backend modules must have registered their impls first; the
    # facade (`core.api`) imports them before this module.
    for name in ("rejection", "fastkmeans++"):
        spec = registry.SEEDER_SPECS.get(name)
        if spec is None:
            continue
        for backend, ops in (("cpu", _CPU_OPS), ("device", _DEVICE_OPS),
                             ("sharded", _SHARDED_OPS)):
            impl = spec.impls.get(backend)
            if impl is not None and impl.streaming is None:
                spec.impls[backend] = dataclasses.replace(
                    impl, streaming=ops)


_attach()
