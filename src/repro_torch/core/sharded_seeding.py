"""Sharded seeders: Algorithms 3 and 4 and the k-means|| rounds over a
seeding mesh of D shards (`repro_torch.launch.mesh.SeedingMesh`).

Layout, as in the JAX package: every per-point array -- the multi-tree
codes (T, H-1, n), the coordinates (n, d), the LSH bucket keys (L, n) and
the D^2 weights -- is padded to a multiple of D x tile and cut into D
contiguous ranges of n_loc rows, shard s owning global rows
[s n_loc, (s + 1) n_loc).  Each shard keeps its own sub-heap (a
`TiledSampleTree` over its tiles, rebuilt from the last sweep's tile
sums), and the only replicated sampling state is the top tree: the D
shard totals.

Where the JAX package wraps each seeder in one `shard_map` program that
every device runs in lockstep, the port has one Python controller that
drives every shard in turn, on whatever device the shard lives (a device
may repeat, so D shards can share one card).  Its collectives are plain
tensor operations between the shards, on the controller's device (shard
0's):

  * the `all_gather` of the shard totals is a stack of D scalars;
  * the masked `psum` that publishes a value from its owner shard is a
    read of the owner's slice: a stack of the shards' gathers indexed by
    each draw's owner, or, where the owner is already known on the host,
    the owner's slice alone;
  * the `psum` of the totals is their sum, in shard order.

MULTITREESAMPLE runs shard-then-descend: a uniform on the controller picks
each draw's shard from the cumsum of the top tree, and each shard descends
its own sub-heap.  Opening a center copies the owner's code column to
every shard, and each shard sweeps its own points with `tree_sep_update`
(trees 0..T-2) and `tree_sep_update_tiles` (the last tree, whose tile sums
rebuild its sub-heap).  Algorithm 4 scores each round's block with one
`lsh_bucket_accept` launch on the controller and reads the round's outcome
in one device-to-host transfer, as the device backend does.  The k-means||
rounds draw each shard's coins, compact the round's picks of every shard
into one prefix of center slots, and refresh each shard's distances with
one `pairwise_argmin` launch over that prefix.

Draws come from one `torch.Generator` on the controller, seeded by the
solve stage's NumPy rng where the JAX package built its key; the JAX
package's jit-program cache (`program_cache_info`) and trace keys have no
counterpart, as `core.tracing` explains.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.batch_schedule import BatchSchedule
from repro_torch.core.device_seeding import (
    _FAR,
    _coin_picks,
    _generator,
    _pad_axis,
    _seed_fn,
    _uniform_index,
    prepare_embedding,
    prepare_rejection,
    resolve_schedule,
)
from repro_torch.core.sample_tree import TiledSampleTree
from repro_torch.core.seeding import SEEDERS, _candidate_pool_to_centers
from repro_torch.kernels import ops
from repro_torch.launch.mesh import SeedingMesh

__all__ = [
    "ShardedData",
    "shard_arrays",
    "sharded_data_from_arrays",
    "sharded_fast_kmeanspp",
    "sharded_rejection_sampling",
    "sharded_kmeans_parallel_rounds",
    "sharded_fast_kmeanspp_seeder",
    "sharded_rejection_seeder",
    "sharded_kmeans_parallel_seeder",
    "SHARDED_SEEDERS",
]

# The points axis of each per-point array.
_POINTS_AXIS = {"codes_lo": 2, "codes_hi": 2, "points": 0, "keys_lo": 1,
                "keys_hi": 1}


@dataclasses.dataclass(frozen=True)
class ShardedData:
    """Prepared artifacts split onto the shards of `mesh`: each per-point
    array is a tuple of D tensors of n_loc rows, tensor s on shard s's
    device.  An array the seeder does not use is an empty tuple.  The
    global rows at and past `n_real` are padding, at weight 0."""

    mesh: SeedingMesh
    tile: int
    n_real: int
    n_loc: int
    codes_lo: tuple = ()     # D x (T, H-1, n_loc) int32
    codes_hi: tuple = ()
    points: tuple = ()       # D x (n_loc, d) f32
    keys_lo: tuple = ()      # D x (L, n_loc) int32
    keys_hi: tuple = ()
    scale: float = 0.0       # the tree-distance statics, as in
    num_levels: int = 0      # `DeviceSeedingData`
    m_init: float = 0.0

    @property
    def controller(self) -> torch.device:
        """Where the replicated state lives and the draws are made."""
        return self.mesh.devices[0]


def _padded_for_mesh(n: int, mesh: SeedingMesh, tile: int) -> int:
    unit = mesh.size * tile
    return -(-n // unit) * unit


def shard_arrays(mesh: SeedingMesh, tile: int, n_real: int, *,
                 scale: float = 0.0, num_levels: int = 0,
                 m_init: float = 0.0, **arrays) -> ShardedData:
    """Cut each per-point array (named as `ShardedData`'s fields, with at
    least `n_real` rows) to its first `n_real` rows, zero-pad it to a
    multiple of D x tile and copy shard s's range to shard s's device:
    the counterpart of the JAX package's `_place`, done once at prepare."""
    n_pad = _padded_for_mesh(n_real, mesh, tile)
    n_loc = n_pad // mesh.size
    split = {}
    for name, a in arrays.items():
        axis = _POINTS_AXIS[name]
        a = _pad_axis(a.narrow(axis, 0, n_real), axis, n_pad)
        split[name] = tuple(
            a.narrow(axis, s * n_loc, n_loc).contiguous().to(dev)
            for s, dev in enumerate(mesh.devices))
    return ShardedData(mesh=mesh, tile=tile, n_real=n_real, n_loc=n_loc,
                       scale=float(scale), num_levels=int(num_levels),
                       m_init=float(m_init), **split)


def sharded_data_from_arrays(data, mesh: SeedingMesh, *,
                             n_real: Optional[int] = None,
                             tile: int = 512) -> ShardedData:
    """Split any object with (some of) `DeviceSeedingData`'s fields, as
    arrays NumPy can convert -- the JAX package's prepared, padded
    artifacts included -- onto the shards of `mesh`, so both packages'
    sharded solves can be fed the same artifacts.  `n_real` defaults to
    the arrays' row count."""
    dtypes = {"codes_lo": torch.int32, "codes_hi": torch.int32,
              "points": torch.float32, "keys_lo": torch.int32,
              "keys_hi": torch.int32}
    arrays = {}
    for name, dtype in dtypes.items():
        value = getattr(data, name, None)
        if value is not None:
            # A copy: the source arrays may be read-only views.
            arrays[name] = torch.tensor(np.asarray(value), dtype=dtype)
    if n_real is None:
        name, a = next(iter(arrays.items()))
        n_real = a.shape[_POINTS_AXIS[name]]
    return shard_arrays(mesh, tile, n_real,
                        scale=getattr(data, "scale", 0.0),
                        num_levels=getattr(data, "num_levels", 0),
                        m_init=getattr(data, "m_init", 0.0), **arrays)


# ---------------------------------------------------------------------------
# The shard-local pieces: sampler, owner broadcast, open, initial weights.
# ---------------------------------------------------------------------------

def _from_owners(parts: list, owner: torch.Tensor) -> torch.Tensor:
    """Row j of shard ``owner[j]``'s part: each shard's gather at its own
    local indices, stacked on the controller and indexed by owner (the
    masked psum)."""
    rows = torch.arange(owner.shape[0], device=owner.device)
    return torch.stack([p.to(owner.device) for p in parts])[owner, rows]


def _shard_sampler(data: ShardedData, ts_loc: TiledSampleTree):
    """Shard-then-descend MULTITREESAMPLE over the shards' sub-heaps.

    Returns ``sample(heaps, weights, generator, size) -> (x, owner, locs,
    total)``: `size` i.i.d. global indices x with P(x) = w_x / sum of all
    weights, their owner shards, every shard's local descent (shard s's
    indices on its device; entry j is x[j]'s local index where s owns
    it), and the sum of the shard totals.  Three uniform vectors are drawn
    on the controller: the shard of each draw (none on a one-shard mesh),
    then the tile and the position in the tile, which every shard descends
    with -- so one shard draws what the device backend's sampler draws.  A
    draw that rounds up to the total goes to the last shard with mass, so
    no zero-weight point is ever drawn.
    """
    ctrl = data.controller
    devices = data.mesh.devices
    shard_ids = torch.arange(len(devices), device=ctrl)

    def uniforms(generator, size):
        return torch.rand(size, generator=generator, dtype=torch.float32,
                          device=ctrl)

    def sample(heaps, weights, generator, size):
        totals = torch.stack([h[1].to(ctrl) for h in heaps])   # top tree
        csum = torch.cumsum(totals, dim=0)
        if len(devices) == 1:
            owner = torch.zeros(size, dtype=torch.int64, device=ctrl)
        else:
            u_shard = uniforms(generator, size)
            last = torch.where(totals > 0, shard_ids, 0).max()
            owner = torch.minimum(
                (csum[None, :] <= (u_shard * csum[-1])[:, None]).sum(dim=1),
                last)
        u_tile, u_leaf = uniforms(generator, size), uniforms(generator, size)
        locs = []
        for s, dev in enumerate(devices):
            lanes = torch.zeros(size, dtype=torch.int64, device=dev)
            locs.append(ts_loc.locate(heaps[s][None], weights[s][None],
                                      u_tile.to(dev), u_leaf.to(dev),
                                      [size], lanes))
        x = _from_owners(locs, owner) + owner * data.n_loc
        return x, owner, locs, csum[-1]

    return sample


def _broadcast_from_owner(data: ShardedData, x, *columns) -> list:
    """Per-point data of global index x from its owner shard, on the
    controller.  Each entry of `columns` is ``fn(shard, local index)``.
    For a host int the owner's slice is read alone; for a 0-d tensor on
    the controller (the owner unknown on the host, and a sync to learn
    it) every shard reads at x mod n_loc and the owner's value is kept."""
    ctrl = data.controller
    if isinstance(x, int):
        owner, x_loc = divmod(x, data.n_loc)
        return [fn(owner, x_loc).to(ctrl) for fn in columns]
    owner = x // data.n_loc
    x_loc = x % data.n_loc
    return [torch.stack([fn(s, x_loc.to(dev)).to(ctrl) for s, dev
                         in enumerate(data.mesh.devices)])[owner]
            for fn in columns]


def _make_local_open(data: ShardedData, ts_loc: TiledSampleTree):
    """Sharded MULTITREEOPEN: ``open_center(weights, col_lo, col_hi) ->
    (weights', heaps')``, the owner's code columns copied to every shard,
    each shard sweeping only its own points; the last tree's kernel emits
    the tile sums that rebuild the shard's sub-heap."""
    t = data.codes_lo[0].shape[0]
    sweep = dict(scale=data.scale, num_levels=data.num_levels)

    def open_center(weights, col_lo, col_hi):
        out_w, out_heaps = [], []
        for s, dev in enumerate(data.mesh.devices):
            lo, hi, w = data.codes_lo[s], data.codes_hi[s], weights[s]
            c_lo, c_hi = col_lo.to(dev), col_hi.to(dev)
            for ti in range(t - 1):
                w = ops.tree_sep_update(lo[ti], hi[ti], c_lo[ti], c_hi[ti],
                                        w, **sweep)
            w, tsums = ops.tree_sep_update_tiles(
                lo[t - 1], hi[t - 1], c_lo[t - 1], c_hi[t - 1], w,
                block_n=data.tile, **sweep)
            out_w.append(w)
            out_heaps.append(ts_loc.refresh(None, tsums))
        return out_w, out_heaps

    return open_center


def _init_weights(data: ShardedData) -> list:
    """Each shard's slice of the initial weights: the global padding tail
    (and only it) starts, and so stays, at weight 0."""
    out = []
    for s, dev in enumerate(data.mesh.devices):
        w = torch.zeros(data.n_loc, dtype=torch.float32, device=dev)
        w[: min(max(data.n_real - s * data.n_loc, 0), data.n_loc)] = \
            data.m_init
        out.append(w)
    return out


def _start(data: ShardedData):
    """(sub-heap layout, sampler, open_center, weights, heaps)."""
    ts_loc = TiledSampleTree(data.n_loc, tile=data.tile)
    weights = _init_weights(data)
    return (ts_loc, _shard_sampler(data, ts_loc),
            _make_local_open(data, ts_loc), weights,
            [ts_loc.init(w) for w in weights])


# ---------------------------------------------------------------------------
# The seeders.
# ---------------------------------------------------------------------------

def sharded_fast_kmeanspp(data: ShardedData, k: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Algorithm 3 over the mesh: (k,) int32 global indices on the
    controller.  Nothing syncs: the opened point stays on the card and its
    code columns reach the shards through `_broadcast_from_owner`."""
    _, sample, open_center, weights, heaps = _start(data)
    ctrl = data.controller
    chosen = []
    for i in range(k):
        if i == 0:
            x = torch.randint(0, data.n_real, (1,), generator=generator,
                              device=ctrl)[0]
        else:
            x = sample(heaps, weights, generator, 1)[0][0]
        weights, heaps = open_center(weights, *_broadcast_from_owner(
            data, x, lambda s, xl: data.codes_lo[s][:, :, xl],
            lambda s, xl: data.codes_hi[s][:, :, xl]))
        chosen.append(x)
    return torch.stack(chosen).to(torch.int32)


def sharded_rejection_sampling(
    data: ShardedData,
    k: int,
    generator: torch.Generator,
    *,
    c: float = 1.2,
    schedule: BatchSchedule | None = None,
    max_rounds: int = 32,
    round_log: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 4 over the mesh: ``(chosen (k,) int32, trials (k,)
    int32)`` on the controller, the algorithm of
    `device_seeding.stacked_rejection_sampling` for one dataset.

    Each round draws its block shard-then-descend, ships each candidate's
    coordinates, current weight and bucket keys from its owner shard to
    the controller, scores the block with one `lsh_bucket_accept` launch
    there, and reads the outcome -- whether the shards hold any mass (the
    sum of their totals > 0), whether and where a candidate accepted, how
    many accepted -- in the round's one device-to-host transfer.  The
    block size follows the adaptive `schedule`, sized at the start from
    the live rows and a shard's tile count, as in the JAX package.
    `round_log`, when given, receives the block size of every round.
    """
    ts_loc, sample, open_center, weights, heaps = _start(data)
    ctrl = data.controller
    c2 = float(c) ** 2
    schedule = schedule if schedule is not None else BatchSchedule()
    buckets = schedule.buckets()
    b_idx = schedule.index_of(schedule.initial(data.n_real, k,
                                               ts_loc.num_tiles))
    acc_ema = schedule.prior_accept
    n_tables, d = data.keys_lo[0].shape[0], data.points[0].shape[1]
    # One slot per center; the accept kernel reads only the first i.
    ctr_pts = torch.full((k, d), _FAR, dtype=torch.float32, device=ctrl)
    ck_lo = torch.zeros((n_tables, k), dtype=torch.int32, device=ctrl)
    ck_hi = torch.zeros((n_tables, k), dtype=torch.int32, device=ctrl)
    chosen, trials = [], []
    for i in range(k):
        x, t_i = None, 0
        for _ in range(max_rounds if i > 0 else 0):
            bj = buckets[b_idx]
            cand, owner, locs, total = sample(heaps, weights, generator, bj)
            us = torch.rand(bj, generator=generator, dtype=torch.float32,
                            device=ctrl)
            q = _from_owners([data.points[s][loc]
                              for s, loc in enumerate(locs)], owner)
            mtd2 = _from_owners([weights[s][loc]
                                 for s, loc in enumerate(locs)], owner)
            q_lo, q_hi = (
                _from_owners([keys[s][:, loc].T for s, loc
                              in enumerate(locs)], owner).T.contiguous()
                for keys in (data.keys_lo, data.keys_hi))
            _, p_acc = ops.lsh_bucket_accept(q_lo, q_hi, q, ck_lo, ck_hi,
                                             ctr_pts, mtd2, i, c2=c2)
            acc = us < p_acc
            hit = torch.argmax(acc.to(torch.int32))          # first accept
            # The round's one device-to-host transfer.
            live, any_acc, hit, n_acc, x_hit, x_first = torch.stack([
                (total > 0).long(), acc.any().long(), hit,
                acc.sum(), cand[hit], cand[0]]).tolist()
            if not live:         # all weights 0: the uniform draw opens
                break
            if round_log is not None:
                round_log.append(bj)
            t_i += hit + 1 if any_acc else bj
            acc_ema = schedule.update_rate(acc_ema, n_acc / bj)
            b_idx = schedule.next_index(b_idx, acc_ema)
            x = x_hit if any_acc else x_first     # cand[0]: exhaustion
            if any_acc:
                break
        if x is None:
            x = _uniform_index(data.n_real, generator, ctrl)
        chosen.append(x)
        trials.append(max(t_i, 1))
        col_lo, col_hi, x_pt, xk_lo, xk_hi = _broadcast_from_owner(
            data, x, lambda s, xl: data.codes_lo[s][:, :, xl],
            lambda s, xl: data.codes_hi[s][:, :, xl],
            lambda s, xl: data.points[s][xl],
            lambda s, xl: data.keys_lo[s][:, xl],
            lambda s, xl: data.keys_hi[s][:, xl])
        weights, heaps = open_center(weights, col_lo, col_hi)
        ctr_pts[i] = x_pt
        ck_lo[:, i] = xk_lo
        ck_hi[:, i] = xk_hi
    return (torch.tensor(chosen, dtype=torch.int32, device=ctrl),
            torch.tensor(trials, dtype=torch.int32, device=ctrl))


def sharded_kmeans_parallel_rounds(data: ShardedData, ell: float,
                                   generator: torch.Generator, *,
                                   rounds: int,
                                   cap_loc: int) -> torch.Tensor:
    """k-means|| oversampling rounds over the mesh: (n_pad,) bool picks on
    the controller.

    The first point is a uniform draw over the live rows.  Per round the
    controller draws every shard's coins, one uniform a row; each shard
    keeps its first `cap_loc` wanted rows in index order and drops the
    rest, as `device_kmeans_parallel_rounds` does (the total `phi` is the
    sum over every shard).  The shards' picks are compacted into one
    prefix of center slots, `_FAR` past it, and each shard refreshes its
    distances with one `pairwise_argmin` launch over that prefix (and the
    first far slot).  Padding rows keep distance 0 and are never picked.
    """
    ctrl = data.controller
    devices = data.mesh.devices
    n_loc = data.n_loc
    gids = [torch.arange(n_loc, device=dev) + s * n_loc
            for s, dev in enumerate(devices)]
    live = [g < data.n_real for g in gids]
    x0 = _uniform_index(data.n_real, generator, ctrl)
    (x_pt,) = _broadcast_from_owner(data, x0,
                                    lambda s, xl: data.points[s][xl])
    d2 = [torch.where(live[s], ((data.points[s] - x_pt.to(dev)) ** 2)
                      .sum(dim=1), 0.0) for s, dev in enumerate(devices)]
    sel = [g == x0 for g in gids]
    for _ in range(rounds):
        phi = torch.stack([t.sum().to(ctrl) for t in d2]).sum()
        coins = torch.rand((len(devices), n_loc), generator=generator,
                           dtype=torch.float32, device=ctrl)
        slots, counts = [], []
        for s, dev in enumerate(devices):
            picked, block, count = _coin_picks(
                data.points[s], d2[s], phi.to(dev), coins[s].to(dev), ell,
                cap_loc)
            sel[s] |= picked
            slots.append(block.to(ctrl))
            counts.append(count.to(ctrl))
        # One prefix of every shard's picks, in shard order, far slots after.
        counts = torch.stack(counts)
        valid = (torch.arange(cap_loc, device=ctrl)[None, :]
                 < counts[:, None]).reshape(-1)
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        centers = torch.cat(slots)[order]
        count = counts.sum().to(torch.int32)
        for s, dev in enumerate(devices):
            dmin, _ = ops.pairwise_argmin(data.points[s], centers.to(dev),
                                          count.to(dev))
            d2[s] = torch.where(live[s], torch.minimum(d2[s], dmin), 0.0)
    return torch.cat([picks.to(ctrl) for picks in sel])


# ---------------------------------------------------------------------------
# Cached prepare/solve split for `core.plan.ClusterPlan`, with the rng-draw
# contract of the device adapters: prepare takes exactly the draws the JAX
# package's sharded prepare takes, and splits the padded artifacts onto the
# shards once (refits reuse them); solve draws the generator seed where the
# JAX package drew its key, then the k-means|| recluster's draws.
# ---------------------------------------------------------------------------

def _prep_fastkmeanspp_sh(pts, rng, *, resolution, options, execution):
    lo, hi, meta = prepare_embedding(pts, seed=int(rng.integers(2 ** 31)),
                                     resolution=resolution, device="cpu")
    return shard_arrays(execution.mesh, execution.tile, len(pts),
                        codes_lo=lo, codes_hi=hi, **meta)


def _solve_fastkmeanspp_sh(data, pts, k, rng, *, c, schedule, options,
                           execution):
    chosen = sharded_fast_kmeanspp(data, k,
                                   _generator(rng, data.controller))
    return chosen.to(execution.device), {"num_candidates": k,
                                         "devices": data.mesh.size}


def _prep_rejection_sh(pts, rng, *, resolution, options, execution):
    data = prepare_rejection(
        pts, seed=int(rng.integers(2 ** 31)), resolution=resolution,
        lsh_r=options.get("lsh_r"), num_tables=options.get("num_tables", 15),
        hashes_per_table=options.get("hashes_per_table", 1), device="cpu")
    return shard_arrays(
        execution.mesh, execution.tile, len(pts), codes_lo=data.codes_lo,
        codes_hi=data.codes_hi, points=data.points, keys_lo=data.keys_lo,
        keys_hi=data.keys_hi, scale=data.scale, num_levels=data.num_levels,
        m_init=data.m_init)


def _solve_rejection_sh(data, pts, k, rng, *, c, schedule, options,
                        execution):
    sched = resolve_schedule(schedule, options.get("batch"))
    rounds: list[int] = []
    chosen, trials = sharded_rejection_sampling(
        data, k, _generator(rng, data.controller), c=c, schedule=sched,
        max_rounds=options.get("max_rounds", 32), round_log=rounds)
    return chosen.to(execution.device), {
        "trials": trials, "num_candidates": int(trials.sum()),
        "batch_buckets": sched.buckets(),
        "rounds_per_batch": dict(collections.Counter(rounds)),
        "devices": data.mesh.size}


def _prep_kmeans_parallel_sh(pts, rng, *, resolution, options, execution):
    return shard_arrays(execution.mesh, execution.tile, len(pts),
                        points=torch.as_tensor(pts, dtype=torch.float32))


def _solve_kmeans_parallel_sh(data, pts, k, rng, *, c, schedule, options,
                              execution):
    rounds = options.get("rounds", 5)
    oversample = options.get("oversample")
    ell = float(oversample) if oversample is not None else 2.0 * k
    # Per-shard pick cap, the JAX package's: rows are sharded in index
    # order, so one shard may hold nearly all the D^2 mass and draw about
    # ell picks in a round; 2 ell covers that.
    cap_loc = int(min(data.n_loc, max(8, 2 * ell)))
    sel = sharded_kmeans_parallel_rounds(
        data, ell, _generator(rng, data.controller), rounds=rounds,
        cap_loc=cap_loc)
    cand = np.flatnonzero(sel[: data.n_real].cpu().numpy())
    idx, pool = _candidate_pool_to_centers(pts, cand, k, rng)
    return (torch.as_tensor(idx, dtype=torch.int32, device=execution.device),
            {"pool_size": pool, "num_candidates": pool, "rounds": rounds,
             "oversample": ell, "devices": data.mesh.size})


# The seed_fn facades (`"<name>/sharded"` in the legacy `SEEDERS`): `mesh`
# places the shards (default `make_seeding_mesh(device=device)`).
sharded_fast_kmeanspp_seeder = _seed_fn("fastkmeans++", "sharded")
sharded_rejection_seeder = _seed_fn("rejection", "sharded")
sharded_kmeans_parallel_seeder = _seed_fn("kmeans||", "sharded")

SHARDED_SEEDERS = {
    "fastkmeans++": sharded_fast_kmeanspp_seeder,
    "rejection": sharded_rejection_seeder,
    "kmeans||": sharded_kmeans_parallel_seeder,
}


def _register():
    # As in the JAX package: no stacked lanes (fit_batch loops refits), and
    # k-means|| is not device-native (its recluster runs on the host).
    for name, prepare, solve, native in (
            ("fastkmeans++", _prep_fastkmeanspp_sh, _solve_fastkmeanspp_sh,
             True),
            ("rejection", _prep_rejection_sh, _solve_rejection_sh, True),
            ("kmeans||", _prep_kmeans_parallel_sh, _solve_kmeans_parallel_sh,
             False)):
        registry.register_backend(name, "sharded", registry.BackendImpl(
            run=SHARDED_SEEDERS[name], prepare=prepare, solve=solve,
            device_native=native), legacy_registry=SEEDERS)


_register()
