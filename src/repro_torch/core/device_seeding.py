"""Device seeders: the paper's Algorithms 3 and 4, and the k-means||
baseline, on one card.

The pointer-machine structures become tensors, as in the JAX package:
  - the multi-tree embedding is a (trees, H-1, n) int32x2 code tensor built
    on the host once (NumPy, bit-identical to the JAX package's);
  - MULTITREEOPEN is the `tree_sep_update` kernel per tree; the last tree's
    sweep is the `_tiles` variant, whose epilogue emits per-tile weight sums;
  - MULTITREESAMPLE is the two-level `TiledSampleTree` descent; after each
    opened center its coarse heap is rebuilt from those T tile sums (O(T),
    no pass over the n weights);
  - the monotone LSH of Algorithm 4 is a (L, n) int32x2 bucket-key tensor
    plus the `lsh_bucket_accept` kernel: nearest colliding opened center per
    candidate, with the acceptance probability in its epilogue;
  - the k-means|| oversampling rounds refresh every point's distance to the
    round's picks with one `pairwise_argmin` launch per round; the weighted
    recluster of the pool stays on the host in float64, as in the JAX
    package.

Where the JAX package runs the k-center loop as one device program
(`fori_loop` / `while_loop` / `lax.switch`), the port runs it as a host
loop over eager PyTorch ops: each rejection round syncs once, reading
whether the coarse heap has mass, whether and where a candidate accepted,
and how many accepted, in one transfer.  The block size follows the same
adaptive `BatchSchedule` ladder; the rate EMA and the bucket index are
Python numbers carried across rounds and centers.

Draws come from one explicit `torch.Generator` on the tensors' device,
seeded from the solve stage's NumPy rng where the JAX package built its
`jax.random.key`; Philox cannot replay threefry, so the port matches the
reference in law, not in indices.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.batch_schedule import BatchSchedule
from repro_torch.core.lsh import MonotoneLSH
from repro_torch.core.plan import ExecutionSpec
from repro_torch.core.sample_tree import TiledSampleTree
from repro_torch.core.seeding import (
    SEEDERS,
    SeedingResult,
    _candidate_pool_to_centers,
    _estimate_scale,
)
from repro_torch.core.tree_embedding import build_multitree
from repro_torch.kernels import ops

__all__ = [
    "device_fast_kmeanspp",
    "device_rejection_sampling",
    "device_kmeans_parallel_rounds",
    "device_fast_kmeanspp_seeder",
    "device_rejection_seeder",
    "device_kmeans_parallel_seeder",
    "DEVICE_SEEDERS",
    "prepare_embedding",
    "prepare_rejection",
    "seeding_data_from_arrays",
    "DeviceSeedingData",
    "resolve_schedule",
]

_FAR = 1.0e17        # "no center yet" coordinate sentinel (f32-finite d2)


def prepare_embedding(points: np.ndarray, *, seed: int = 0,
                      resolution: Optional[float] = None,
                      max_dist: Optional[float] = None, device="cuda"):
    """Host-side MULTITREEINIT -> (codes_lo, codes_hi, meta).

    The codes are (T, H-1, n) int32 planes on `device` (the trivial root
    level dropped); `meta` holds `scale` = 2 sqrt(d) MaxDist, `num_levels`
    H and `m_init` = 16 d MaxDist^2.
    """
    emb = build_multitree(points, seed=seed, resolution=resolution,
                          max_dist=max_dist)
    codes = emb.codes_array()[:, 1:, :]            # (T, H-1, n)
    lo, hi = ops.split_codes_u64(codes)
    meta = {
        "scale": 2.0 * np.sqrt(emb.dim) * emb.max_dist,
        "num_levels": emb.num_levels,
        "m_init": emb.dist_upper_bound_sq,
    }
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            meta)


@dataclasses.dataclass(frozen=True)
class DeviceSeedingData:
    """Device tensors + scalars for `device_rejection_sampling`."""

    codes_lo: torch.Tensor   # (T, H-1, n) int32 — multi-tree cell codes
    codes_hi: torch.Tensor
    points: torch.Tensor     # (n, d) f32 — coordinates (acceptance distances)
    keys_lo: torch.Tensor    # (L, n) int32 — LSH bucket keys, low plane
    keys_hi: torch.Tensor
    scale: float             # 2 sqrt(d) MaxDist — tree-distance closed form
    num_levels: int          # H
    m_init: float            # M = 16 d MaxDist^2


def prepare_rejection(points: np.ndarray, *, seed: int = 0,
                      resolution: Optional[float] = None,
                      lsh_r: Optional[float] = None, num_tables: int = 15,
                      hashes_per_table: int = 1,
                      max_dist: Optional[float] = None,
                      device="cuda") -> DeviceSeedingData:
    """Host-side init of Algorithm 4's two structures, uploaded to `device`.

    Draws from a generator seeded with `seed` in the JAX package's order —
    the embedding seed, the LSH radius estimate (when `lsh_r` and
    `resolution` are unset), then the LSH seed — so every artifact is
    bit-identical to its `prepare_rejection`.  The keys of all n points are
    precomputed: opening a center copies one column.
    """
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    rng = np.random.default_rng(seed)
    lo, hi, meta = prepare_embedding(
        pts, seed=int(rng.integers(2 ** 31)), resolution=resolution,
        max_dist=max_dist, device=device)
    if lsh_r is None:
        lsh_r = 10.0 * (resolution or _estimate_scale(pts, rng))
    lsh = MonotoneLSH(d, r=lsh_r, num_tables=num_tables,
                      hashes_per_table=hashes_per_table,
                      seed=int(rng.integers(2 ** 31)))
    klo, khi = ops.split_codes_u64(lsh.hash_keys(pts))      # (n, L) planes
    return DeviceSeedingData(
        codes_lo=lo, codes_hi=hi,
        points=torch.as_tensor(pts, dtype=torch.float32, device=device),
        keys_lo=torch.from_numpy(np.ascontiguousarray(klo.T)).to(device),
        keys_hi=torch.from_numpy(np.ascontiguousarray(khi.T)).to(device),
        scale=meta["scale"], num_levels=meta["num_levels"],
        m_init=meta["m_init"])


def seeding_data_from_arrays(data, device="cuda") -> DeviceSeedingData:
    """Carry any object with `DeviceSeedingData`'s fields, as arrays NumPy
    can convert (the JAX package's `DeviceSeedingData` included), across
    into the port's, so both packages can be fed the same artifacts."""
    def to(name, dtype):
        # A copy: the source arrays may be read-only views.
        return torch.tensor(np.asarray(getattr(data, name)), dtype=dtype,
                            device=device)

    return DeviceSeedingData(
        codes_lo=to("codes_lo", torch.int32),
        codes_hi=to("codes_hi", torch.int32),
        points=to("points", torch.float32),
        keys_lo=to("keys_lo", torch.int32), keys_hi=to("keys_hi", torch.int32),
        scale=float(data.scale), num_levels=int(data.num_levels),
        m_init=float(data.m_init))


def _pad_axis(a: torch.Tensor, axis: int, n_pad: int) -> torch.Tensor:
    """Zero-pad one axis to `n_pad`."""
    pad = n_pad - a.shape[axis]
    if pad <= 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _make_open_center(codes_lo, codes_hi, *, scale, num_levels, tile):
    """Per-center sweep over all trees; the last tree's kernel emits the
    per-tile weight sums the coarse heap update consumes.  `x` is the
    opened point's index (a Python int): its code column is passed as a
    strided view, so no gather runs."""
    t = codes_lo.shape[0]

    def open_center(weights, x: int):
        for ti in range(t - 1):
            weights = ops.tree_sep_update(
                codes_lo[ti], codes_hi[ti], codes_lo[ti, :, x],
                codes_hi[ti, :, x], weights, scale=scale,
                num_levels=num_levels)
        return ops.tree_sep_update_tiles(
            codes_lo[t - 1], codes_hi[t - 1], codes_lo[t - 1, :, x],
            codes_hi[t - 1, :, x], weights, scale=scale,
            num_levels=num_levels, block_n=tile)

    return open_center


def _initial_state(codes_lo, codes_hi, *, scale, num_levels, m_init, tile):
    """(sampler, open_center, weights0, coarse0) over the tile-padded codes:
    live rows start at `m_init`, padded rows at 0 (never sampled)."""
    n = codes_lo.shape[2]
    ts = TiledSampleTree(n, tile=tile)
    open_center = _make_open_center(
        _pad_axis(codes_lo, 2, ts.n_pad), _pad_axis(codes_hi, 2, ts.n_pad),
        scale=scale, num_levels=num_levels, tile=tile)
    weights = torch.zeros(ts.n_pad, dtype=torch.float32,
                          device=codes_lo.device)
    weights[:n] = m_init
    return ts, open_center, weights, ts.init(weights)


def _uniform_index(n: int, generator: torch.Generator, device) -> int:
    return int(torch.randint(0, n, (1,), generator=generator, device=device))


def device_fast_kmeanspp(codes_lo: torch.Tensor, codes_hi: torch.Tensor,
                         k: int, generator: torch.Generator, *, scale: float,
                         num_levels: int, m_init: float,
                         tile: int = 512) -> torch.Tensor:
    """Algorithm 3 (D^2 sampling in the multi-tree metric).  Returns (k,)
    int32 chosen indices on the codes' device.

    Per opened center the sample structure is fixed incrementally: the last
    tree sweep's tile sums feed one `TiledSampleTree.refresh`.
    """
    n = codes_lo.shape[2]
    dev = codes_lo.device
    ts, open_center, weights, coarse = _initial_state(
        codes_lo, codes_hi, scale=scale, num_levels=num_levels,
        m_init=m_init, tile=tile)
    chosen = []
    for i in range(k):
        if i == 0:
            x = _uniform_index(n, generator, dev)
        else:
            x = int(ts.sample(coarse, weights, generator, 1)[0])
        weights, tsums = open_center(weights, x)
        coarse = ts.refresh(coarse, tsums)
        chosen.append(x)
    return torch.tensor(chosen, dtype=torch.int32, device=dev)


def device_rejection_sampling(
    codes_lo: torch.Tensor,     # (T, H-1, n) int32
    codes_hi: torch.Tensor,
    points: torch.Tensor,       # (n, d) f32
    keys_lo: torch.Tensor,      # (L, n) int32
    keys_hi: torch.Tensor,
    k: int,
    generator: torch.Generator,
    *,
    scale: float,
    num_levels: int,
    m_init: float,
    c: float = 1.2,
    schedule: BatchSchedule | None = None,
    max_rounds: int = 32,
    tile: int = 512,
    round_log: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 4 (REJECTIONSAMPLING).  Returns ``(chosen (k,) int32,
    trials (k,) int32)`` on the codes' device.

    Per center, rounds of batched speculative rejection: draw a block of
    i.i.d. candidates from the current multi-tree D^2 law plus uniforms,
    compute every candidate's acceptance probability
    ``d2_lsh / (c^2 * mtd2)`` with one `lsh_bucket_accept` launch over the
    opened centers, and open the first accept (the rest of the block is
    discarded, which keeps the sequential law exactly).  A complete LSH miss
    always accepts.  After `max_rounds` rounds without an accept, the first
    candidate of the last block — an exact multi-tree D^2 draw — opens.
    The first center, and any center while all weights are 0, is a uniform
    draw.  `trials` counts the candidates each center consumed (at least 1).
    `round_log`, when given, receives the block size of every round.
    """
    n = codes_lo.shape[2]
    dev = codes_lo.device
    l, d = keys_lo.shape[0], points.shape[1]
    c2 = float(c) ** 2
    schedule = schedule if schedule is not None else BatchSchedule()
    buckets = schedule.buckets()
    ts, open_center, weights, coarse = _initial_state(
        codes_lo, codes_hi, scale=scale, num_levels=num_levels,
        m_init=m_init, tile=tile)
    b_idx = schedule.index_of(schedule.initial(n, k, ts.num_tiles))
    acc_ema = schedule.prior_accept
    pts_pad = _pad_axis(points, 0, ts.n_pad)
    klo_pad = _pad_axis(keys_lo, 1, ts.n_pad)
    khi_pad = _pad_axis(keys_hi, 1, ts.n_pad)

    # One slot per center; the accept kernel reads only the first i (the
    # opened ones), so the buffers need no padding.
    ctr_pts = torch.full((k, d), _FAR, dtype=torch.float32, device=dev)
    ck_lo = torch.zeros((l, k), dtype=torch.int32, device=dev)
    ck_hi = torch.zeros((l, k), dtype=torch.int32, device=dev)
    chosen, trials = [], []
    for i in range(k):
        x, t_i = None, 0
        for _ in range(max_rounds if i > 0 else 0):
            bj = buckets[b_idx]
            cand = ts.sample(coarse, weights, generator, bj)   # i.i.d. D^2
            us = torch.rand(bj, generator=generator, dtype=torch.float32,
                            device=dev)
            _, p_acc = ops.lsh_bucket_accept(
                klo_pad[:, cand], khi_pad[:, cand], pts_pad[cand],
                ck_lo, ck_hi, ctr_pts, weights[cand], i, c2=c2)
            acc = us < p_acc
            hit = torch.argmax(acc.to(torch.int8))             # first accept
            # The round's one device-to-host transfer.
            live, any_acc, hit, n_acc, x_hit, x_first = torch.stack([
                (coarse[1] > 0).long(), acc.any().long(), hit,
                acc.sum(), cand[hit], cand[0]]).tolist()
            if not live:             # all weights 0: the uniform draw opens
                break
            if round_log is not None:
                round_log.append(bj)
            t_i += hit + 1 if any_acc else bj
            acc_ema = schedule.update_rate(acc_ema, n_acc / bj)
            b_idx = schedule.next_index(b_idx, acc_ema)
            x = x_hit if any_acc else x_first  # cand[0]: the exhaustion pick
            if any_acc:
                break
        if x is None:
            x = _uniform_index(n, generator, dev)
        weights, tsums = open_center(weights, x)
        coarse = ts.refresh(coarse, tsums)
        ctr_pts[i] = pts_pad[x]
        ck_lo[:, i] = klo_pad[:, x]
        ck_hi[:, i] = khi_pad[:, x]
        chosen.append(x)
        trials.append(max(t_i, 1))
    return (torch.tensor(chosen, dtype=torch.int32, device=dev),
            torch.tensor(trials, dtype=torch.int32, device=dev))


def resolve_schedule(schedule, batch) -> BatchSchedule:
    """An explicit `BatchSchedule` wins, ``batch=<int>`` pins a one-bucket
    schedule, and the default is the adaptive schedule."""
    if schedule is not None:
        return schedule
    if batch is not None:
        return BatchSchedule.fixed(int(batch))
    return BatchSchedule()


def _generator(rng: np.random.Generator, device) -> torch.Generator:
    """The solve stage's one draw from the plan rng seeds the generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(rng.integers(2 ** 31)))
    return g


# ---------------------------------------------------------------------------
# k-means|| baseline (Bahmani et al. 2012; bias analysis Makarychev et al.,
# arXiv:2010.14487): the oversampling rounds on the card.
# ---------------------------------------------------------------------------

def device_kmeans_parallel_rounds(
    points: torch.Tensor,       # (n, d) f32
    generator: torch.Generator,
    ell: float,                 # oversampling factor per round
    *,
    rounds: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means|| oversampling: `rounds` passes, each picking every point
    independently with probability ``min(1, ell * d2(x) / phi)`` (``phi``
    the f32 sum of d2; nothing is picked once ``phi == 0``) and then
    refreshing d2 against the round's picks with one `pairwise_argmin`
    launch.  Returns ``(selected (n,) bool, d2 (n,) f32)``.

    The first point is a uniform draw and its d2 the direct sum of squared
    differences.  An already selected point may be picked again, as in the
    JAX package's device rounds.  Only the first `cap` wanted points in
    index order are kept (their rank is a cumsum, so a round has fixed
    shapes and no device-to-host sync); the rest are dropped consistently,
    neither selected nor lowering d2, so the pool is exactly the set the
    distance field saw.  Unfilled center slots sit at `_FAR`.
    """
    n = points.shape[0]
    x0 = _uniform_index(n, generator, points.device)
    d2 = ((points - points[x0]) ** 2).sum(dim=1)
    sel = torch.zeros(n, dtype=torch.bool, device=points.device)
    sel[x0] = True
    for _ in range(rounds):
        picked, d2 = _kmeans_parallel_round(points, d2, generator, ell, cap)
        sel |= picked
    return sel, d2


def _kmeans_parallel_picks(points, d2, generator, ell: float, cap: int):
    """One round's draws: ``(picked (n,) bool, center slots (cap, d), live
    () int32)``, one uniform per point; the slots hold the `live` =
    min(wanted, cap) picks in index order and `_FAR` past them.  `live`
    stays on the device."""
    n = points.shape[0]
    dev = points.device
    phi = d2.sum()
    p = torch.clamp(ell * d2 / phi.clamp_min(1e-30), max=1.0)
    u = torch.rand(n, generator=generator, dtype=torch.float32, device=dev)
    want = (u < p) & (phi > 0)
    rank = torch.cumsum(want, dim=0) - 1
    picked = want & (rank < cap)
    # Slot `cap` collects the dropped and unwanted rows; it is cut off.
    idx = torch.zeros(cap + 1, dtype=torch.long, device=dev)
    idx[torch.where(picked, rank, cap)] = torch.arange(n, device=dev)
    live = torch.clamp(want.sum(), max=cap).to(torch.int32)
    valid = torch.arange(cap, device=dev) < live
    return picked, torch.where(valid[:, None], points[idx[:cap]], _FAR), live


def _kmeans_parallel_round(points, d2, generator, ell: float, cap: int):
    """One oversampling round of `device_kmeans_parallel_rounds`: the picks,
    then one `pairwise_argmin` launch over the live center slots (and the
    first `_FAR` one, which gives the full sweep's result bit for bit).
    Returns ``(picked (n,) bool, d2' (n,) f32)``."""
    picked, ctrs, live = _kmeans_parallel_picks(points, d2, generator, ell,
                                                cap)
    dmin, _ = ops.pairwise_argmin(points, ctrs, live)
    return picked, torch.minimum(d2, dmin)


# ---------------------------------------------------------------------------
# Cached prepare/solve split for `core.plan.ClusterPlan`: `prepare` consumes
# from `rng` exactly the draws the JAX package's does, and `solve` draws the
# generator seed where the JAX package drew its key.
# ---------------------------------------------------------------------------

def _prep_fastkmeanspp(pts, rng, *, resolution, options, execution):
    return prepare_embedding(pts, seed=int(rng.integers(2 ** 31)),
                             resolution=resolution, device=execution.device)


def _solve_fastkmeanspp(artifacts, pts, k, rng, *, c, schedule, options,
                        execution):
    lo, hi, meta = artifacts
    chosen = device_fast_kmeanspp(
        lo, hi, k, _generator(rng, lo.device), scale=meta["scale"],
        num_levels=meta["num_levels"], m_init=meta["m_init"],
        tile=execution.tile)
    return chosen, {"num_candidates": k}


def _prep_rejection(pts, rng, *, resolution, options, execution):
    return prepare_rejection(
        pts, seed=int(rng.integers(2 ** 31)), resolution=resolution,
        lsh_r=options.get("lsh_r"), num_tables=options.get("num_tables", 15),
        hashes_per_table=options.get("hashes_per_table", 1),
        device=execution.device)


def _solve_rejection(data, pts, k, rng, *, c, schedule, options, execution):
    sched = resolve_schedule(schedule, options.get("batch"))
    rounds: list[int] = []
    chosen, trials = device_rejection_sampling(
        data.codes_lo, data.codes_hi, data.points, data.keys_lo,
        data.keys_hi, k, _generator(rng, data.codes_lo.device),
        scale=data.scale, num_levels=data.num_levels, m_init=data.m_init,
        c=c, schedule=sched, max_rounds=options.get("max_rounds", 32),
        tile=execution.tile, round_log=rounds)
    return chosen, {"trials": trials, "num_candidates": int(trials.sum()),
                    "batch_buckets": sched.buckets(),
                    "rounds_per_batch": dict(collections.Counter(rounds))}


def _prep_kmeans_parallel(pts, rng, *, resolution, options, execution):
    # The only reusable artifact is the device upload itself (f32 copy).
    return torch.as_tensor(pts, dtype=torch.float32, device=execution.device)


def _solve_kmeans_parallel(points_dev, pts, k, rng, *, c, schedule, options,
                           execution):
    # The rounds on the card, then the host recluster with the same `rng`.
    n = points_dev.shape[0]
    rounds = options.get("rounds", 5)
    oversample = options.get("oversample")
    ell = float(oversample) if oversample is not None else 2.0 * k
    cap = int(min(n, max(8, 4 * ell)))
    sel, _ = device_kmeans_parallel_rounds(
        points_dev, _generator(rng, points_dev.device), ell, rounds=rounds,
        cap=cap)
    idx, pool = _candidate_pool_to_centers(
        pts, np.flatnonzero(sel.cpu().numpy()), k, rng)
    return (torch.as_tensor(idx, dtype=torch.int32, device=points_dev.device),
            {"pool_size": pool, "num_candidates": pool, "rounds": rounds,
             "oversample": ell})


# ---------------------------------------------------------------------------
# seed_fn facades: `(points, k, rng, **kw) -> SeedingResult` with NumPy
# indices, as the JAX package's `DEVICE_SEEDERS`, each running its seeder's
# registered prepare and solve; `device` and `tile` place the work.
# ---------------------------------------------------------------------------

def _seed_fn(name: str):
    def seed_fn(points, k, rng, *, c=1.2, schedule=None, resolution=None,
                device="cuda", tile=ExecutionSpec.tile, **options):
        impl = registry.get_seeder_spec(name).impl("device")
        execution = ExecutionSpec(device=device, tile=tile)
        t0 = time.perf_counter()
        pts = np.asarray(points, dtype=np.float64)
        artifacts = impl.prepare(pts, rng, resolution=resolution,
                                 options=options, execution=execution)
        t_prep = time.perf_counter() - t0
        chosen, extras = impl.solve(artifacts, pts, k, rng, c=c,
                                    schedule=schedule, options=options,
                                    execution=execution)
        idx = chosen.cpu().numpy().astype(np.int64)
        seconds = time.perf_counter() - t0
        return SeedingResult(
            centers=pts[idx].copy(), indices=idx, seconds=seconds,
            num_candidates=extras["num_candidates"], prepare_seconds=t_prep,
            solve_seconds=seconds - t_prep,
            extras=dict(extras, backend="device"))

    seed_fn.__doc__ = (f"`{name}` on the card through its registered "
                       "prepare and solve; `SeedingResult` facade.")
    return seed_fn


device_fast_kmeanspp_seeder = _seed_fn("fastkmeans++")
device_rejection_seeder = _seed_fn("rejection")
device_kmeans_parallel_seeder = _seed_fn("kmeans||")

DEVICE_SEEDERS = {
    "fastkmeans++": device_fast_kmeanspp_seeder,
    "rejection": device_rejection_seeder,
    "kmeans||": device_kmeans_parallel_seeder,
}


def _register():
    # The algorithms' capabilities, docs and fallbacks are declared in
    # `core.seeding`; this attaches the card's backend, the facades above
    # as its `run` (``"<name>/device"`` in the legacy `SEEDERS`).
    registry.register_backend("fastkmeans++", "device", registry.BackendImpl(
        run=device_fast_kmeanspp_seeder, prepare=_prep_fastkmeanspp,
        solve=_solve_fastkmeanspp, device_native=True),
        legacy_registry=SEEDERS)
    registry.register_backend("rejection", "device", registry.BackendImpl(
        run=device_rejection_seeder, prepare=_prep_rejection,
        solve=_solve_rejection, device_native=True),
        legacy_registry=SEEDERS)
    # Not device-native: the rounds run on the card, the weighted recluster
    # on the host per fit.
    registry.register_backend("kmeans||", "device", registry.BackendImpl(
        run=device_kmeans_parallel_seeder, prepare=_prep_kmeans_parallel,
        solve=_solve_kmeans_parallel, device_native=False),
        legacy_registry=SEEDERS)


_register()
