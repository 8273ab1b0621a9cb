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

The loop is lane-batched: B solves of one shape (B seeds of one dataset,
or B datasets of one shape bucket) advance in lockstep, center i of every
lane in the same step, through the lane axis of the three kernels -- where
the JAX package `jax.vmap`s its programs.  A solve of one dataset is the
one-lane case.  Each lane keeps its own schedule state and its own
generator, drawn in the one-lane order, so a lane's result does not depend
on the others.

Draws come from one explicit `torch.Generator` per lane on the tensors'
device, seeded from the solve stage's NumPy rng where the JAX package
built its `jax.random.key`; Philox cannot replay threefry, so the port
matches the reference in law, not in indices.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.batch_schedule import BatchSchedule, shape_bucket
from repro_torch.core.lsh import MonotoneLSH
from repro_torch.core.plan import ExecutionSpec, resolve_execution
from repro_torch.core.sample_tree import TiledSampleTree
from repro_torch.core.seeding import (
    SEEDERS,
    SeedingResult,
    _candidate_pool_to_centers,
    _estimate_scale,
)
from repro_torch.core.tree_embedding import build_multitree, compute_max_dist
from repro_torch.kernels import ops

__all__ = [
    "device_fast_kmeanspp",
    "device_rejection_sampling",
    "device_kmeans_parallel_rounds",
    "StackedLane",
    "prepared_lane",
    "stacked_rejection_sampling",
    "stacked_fast_kmeanspp",
    "canonical_pow2_scale",
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
    """Zero-pad one axis to `n_pad`.  A lane axis of stride 0 (one copy
    shared by every lane, from `expand`) stays shared: the copy is padded
    once."""
    axis %= a.dim()
    pad = n_pad - a.shape[axis]
    if pad <= 0:
        return a
    if axis > 0 and a.stride(0) == 0:
        return _pad_axis(a[0], axis - 1, n_pad)[None].expand(
            a.shape[0], *[-1] * (a.dim() - 1))
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _initial_weights(ts: TiledSampleTree, n_real: int, m_init: float,
                     device) -> torch.Tensor:
    """(n_pad,) f32: the first `n_real` rows at `m_init`, the rest at 0
    (never sampled)."""
    weights = torch.zeros(ts.n_pad, dtype=torch.float32, device=device)
    weights[:n_real] = m_init
    return weights


def _lane_start(codes_lo, codes_hi, n_real, *, scale, num_levels, m_init,
                tile, w0=None, base0=None):
    """The lane-batched seeders' state over codes (B, T, H-1, n):
    (sampler, open_center, weights (B, n_pad), coarse heaps (B, 2 cap)).

    `open_center(weights, x)` opens point x[j] (x (B,) int64 on the card)
    in every lane j with one lane-axis launch per tree and returns
    ``(weights', tile sums (B, T))``.  Lane j starts with its first
    `n_real[j]` rows at `m_init`; each lane's first heap is built alone,
    exactly as a one-lane solve builds it (a sum's rounding may depend on
    its shape).  Base weights `w0` (B, n_pad), when given, replace that
    start, with their heaps `base0` (B, 2 cap) or, when None, heaps built
    from them.
    """
    n = codes_lo.shape[-1]
    ts = TiledSampleTree(n, tile=tile)
    lo = _pad_axis(codes_lo, 3, ts.n_pad)
    hi = _pad_axis(codes_hi, 3, ts.n_pad)
    t = lo.shape[1]
    sweep = dict(scale=scale, num_levels=num_levels)

    def open_center(weights, x):
        for ti in range(t - 1):
            weights = ops.tree_sep_update_lanes(lo[:, ti], hi[:, ti], x,
                                                weights, **sweep)
        return ops.tree_sep_update_tiles_lanes(lo[:, t - 1], hi[:, t - 1], x,
                                               weights, block_n=tile, **sweep)

    if w0 is None:
        weights = torch.stack([_initial_weights(ts, r, m_init,
                                                codes_lo.device)
                               for r in n_real])
    else:
        weights = _pad_axis(w0.to(torch.float32), 1, ts.n_pad)
    if base0 is None:
        base0 = torch.stack([ts.init(w) for w in weights])
    return ts, open_center, weights, base0


def _initial_state(codes_lo, codes_hi, *, scale, num_levels, m_init, tile):
    """(sampler, open_center, weights0, coarse0) of one dataset: the
    one-lane case of `_lane_start`, with (n_pad,) weights and a heap, and
    `open_center(weights, x)` taking the opened point as an int.  Replays
    a given sequence of centers."""
    ts, open_lanes, weights, coarse = _lane_start(
        codes_lo[None], codes_hi[None], [codes_lo.shape[2]], scale=scale,
        num_levels=num_levels, m_init=m_init, tile=tile)

    def open_center(w, x: int):
        w, tsums = open_lanes(w[None], torch.tensor([x], device=w.device))
        return w[0], tsums[0]

    return ts, open_center, weights[0], coarse[0]


def _uniform_index(n: int, generator: torch.Generator, device) -> int:
    return int(torch.randint(0, n, (1,), generator=generator, device=device))


def _lanes_of(codes_lo, generators, n_real):
    """(B, device, per-lane live row counts, default all n rows)."""
    b = len(generators)
    if codes_lo.shape[0] != b:
        raise ValueError(f"arrays of {codes_lo.shape[0]} lanes and {b} "
                         "generators")
    n = codes_lo.shape[-1]
    n_real = [n] * b if n_real is None else [int(r) for r in n_real]
    if len(n_real) != b or not all(1 <= r <= n for r in n_real):
        raise ValueError(f"n_real must hold one count in 1..{n} per lane, "
                         f"got {n_real}")
    return b, codes_lo.device, n_real


def stacked_fast_kmeanspp(codes_lo: torch.Tensor, codes_hi: torch.Tensor,
                          k: int, generators, *, n_real=None, scale: float,
                          num_levels: int, m_init: float, tile: int = 512,
                          w0=None, base0=None) -> torch.Tensor:
    """Algorithm 3 over B lanes in lockstep: (B, k) int32 chosen indices.

    Codes are (B, T, H-1, n), lane j's dataset in row j; an `expand`ed
    (stride-0) lane axis shares one dataset's codes, and nothing is copied
    per lane.  Lane j draws from `generators[j]` and samples only its first
    `n_real[j]` rows (default all n): the rest start, and stay, at weight 0.
    Center i of every lane opens in the same step, with one lane-axis sweep
    per tree; each lane's indices are those of its one-lane solve, bit for
    bit.  Nothing syncs: the opened points stay on the card.

    The streaming path passes base weights `w0` (B, n_pad): live rows at
    `m_init`, retired and padding rows at 0, which are never sampled and
    never perturb the loop, so a lane draws the exact law over its live
    rows; `base0` (B, 2 cap), when given, are their coarse heaps (else
    built from them).  The first center is then drawn by the sampler over
    `w0`, exactly uniform on the live rows, not by `randint`, which could
    open a retired row.
    """
    b, dev, n_real = _lanes_of(codes_lo, generators, n_real)
    ts, open_center, weights, coarse = _lane_start(
        codes_lo, codes_hi, n_real, scale=scale, num_levels=num_levels,
        m_init=m_init, tile=tile, w0=w0, base0=base0)
    lanes = torch.arange(b, device=dev)      # one draw a lane
    chosen = []
    for i in range(k):
        if i == 0 and w0 is None:
            x = torch.cat([torch.randint(0, r, (1,), generator=g, device=dev)
                           for r, g in zip(n_real, generators)])
        else:
            x = ts.sample_lanes(coarse, weights, generators, [1] * b, lanes)
        weights, tsums = open_center(weights, x)
        coarse = ts.refresh(coarse, tsums)
        chosen.append(x)
    return torch.stack(chosen, dim=1).to(torch.int32)


def device_fast_kmeanspp(codes_lo: torch.Tensor, codes_hi: torch.Tensor,
                         k: int, generator: torch.Generator, *, scale: float,
                         num_levels: int, m_init: float, tile: int = 512,
                         w0: Optional[torch.Tensor] = None,
                         base0: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Algorithm 3 (D^2 sampling in the multi-tree metric).  Returns (k,)
    int32 chosen indices on the codes' device: the one-lane case of
    `stacked_fast_kmeanspp`, with its base weights `w0` (n_pad,) and heap
    `base0` (2 cap,) on the streaming path.

    Per opened center the sample structure is fixed incrementally: the last
    tree sweep's tile sums feed one `TiledSampleTree.refresh`.
    """
    return stacked_fast_kmeanspp(
        codes_lo[None], codes_hi[None], k, [generator], scale=scale,
        num_levels=num_levels, m_init=m_init, tile=tile, **_one_lane_base(
            w0, base0))[0]


def _one_lane_base(w0, base0) -> dict:
    """A one-lane solve's base weights and heap as the lane-batched
    seeders take them, (1, n_pad) and (1, 2 cap)."""
    return {"w0": None if w0 is None else w0[None],
            "base0": None if base0 is None else base0[None]}


def _block_layout(sizes: tuple, device) -> tuple:
    """A round's candidate layout for the lanes' block sizes: (lane of each
    candidate (S,), each lane's first candidate (B,), each candidate's
    position in its lane's block (S,)), int64 on `device`.  A lane of size
    0 draws nothing that round."""
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    lanes = np.repeat(np.arange(len(sizes)), sizes)
    local = np.arange(len(lanes)) - starts[lanes]
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (lanes, starts, local))


def stacked_rejection_sampling(
    codes_lo: torch.Tensor,     # (B, T, H-1, n) int32
    codes_hi: torch.Tensor,
    points: torch.Tensor,       # (B, n, d) f32
    keys_lo: torch.Tensor,      # (B, L, n) int32
    keys_hi: torch.Tensor,
    k: int,
    generators,
    *,
    n_real=None,
    scale: float,
    num_levels: int,
    m_init: float,
    c: float = 1.2,
    schedule: BatchSchedule | None = None,
    max_rounds: int = 32,
    tile: int = 512,
    round_logs: Optional[list] = None,
    w0: Optional[torch.Tensor] = None,
    base0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 4 over B lanes in lockstep.  Returns ``(chosen (B, k)
    int32, trials (B, k) int32)``.

    Every array carries a leading lane axis, lane j's dataset in row j; an
    `expand`ed (stride-0) lane axis shares one dataset, and nothing is
    copied per lane.  Lane j samples only its first `n_real[j]` rows
    (default all n), draws from `generators[j]` and keeps its own schedule
    state (bucket index, rate EMA) and trial counts.  Center i of every
    lane opens in the same step.  Per round, each lane that has not yet
    accepted for the current center draws its block (`ts.sample`'s two
    uniform vectors, then the acceptance uniforms) exactly as its one-lane
    solve draws it; the descent, the gathers, one `lsh_bucket_accept`
    launch, the per-lane decisions and the one device-to-host transfer run
    once for all lanes.  A lane that accepts, or whose weights are all 0,
    sits out the rest of the center's rounds: it draws nothing and its
    schedule stands still.  The opened points then go through one
    lane-axis sweep per tree.  So each lane's indices and trials are those
    of its one-lane solve, bit for bit, whatever B.

    Per lane, as the paper's REJECTIONSAMPLING: rounds of batched
    speculative rejection draw a block of i.i.d. candidates from the
    current multi-tree D^2 law plus uniforms, score them with
    ``p = d2_lsh / (c^2 * mtd2)`` over the opened centers and open the
    first accept (the rest of the block is discarded, which keeps the
    sequential law exactly).  A complete LSH miss always accepts.  After
    `max_rounds` rounds without an accept, the first candidate of the last
    block -- an exact multi-tree D^2 draw -- opens.  The first center, and
    any center while all of a lane's weights are 0, is a uniform draw over
    its live rows.  `trials` counts the candidates each center consumed (at
    least 1).  `round_logs`, when given, holds one list per lane that
    receives the block size of each of its rounds.

    Base weights `w0` and heaps `base0` (the streaming path) are as in
    `stacked_fast_kmeanspp`: the first center, and a center while all of
    a lane's weights are 0, are then drawn by the sampler over `w0`,
    exactly uniform on the live rows.
    """
    b, dev, n_real = _lanes_of(codes_lo, generators, n_real)
    n = codes_lo.shape[-1]
    l, d = keys_lo.shape[1], points.shape[2]
    c2 = float(c) ** 2
    schedule = schedule if schedule is not None else BatchSchedule()
    buckets = schedule.buckets()
    ts, open_center, weights, coarse = _lane_start(
        codes_lo, codes_hi, n_real, scale=scale, num_levels=num_levels,
        m_init=m_init, tile=tile, w0=w0, base0=base0)
    base_w, base_heap = weights, coarse
    b_idx = [schedule.index_of(schedule.initial(n, k, ts.num_tiles))] * b
    acc_ema = [schedule.prior_accept] * b
    pts_pad = _pad_axis(points, 1, ts.n_pad)
    # (L, B, n_pad) views: a gather at (lane, point) gives (L, S) keys.
    klo_pad = _pad_axis(keys_lo, 2, ts.n_pad).transpose(0, 1)
    khi_pad = _pad_axis(keys_hi, 2, ts.n_pad).transpose(0, 1)
    every = torch.arange(b, device=dev)
    layouts: dict[tuple, tuple] = {}      # block sizes -> `_block_layout`

    # One slot per center in every lane; the accept kernel reads only the
    # first i (the opened ones), so the buffers need no padding.
    ctr_pts = torch.full((b, k, d), _FAR, dtype=torch.float32, device=dev)
    ck_lo = torch.zeros((b, l, k), dtype=torch.int32, device=dev)
    ck_hi = torch.zeros((b, l, k), dtype=torch.int32, device=dev)
    chosen = [[] for _ in range(b)]
    trials = [[] for _ in range(b)]
    for i in range(k):
        xs, t_i = [None] * b, [0] * b
        active = list(range(b)) if i > 0 else []
        for _ in range(max_rounds):
            if not active:
                break
            sizes = [0] * b
            for j in active:
                sizes[j] = buckets[b_idx[j]]
            key = tuple(sizes)
            if key not in layouts:
                layouts[key] = _block_layout(key, dev)
            lanes, starts, local = layouts[key]
            cand = ts.sample_lanes(coarse, weights, generators, sizes,
                                   lanes)                        # i.i.d. D^2
            us = [torch.rand(sizes[j], generator=generators[j],
                             dtype=torch.float32, device=dev)
                  for j in active]
            us = us[0] if len(us) == 1 else torch.cat(us)
            _, p_acc = ops.lsh_bucket_accept_lanes(
                klo_pad[:, lanes, cand], khi_pad[:, lanes, cand],
                pts_pad[lanes, cand], lanes, ck_lo, ck_hi, ctr_pts,
                weights[lanes, cand], i, c2=c2)
            acc = us < p_acc
            none = len(cand)
            first = torch.full((b,), none, dtype=torch.int64, device=dev)
            first.scatter_reduce_(0, lanes, torch.where(acc, local, none),
                                  "amin")                    # first accept
            any_acc = first < none
            hit = torch.where(any_acc, first, 0)
            n_acc = torch.zeros(b, dtype=torch.int64, device=dev).index_add_(
                0, lanes, acc.long())
            # The round's one device-to-host transfer, a row per lane.
            rows = torch.stack([
                (coarse[:, 1] > 0).long(), any_acc.long(), hit, n_acc,
                cand[(starts + hit).clamp_max(none - 1)],
                cand[starts.clamp_max(none - 1)]], dim=1).tolist()
            still = []
            for j in active:
                live, any_j, hit_j, n_acc_j, x_hit, x_first = rows[j]
                if not live:     # all weights 0: the uniform draw opens
                    continue
                bj = sizes[j]
                if round_logs is not None:
                    round_logs[j].append(bj)
                t_i[j] += hit_j + 1 if any_j else bj
                acc_ema[j] = schedule.update_rate(acc_ema[j], n_acc_j / bj)
                b_idx[j] = schedule.next_index(b_idx[j], acc_ema[j])
                xs[j] = x_hit if any_j else x_first   # cand[0]: exhaustion
                if not any_j:
                    still.append(j)
            active = still
        unset = [j for j in range(b) if xs[j] is None]
        if unset and w0 is not None:
            drawn = ts.sample_lanes(
                base_heap, base_w, generators,
                [int(xs[j] is None) for j in range(b)],
                torch.as_tensor(unset, device=dev)).tolist()
            for j, x_j in zip(unset, drawn):
                xs[j] = x_j
        for j in range(b):
            if xs[j] is None:
                xs[j] = _uniform_index(n_real[j], generators[j], dev)
            chosen[j].append(xs[j])
            trials[j].append(max(t_i[j], 1))
        x = torch.tensor(xs, dtype=torch.int64, device=dev)
        weights, tsums = open_center(weights, x)
        coarse = ts.refresh(coarse, tsums)
        ctr_pts[:, i] = pts_pad[every, x]
        ck_lo[:, :, i] = klo_pad[:, every, x].T
        ck_hi[:, :, i] = khi_pad[:, every, x].T
    return (torch.tensor(chosen, dtype=torch.int32, device=dev),
            torch.tensor(trials, dtype=torch.int32, device=dev))


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
    w0: Optional[torch.Tensor] = None,
    base0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 4 (REJECTIONSAMPLING) on one dataset: the one-lane case of
    `stacked_rejection_sampling`, whose docstring states the algorithm.
    Returns ``(chosen (k,) int32, trials (k,) int32)`` on the codes'
    device; `round_log`, when given, receives the block size of every
    round; `w0` (n_pad,) and `base0` (2 cap,) are the streaming path's
    base weights and heap."""
    chosen, trials = stacked_rejection_sampling(
        codes_lo[None], codes_hi[None], points[None], keys_lo[None],
        keys_hi[None], k, [generator], scale=scale, num_levels=num_levels,
        m_init=m_init, c=c, schedule=schedule, max_rounds=max_rounds,
        tile=tile, round_logs=None if round_log is None else [round_log],
        **_one_lane_base(w0, base0))
    return chosen[0], trials[0]


def resolve_schedule(schedule, batch) -> BatchSchedule:
    """An explicit `BatchSchedule` wins, ``batch=<int>`` pins a one-bucket
    schedule, and the default is the adaptive schedule."""
    if schedule is not None:
        return schedule
    if batch is not None:
        return BatchSchedule.fixed(int(batch))
    return BatchSchedule()


def _seeded(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _generator(rng: np.random.Generator, device) -> torch.Generator:
    """The solve stage's one draw from the plan rng seeds the generator."""
    return _seeded(rng.integers(2 ** 31), device)


# ---------------------------------------------------------------------------
# Stacked lanes: B different datasets solved together
# (`ClusterPlan.fit_batch(datasets=...)`, `fit_batch_prepared`).
#
# As in the JAX package, `scale` / `num_levels` / `m_init` depend on each
# dataset's diameter, so the canonical prepare rescales every dataset into
# the unit ball by an EXACT power-of-two factor (mantissas untouched, so
# distance ratios -- all that D^2 sampling and the scale-free acceptance
# test consume -- are preserved bit for bit) and builds the embedding with
# the forced diameter bound max_dist=1.0 at a fixed canonical resolution:
# the statics then depend only on (d, resolution).  Row counts pad up to a
# `shape_bucket` rung, and the lanes of one bucket run as one
# `stacked_*` solve with a per-lane `n_real` (padded rows carry weight 0,
# never sampled).  Where the JAX package compiles one vmapped program per
# bucket, the port runs one lane-batched host loop per bucket.  Eager
# PyTorch has no buffers to donate, so `donated` is always False.
# ---------------------------------------------------------------------------

_STACK_RESOLUTION = 2.0 ** -10   # canonical leaf side => H = 12 fixed levels


def canonical_pow2_scale(points: np.ndarray) -> float:
    """Exact power-of-two factor mapping `points` into the unit ball.

    ``s = 2^-ceil(log2(compute_max_dist(points)))`` guarantees
    ``compute_max_dist(points * s) <= 1.0``; because s is a power of two the
    rescale only shifts exponents (no mantissa rounding), so every pairwise
    distance ratio -- and therefore the D^2 sampling distribution and the
    Algorithm-4 acceptance ratio -- is preserved exactly.
    """
    md = compute_max_dist(np.asarray(points, dtype=np.float64))
    return 2.0 ** -math.ceil(math.log2(md)) if md > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class StackedLane:
    """One dataset's canonically rescaled, bucket-padded lane artifacts.

    `arrays` are the per-lane device tensors (row axis padded to a
    `shape_bucket` rung); `statics` the solve's (scale, num_levels,
    m_init), bit-identical across every lane of a shape bucket; `n_real`
    the live row count.  Lanes stack iff their `shape_key`s are equal: the
    plan groups by it, one solve per group.
    """

    arrays: tuple
    n_real: int
    statics: tuple

    @property
    def shape_key(self) -> tuple:
        return (tuple(tuple(a.shape) for a in self.arrays), self.statics)


def _canonical_rejection_lane(points, rng, *, options, execution):
    """`BackendImpl.prepare_stacked` for the rejection seeder."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    s = canonical_pow2_scale(pts)
    resolution = float(options.get("stack_resolution", _STACK_RESOLUTION))
    # A user lsh_r is expressed in ORIGINAL data units: rescale it with the
    # points, or the canonical lane's collision radius is off by 1/s.
    lsh_r = options.get("lsh_r")
    data = prepare_rejection(
        pts * s, seed=int(rng.integers(2 ** 31)), resolution=resolution,
        max_dist=1.0, lsh_r=None if lsh_r is None else float(lsh_r) * s,
        num_tables=options.get("num_tables", 15),
        hashes_per_table=options.get("hashes_per_table", 1),
        device=execution.device)
    bucket = shape_bucket(n, min_bucket=max(1024, execution.tile))
    return StackedLane(
        arrays=(_pad_axis(data.codes_lo, 2, bucket),
                _pad_axis(data.codes_hi, 2, bucket),
                _pad_axis(data.points, 0, bucket),
                _pad_axis(data.keys_lo, 1, bucket),
                _pad_axis(data.keys_hi, 1, bucket)),
        n_real=n, statics=(data.scale, data.num_levels, data.m_init))


def _canonical_fastkmeanspp_lane(points, rng, *, options, execution):
    """`BackendImpl.prepare_stacked` for the fastkmeans++ seeder."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    resolution = float(options.get("stack_resolution", _STACK_RESOLUTION))
    lo, hi, meta = prepare_embedding(
        pts * canonical_pow2_scale(pts), seed=int(rng.integers(2 ** 31)),
        resolution=resolution, max_dist=1.0, device=execution.device)
    bucket = shape_bucket(n, min_bucket=max(1024, execution.tile))
    return StackedLane(
        arrays=(_pad_axis(lo, 2, bucket), _pad_axis(hi, 2, bucket)),
        n_real=n, statics=(meta["scale"], meta["num_levels"],
                           meta["m_init"]))


def prepared_lane(artifacts) -> StackedLane:
    """A solo prepare's artifacts (`DeviceSeedingData` of the rejection
    seeder, ``(codes_lo, codes_hi, meta)`` of fastkmeans++) as one lane of
    `solve_stacked`, all its rows live: ``fit_batch(seeds)`` passes it once
    per seed."""
    if isinstance(artifacts, DeviceSeedingData):
        arrays = (artifacts.codes_lo, artifacts.codes_hi, artifacts.points,
                  artifacts.keys_lo, artifacts.keys_hi)
        statics = (artifacts.scale, artifacts.num_levels, artifacts.m_init)
    else:
        lo, hi, meta = artifacts
        arrays = (lo, hi)
        statics = (meta["scale"], meta["num_levels"], meta["m_init"])
    return StackedLane(arrays=arrays, n_real=arrays[0].shape[-1],
                       statics=statics)


def _stack_lanes(lanes) -> list:
    """The lanes' arrays stacked on a leading lane axis.  One lane given
    for every position (B seeds of one dataset) is expanded instead: a
    stride-0 lane axis over the one copy."""
    if all(lane is lanes[0] for lane in lanes):
        return [a[None].expand(len(lanes), *a.shape)
                for a in lanes[0].arrays]
    return [torch.stack([lane.arrays[j] for lane in lanes])
            for j in range(len(lanes[0].arrays))]


def _solve_stacked_rejection(lanes, k, lane_seeds, *, c, schedule, options,
                             execution):
    """`BackendImpl.solve_stacked`: the lanes of one shape bucket as one
    lane-batched solve, lane j's generator seeded with `lane_seeds[j]`."""
    arrs = _stack_lanes(lanes)
    scale, num_levels, m_init = lanes[0].statics
    sched = resolve_schedule(schedule, options.get("batch"))
    idx, trials = stacked_rejection_sampling(
        *arrs, k, [_seeded(s, arrs[0].device) for s in lane_seeds],
        n_real=[lane.n_real for lane in lanes], scale=scale,
        num_levels=num_levels, m_init=m_init, c=c, schedule=sched,
        max_rounds=options.get("max_rounds", 32), tile=execution.tile)
    return idx, {"trials": trials, "batch_buckets": sched.buckets(),
                 "donated": False}


def _solve_stacked_fastkmeanspp(lanes, k, lane_seeds, *, c, schedule,
                                options, execution):
    arrs = _stack_lanes(lanes)
    scale, num_levels, m_init = lanes[0].statics
    idx = stacked_fast_kmeanspp(
        *arrs, k, [_seeded(s, arrs[0].device) for s in lane_seeds],
        n_real=[lane.n_real for lane in lanes], scale=scale,
        num_levels=num_levels, m_init=m_init, tile=execution.tile)
    return idx, {"donated": False}


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
    phi = d2.sum()
    u = torch.rand(points.shape[0], generator=generator, dtype=torch.float32,
                   device=points.device)
    return _coin_picks(points, d2, phi, u, ell, cap)


def _coin_picks(points, d2, phi, u, ell: float, cap: int):
    """`_kmeans_parallel_picks` given the round's total `phi` (a 0-d
    tensor) and one uniform per point `u`: a shard of the sharded rounds
    passes the total over every shard and its own coins."""
    n = points.shape[0]
    dev = points.device
    p = torch.clamp(ell * d2 / phi.clamp_min(1e-30), max=1.0)
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
# indices, as the JAX package's `DEVICE_SEEDERS` and `SHARDED_SEEDERS`,
# each running its seeder's registered prepare and solve; `device`, `tile`
# and (on the sharded backend) `mesh` place the work.
# ---------------------------------------------------------------------------

def _seed_fn(name: str, backend: str = "device"):
    def seed_fn(points, k, rng, *, c=1.2, schedule=None, resolution=None,
                device="cuda", tile=ExecutionSpec.tile, mesh=None,
                **options):
        impl = registry.get_seeder_spec(name).impl(backend)
        execution = resolve_execution(ExecutionSpec(
            backend=backend, device=device, tile=tile, mesh=mesh))
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
        extras = dict(extras, backend=backend)
        if "trials" in extras:
            per_center = extras["trials"].cpu().numpy().astype(np.int64)
            extras.update(per_center_trials=per_center,
                          trials_per_center=per_center.sum() / k)
        return SeedingResult(
            centers=pts[idx].copy(), indices=idx, seconds=seconds,
            num_candidates=extras["num_candidates"], prepare_seconds=t_prep,
            solve_seconds=seconds - t_prep, extras=extras)

    seed_fn.__doc__ = (f"`{name}` on the {backend} backend through its "
                       "registered prepare and solve; `SeedingResult` "
                       "facade.")
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
        solve=_solve_fastkmeanspp, device_native=True,
        prepare_stacked=_canonical_fastkmeanspp_lane,
        solve_stacked=_solve_stacked_fastkmeanspp),
        legacy_registry=SEEDERS)
    registry.register_backend("rejection", "device", registry.BackendImpl(
        run=device_rejection_seeder, prepare=_prep_rejection,
        solve=_solve_rejection, device_native=True,
        prepare_stacked=_canonical_rejection_lane,
        solve_stacked=_solve_stacked_rejection),
        legacy_registry=SEEDERS)
    # Not device-native and no stacked lanes (as in the JAX package): the
    # rounds run on the card, the weighted recluster on the host per fit.
    registry.register_backend("kmeans||", "device", registry.BackendImpl(
        run=device_kmeans_parallel_seeder, prepare=_prep_kmeans_parallel,
        solve=_solve_kmeans_parallel, device_native=False),
        legacy_registry=SEEDERS)


_register()
