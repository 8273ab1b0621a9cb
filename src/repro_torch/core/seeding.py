"""Seeding algorithms: the paper's two (FastKMeans++, RejectionSampling)
and the baselines it compares against (exact k-means++, k-means||,
AFK-MC^2, uniform), on the host.

All CPU seeders share the signature
    ``seed_fn(points, k, rng, **kwargs) -> SeedingResult``
and are registered in ``SEEDERS`` and on the registry's ``"cpu"`` backend.
They are NumPy copies of the JAX package's faithful CPU implementations
(`kmeanspp_host` is its `kmeanspp`), so for the same points and the same
`np.random.Generator` state they open the same indices.

The module also holds what the device seeders share with them:
`SeedingResult`, the float64 `clustering_cost`, the LSH radius estimate
`_estimate_scale`, the host tail of k-means|| (`_candidate_pool_to_centers`
and its helpers, float64 on the host) and `kmeanspp`, exact k-means++ in
PyTorch float64 on a device, the quality reference of every fast seeder at
full size on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.batch_schedule import BatchSchedule
from repro_torch.core.lsh import MonotoneLSH
from repro_torch.core.multitree import MultiTreeSampler

__all__ = [
    "SeedingResult",
    "clustering_cost",
    "kmeanspp",
    "kmeanspp_host",
    "fast_kmeanspp",
    "rejection_sampling",
    "kmeans_parallel",
    "afkmc2",
    "uniform_sampling",
    "SEEDERS",
]


@dataclasses.dataclass
class SeedingResult:
    centers: np.ndarray          # (k, d) chosen center coordinates.
    indices: np.ndarray          # (k,) indices into the input point set.
    seconds: float               # wall-clock seeding time.
    num_candidates: int = 0      # rejection loop iterations (Lemma 5.3).
    prepare_seconds: float = 0.0
    solve_seconds: float = 0.0
    extras: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # Seeders without a prepare/solve split report everything as solve.
        if self.prepare_seconds == 0.0 and self.solve_seconds == 0.0:
            self.solve_seconds = self.seconds


def clustering_cost(points: np.ndarray, centers: np.ndarray,
                    chunk: int = 65536) -> float:
    """sum_x min_c ||x - c||^2, chunked BLAS (float64, host)."""
    pts = np.asarray(points, dtype=np.float64)
    ctr = np.asarray(centers, dtype=np.float64)
    c_sq = (ctr ** 2).sum(axis=1)
    total = 0.0
    for lo in range(0, len(pts), chunk):
        x = pts[lo: lo + chunk]
        d2 = (x ** 2).sum(axis=1)[:, None] - 2.0 * (x @ ctr.T) + c_sq[None, :]
        total += float(np.maximum(d2.min(axis=1), 0.0).sum())
    return total


def _min_d2_update(points, pts_sq, center, d2):
    """d2 <- min(d2, ||x - center||^2) for all points; one BLAS pass."""
    cand = pts_sq - 2.0 * (points @ center) + center @ center
    np.minimum(d2, cand, out=d2)
    np.maximum(d2, 0.0, out=d2)


def _estimate_scale(pts: np.ndarray, rng: np.random.Generator) -> float:
    """Appendix-F quantisation scale (one grid unit) for *unquantised* input:
    rough 20-center uniform solution cost => sqrt(cost / (n d)) / 200,
    estimated on a subsample of at most 20000 points."""
    n, d = pts.shape
    sub = pts if n <= 20000 else pts[rng.choice(n, 20000, replace=False)]
    ctr = sub[rng.choice(len(sub), min(20, len(sub)), replace=False)]
    c_sq = (ctr ** 2).sum(axis=1)
    d2 = (sub ** 2).sum(axis=1)[:, None] - 2.0 * (sub @ ctr.T) + c_sq[None, :]
    est = float(np.maximum(d2.min(axis=1), 0.0).mean())  # per-point cost
    if est <= 0:
        return 1.0
    return float(np.sqrt(est / d) / 200.0)


# ---------------------------------------------------------------------------
# k-means|| (Bahmani et al. 2012): the host recluster of the candidate pool.
# ---------------------------------------------------------------------------

def _nearest_chunked(points: np.ndarray, centers: np.ndarray,
                     chunk: int = 65536) -> np.ndarray:
    """Argmin center index per point; chunked BLAS.

    The JAX package's arithmetic bit for bit: the same NumPy BLAS product,
    then ``(|x|^2 - 2 x.c) + |c|^2`` clamped at 0, each step correctly
    rounded in float64 (``-2`` scales exactly, and ``a + (-b)`` is
    ``a - b``), ties to the first index.  Only the elementwise steps
    differ in how they run: in place on the (chunk, m) block through
    torch's CPU threads, where the JAX package's NumPy allocates four
    temporaries of the block and walks them on one core; so one block is
    alive at a time.  The JAX package's twin also returns the min distance;
    the recluster reads only the argmin.
    """
    pts = np.asarray(points, dtype=np.float64)
    ctr = np.asarray(centers, dtype=np.float64)
    c_sq = torch.from_numpy((ctr ** 2).sum(axis=1))
    idx = np.empty(len(pts), dtype=np.int64)
    for lo in range(0, len(pts), chunk):
        x = pts[lo: lo + chunk]
        dd = torch.from_numpy(x @ ctr.T)
        x_sq = torch.from_numpy((x ** 2).sum(axis=1))
        dd.mul_(-2.0).add_(x_sq[:, None]).add_(c_sq[None, :])
        dd.clamp_min_(0.0)
        idx[lo: lo + chunk] = dd.argmin(dim=1).numpy()
        del dd       # free the block before the next product allocates one
    return idx


def _weighted_kmeanspp_indices(cand: np.ndarray, weights: np.ndarray, k: int,
                               rng: np.random.Generator) -> np.ndarray:
    """Weighted k-means++ over a (small) candidate set: D^2 sampling with
    per-candidate multiplicities.  Returns k distinct positions into `cand`.
    """
    pts = np.asarray(cand, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    m = len(pts)
    pts_sq = (pts ** 2).sum(axis=1)
    chosen = np.empty(k, dtype=np.int64)
    taken = np.zeros(m, dtype=bool)
    chosen[0] = int(np.searchsorted(np.cumsum(w), rng.uniform(0.0, w.sum())))
    chosen[0] = min(chosen[0], m - 1)
    taken[chosen[0]] = True
    d2 = np.full(m, np.inf)
    _min_d2_update(pts, pts_sq, pts[chosen[0]], d2)
    for i in range(1, k):
        mass = np.where(taken, 0.0, w * d2)
        total = mass.sum()
        if total > 0:
            u = rng.uniform(0.0, total)
            x = int(np.searchsorted(np.cumsum(mass), u))
            x = min(x, m - 1)
        else:
            # Degenerate pool (duplicates): any untaken position will do.
            x = int(rng.choice(np.flatnonzero(~taken)))
        chosen[i] = x
        taken[x] = True
        _min_d2_update(pts, pts_sq, pts[x], d2)
    return chosen


def _candidate_pool_to_centers(pts: np.ndarray, cand: np.ndarray, k: int,
                               rng: np.random.Generator
                               ) -> tuple[np.ndarray, int]:
    """k-means|| tail: pad the pool to >= k distinct points, weight each
    candidate by its Voronoi population, recluster with weighted k-means++.
    Returns (k chosen point indices, pool size)."""
    n = len(pts)
    cand = np.unique(np.asarray(cand, dtype=np.int64))
    if len(cand) < k:
        extra = rng.permutation(np.setdiff1d(np.arange(n), cand))
        cand = np.sort(np.concatenate([cand, extra[: k - len(cand)]]))
    assign = _nearest_chunked(pts, pts[cand])
    w = np.bincount(assign, minlength=len(cand)).astype(np.float64)
    # Every candidate is its own nearest candidate, so w >= 1 everywhere and
    # the weighted D^2 distribution is well defined.
    np.maximum(w, 1.0, out=w)
    local = _weighted_kmeanspp_indices(pts[cand], w, k, rng)
    return cand[local], len(cand)


def kmeanspp(points: np.ndarray, k: int, rng: np.random.Generator, *,
             device="cuda") -> SeedingResult:
    """Exact k-means++: each center is drawn from the exact D^2 law,
    maintained by a dense float64 min-update per opened center on `device`.

    Draws from `rng` as the NumPy reference does (an integer for the first
    center, one uniform on [0, total) per further center), so only the
    float64 summation order differs from it.
    """
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    x = torch.as_tensor(pts, device=device)
    chosen = np.empty(k, dtype=np.int64)
    chosen[0] = rng.integers(n)
    d2 = ((x - x[int(chosen[0])]) ** 2).sum(dim=1)
    for i in range(1, k):
        total = float(d2.sum())
        if total <= 0:  # fewer distinct points than k: fall back to uniform
            chosen[i] = rng.integers(n)
        else:
            u = torch.tensor([rng.uniform(0.0, total)], dtype=torch.float64,
                             device=device)
            pick = torch.searchsorted(torch.cumsum(d2, dim=0), u)
            chosen[i] = min(int(pick), n - 1)
        d2 = torch.minimum(d2, ((x - x[int(chosen[i])]) ** 2).sum(dim=1))
    return SeedingResult(centers=pts[chosen].copy(), indices=chosen,
                         seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The faithful CPU seeders: NumPy copies of the JAX package's, draw for draw.
# ---------------------------------------------------------------------------

def kmeanspp_host(points: np.ndarray, k: int, rng: np.random.Generator,
                  **_) -> SeedingResult:
    """Exact k-means++ (Arthur & Vassilvitskii 2007) in NumPy float64: each
    round draws the next center from the exact D^2 law, kept by a dense
    min-update per opened center.  The JAX package's `kmeanspp`, the same
    arithmetic; `kmeanspp` above is the same law on a device."""
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    pts_sq = (pts ** 2).sum(axis=1)
    chosen = np.empty(k, dtype=np.int64)
    chosen[0] = rng.integers(n)
    d2 = np.full(n, np.inf)
    _min_d2_update(pts, pts_sq, pts[chosen[0]], d2)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0:  # fewer distinct points than k: fall back to uniform
            chosen[i] = rng.integers(n)
        else:
            u = rng.uniform(0.0, total)
            chosen[i] = int(np.searchsorted(np.cumsum(d2), u))
        _min_d2_update(pts, pts_sq, pts[chosen[i]], d2)
    return SeedingResult(centers=pts[chosen].copy(), indices=chosen,
                         seconds=time.perf_counter() - t0)


def fast_kmeanspp(points: np.ndarray, k: int, rng: np.random.Generator, *,
                  resolution: Optional[float] = None,
                  sampler: Optional[MultiTreeSampler] = None,
                  **_) -> SeedingResult:
    """FASTK-MEANS++ (paper Algorithm 3): D^2 sampling in the multi-tree
    metric.  Per opened center MULTITREEOPEN updates every point's tree
    distance in O(H) amortised, and MULTITREESAMPLE draws in O(log n)."""
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    mt = sampler or MultiTreeSampler(pts, seed=int(rng.integers(2 ** 31)),
                                     resolution=resolution)
    t_prep = time.perf_counter() - t0
    chosen = np.empty(k, dtype=np.int64)
    for i in range(k):
        x = int(rng.integers(mt.n)) if i == 0 else mt.sample(rng)
        chosen[i] = x
        mt.open(x)
    seconds = time.perf_counter() - t0
    return SeedingResult(centers=pts[chosen].copy(), indices=chosen,
                         seconds=seconds, num_candidates=k,
                         prepare_seconds=t_prep,
                         solve_seconds=seconds - t_prep)


def rejection_sampling(points: np.ndarray, k: int, rng: np.random.Generator,
                       *, c: float = 1.2, lsh_r: Optional[float] = None,
                       num_tables: int = 15, hashes_per_table: int = 1,
                       resolution: Optional[float] = None,
                       max_trials_factor: int = 4096, batch: int = 512,
                       schedule: Optional[BatchSchedule] = None,
                       **_) -> SeedingResult:
    """REJECTIONSAMPLING (paper Algorithm 4): accept candidate x with
    probability ``dist(x, Query(x))^2 / (c^2 * MultiTreeDist(x, S)^2)``.

    Batched speculative rejection: a block of `batch` i.i.d. candidates
    from the current multi-tree D^2 law and as many uniforms are drawn at
    once, the acceptance tests run lazily in chunks of 64, and the first
    accept opens (the rest of the block is discarded, which keeps the
    sequential law exactly).  A `schedule` replaces the fixed `batch`: the
    block starts from its cost model and steps geometrically per block on
    the rate ``1 / position of the first accept``.  ``max_trials_factor *
    k`` bounds the loop; exact multi-tree D^2 draws (uniform once every
    weight is 0) finish the centers past it, each counted as a trial.
    """
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    mt = MultiTreeSampler(pts, seed=int(rng.integers(2 ** 31)),
                          resolution=resolution)
    if lsh_r is None:
        # One scale with collision width 10 grid units (App. D.3): the
        # quantisation grid when the input is quantised, else its estimate.
        lsh_r = 10.0 * (resolution or _estimate_scale(pts, rng))
    lsh = MonotoneLSH(d, r=lsh_r, num_tables=num_tables,
                      hashes_per_table=hashes_per_table,
                      seed=int(rng.integers(2 ** 31)), capacity=max(k, 16))
    t_prep = time.perf_counter() - t0
    chosen = np.empty(k, dtype=np.int64)
    c2 = float(c) ** 2
    trials = 0
    max_trials = max_trials_factor * k + 64
    acc_ema = None
    if schedule is not None:
        batch = schedule.initial(n, k, max(1, n // 512))
        acc_ema = schedule.prior_accept

    # First center: uniform, acceptance probability one (paper, Line 5).
    x0 = int(rng.integers(n))
    chosen[0] = x0
    mt.open(x0)
    lsh.insert(pts[x0])
    trials += 1

    opened = 1
    chunk = 64  # LSH-evaluation granularity within a speculative batch
    while opened < k and trials < max_trials and mt.total_weight() > 0:
        cand = mt.sample_batch(rng, batch)
        us = rng.uniform(size=batch)
        hit = -1
        for lo in range(0, batch, chunk):
            sl = slice(lo, lo + chunk)
            _, d2_lsh = lsh.query_batch(pts[cand[sl]])
            mtd2 = mt.weights[cand[sl]]
            ok = mtd2 > 0.0
            p_accept = np.where(ok, d2_lsh / np.maximum(c2 * mtd2, 1e-300),
                                0.0)
            accepted = us[sl] < p_accept
            if accepted.any():
                hit = lo + int(np.argmax(accepted))
                break
        evaluated = batch if hit < 0 else hit + 1
        if schedule is not None:
            acc_ema = float(schedule.update_rate(
                acc_ema, (1.0 if hit >= 0 else 0.0) / evaluated))
            batch = schedule.propose(batch, acc_ema)
        if hit < 0:
            trials += evaluated
            continue
        trials += hit + 1
        x = int(cand[hit])
        chosen[opened] = x
        opened += 1
        mt.open(x)
        lsh.insert(pts[x])
    while opened < k:
        x = mt.sample(rng) if mt.total_weight() > 0 else int(rng.integers(n))
        trials += 1
        chosen[opened] = x
        opened += 1
        mt.open(x)
        lsh.insert(pts[x])
    seconds = time.perf_counter() - t0
    return SeedingResult(centers=pts[chosen].copy(), indices=chosen,
                         seconds=seconds, num_candidates=trials,
                         prepare_seconds=t_prep,
                         solve_seconds=seconds - t_prep,
                         extras={"trials_per_center": trials / k})


def _min_d2_chunked(points: np.ndarray, centers: np.ndarray,
                    chunk: int = 65536) -> np.ndarray:
    """Min squared distance per point to `centers`; chunked BLAS, the JAX
    package's `_nearest_chunked(..., with_idx=False)` arithmetic."""
    pts = np.asarray(points, dtype=np.float64)
    ctr = np.asarray(centers, dtype=np.float64)
    c_sq = (ctr ** 2).sum(axis=1)
    d2 = np.empty(len(pts), dtype=np.float64)
    for lo in range(0, len(pts), chunk):
        x = pts[lo: lo + chunk]
        dd = (x ** 2).sum(axis=1)[:, None] - 2.0 * (x @ ctr.T) + c_sq[None, :]
        np.maximum(dd, 0.0, out=dd)
        d2[lo: lo + chunk] = dd.min(axis=1)
    return d2


def kmeans_parallel(points: np.ndarray, k: int, rng: np.random.Generator, *,
                    rounds: int = 5, oversample: Optional[float] = None,
                    chunk: int = 65536, **_) -> SeedingResult:
    """k-means|| (Bahmani et al. 2012; Makarychev et al. 2020 show O(1)
    rounds suffice): `rounds` passes each pick every point independently
    with probability ``min(1, ell * d2(x) / phi)`` (``ell = oversample``,
    default 2k); the pool is weighted by Voronoi population and reclustered
    down to k by weighted k-means++."""
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    ell = float(oversample) if oversample is not None else 2.0 * k
    c0 = int(rng.integers(n))
    selected = np.zeros(n, dtype=bool)
    selected[c0] = True
    pts_sq = (pts ** 2).sum(axis=1)
    d2 = np.full(n, np.inf)
    _min_d2_update(pts, pts_sq, pts[c0], d2)
    for _r in range(rounds):
        phi = d2.sum()
        if phi <= 0:
            break
        p = np.minimum(1.0, ell * d2 / phi)
        picked = (rng.uniform(size=n) < p) & ~selected
        new = np.flatnonzero(picked)
        if new.size == 0:
            continue
        selected |= picked
        np.minimum(d2, _min_d2_chunked(pts, pts[new], chunk), out=d2)
    idx, pool = _candidate_pool_to_centers(pts, np.flatnonzero(selected), k,
                                           rng)
    return SeedingResult(centers=pts[idx].copy(), indices=idx,
                         seconds=time.perf_counter() - t0,
                         num_candidates=pool,
                         extras={"pool_size": pool, "rounds": rounds,
                                 "oversample": ell})


def afkmc2(points: np.ndarray, k: int, rng: np.random.Generator, *,
           m: int = 200, **_) -> SeedingResult:
    """Assumption-free k-MC^2 (Bachem et al. 2016) with chain length m:
    proposal ``q(x) = 0.5 d(x, c1)^2 / sum + 0.5 / n``, an m-step
    Metropolis-Hastings chain per round; the m candidates' distances to
    the centers so far are one (m x |S|) BLAS product per round."""
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    pts_sq = (pts ** 2).sum(axis=1)
    c0 = int(rng.integers(n))
    d2_c0 = pts_sq - 2.0 * (pts @ pts[c0]) + pts[c0] @ pts[c0]
    np.maximum(d2_c0, 0.0, out=d2_c0)
    q = 0.5 * d2_c0 / max(d2_c0.sum(), 1e-300) + 0.5 / n
    q /= q.sum()
    chosen = np.empty(k, dtype=np.int64)
    chosen[0] = c0
    centers = np.empty((k, pts.shape[1]))
    centers[0] = pts[c0]
    centers_sq = np.empty(k)
    centers_sq[0] = pts[c0] @ pts[c0]
    for i in range(1, k):
        cand = rng.choice(n, size=m, p=q)
        cd2 = (pts_sq[cand][:, None]
               - 2.0 * (pts[cand] @ centers[:i].T)
               + centers_sq[None, :i]).min(axis=1)
        np.maximum(cd2, 0.0, out=cd2)
        x, dx, qx = cand[0], cd2[0], q[cand[0]]
        us = rng.uniform(size=m)
        for j in range(1, m):
            y, dy, qy = cand[j], cd2[j], q[cand[j]]
            if dx <= 0 or (dy * qx) > (dx * qy) * us[j]:
                x, dx, qx = y, dy, qy
        chosen[i] = x
        centers[i] = pts[x]
        centers_sq[i] = pts[x] @ pts[x]
    return SeedingResult(centers=centers.copy(), indices=chosen,
                         seconds=time.perf_counter() - t0)


def uniform_sampling(points: np.ndarray, k: int, rng: np.random.Generator,
                     **_) -> SeedingResult:
    """k centers uniformly without replacement: the no-D^2 control."""
    t0 = time.perf_counter()
    pts = np.asarray(points, dtype=np.float64)
    idx = rng.choice(len(pts), size=k, replace=False)
    return SeedingResult(centers=pts[idx].copy(), indices=idx,
                         seconds=time.perf_counter() - t0)


SEEDERS: dict[str, Callable[..., SeedingResult]] = {
    "kmeans++": kmeanspp_host,
    "fastkmeans++": fast_kmeanspp,
    "rejection": rejection_sampling,
    "kmeans||": kmeans_parallel,
    "afkmc2": afkmc2,
    "uniform": uniform_sampling,
}


def _register_cpu():
    """Declare each algorithm's capabilities, doc and degradation target as
    the JAX package does, and attach the CPU seeders; `core.device_seeding`
    attaches the device backend on import."""
    register = registry.register_seeder
    register("kmeans++", registry.SeederCaps(),
             doc="exact D^2 sampling (Arthur & Vassilvitskii 2007)")
    register("fastkmeans++", registry.SeederCaps(needs_quantize=True),
             doc="Algorithm 3: D^2 sampling in the multi-tree metric",
             fallback="kmeans++")
    register("rejection",
             registry.SeederCaps(needs_quantize=True, accepts_c=True,
                                 accepts_schedule=True),
             doc="Algorithm 4: multi-tree proposal + LSH-corrected accept",
             fallback="kmeans||")
    register("kmeans||", registry.SeederCaps(),
             doc="k-means|| oversampling + weighted recluster (Bahmani 2012)",
             fallback="kmeans++")
    register("afkmc2", registry.SeederCaps(),
             doc="AFK-MC^2 MCMC approximate D^2 seeding (Bachem 2016)",
             fallback="kmeans++")
    register("uniform", registry.SeederCaps(), doc="uniform baseline")
    for name, fn in list(SEEDERS.items()):
        if "/" not in name:
            registry.register_backend(name, "cpu",
                                      registry.BackendImpl(run=fn),
                                      legacy_registry=SEEDERS)


_register_cpu()
