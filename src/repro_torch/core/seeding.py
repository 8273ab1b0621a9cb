"""Seeding results, costs and the exact k-means++ yardstick.

The port keeps from the JAX package's `core/seeding.py` what its slices
need: `SeedingResult`, the float64 `clustering_cost`, the LSH radius
estimate `_estimate_scale` (same rng draws, so prepare artifacts stay
bit-identical), the host tail of k-means|| (`_candidate_pool_to_centers`
and its helpers, float64 on the host, returning the same indices for the
same pool and rng state), and exact `kmeanspp` (Arthur & Vassilvitskii
2007), the quality reference of every fast seeder, here in PyTorch float64
so it can run on the card at full size.
"""

from __future__ import annotations

import dataclasses
import time
import numpy as np
import torch

__all__ = ["SeedingResult", "clustering_cost", "kmeanspp"]


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
