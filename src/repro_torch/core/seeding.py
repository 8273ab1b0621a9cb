"""Seeding results, costs and the exact k-means++ yardstick.

The port keeps from the JAX package's `core/seeding.py` what this slice
needs: `SeedingResult`, the float64 `clustering_cost`, the LSH radius
estimate `_estimate_scale` (same rng draws, so prepare artifacts stay
bit-identical), and exact `kmeanspp` (Arthur & Vassilvitskii 2007), the
quality reference of every fast seeder, here in PyTorch float64 so it can
run on the card at full size.
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
