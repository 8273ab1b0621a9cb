"""Lloyd's algorithm (local refinement after seeding) + the assignment step.

NumPy, float64: a copy of the JAX package's host code (`assign` feeds the
Appendix-F quantisation; `lloyd` runs when `ClusterSpec.lloyd_iters > 0`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["lloyd", "assign", "LloydResult"]


@dataclasses.dataclass
class LloydResult:
    centers: np.ndarray
    assignment: np.ndarray
    cost: float
    iterations: int
    cost_history: list


def assign(points: np.ndarray, centers: np.ndarray, chunk: int = 65536):
    """(argmin index, min squared distance) per point; chunked BLAS."""
    pts = np.asarray(points, dtype=np.float64)
    ctr = np.asarray(centers, dtype=np.float64)
    c_sq = (ctr ** 2).sum(axis=1)
    idx = np.empty(len(pts), dtype=np.int64)
    d2 = np.empty(len(pts), dtype=np.float64)
    for lo in range(0, len(pts), chunk):
        x = pts[lo: lo + chunk]
        dd = (x ** 2).sum(axis=1)[:, None] - 2.0 * (x @ ctr.T) + c_sq[None, :]
        idx[lo: lo + chunk] = dd.argmin(axis=1)
        d2[lo: lo + chunk] = np.maximum(dd.min(axis=1), 0.0)
    return idx, d2


def lloyd(points: np.ndarray, centers: np.ndarray, *, max_iters: int = 20,
          tol: float = 1e-6) -> LloydResult:
    """Standard Lloyd iterations; empty clusters keep their previous center."""
    pts = np.asarray(points, dtype=np.float64)
    ctr = np.asarray(centers, dtype=np.float64).copy()
    k = len(ctr)
    history = []
    prev = np.inf
    it = 0
    idx = np.zeros(len(pts), dtype=np.int64)
    for it in range(1, max_iters + 1):
        idx, d2 = assign(pts, ctr)
        cost = float(d2.sum())
        history.append(cost)
        counts = np.bincount(idx, minlength=k).astype(np.float64)
        sums = np.zeros_like(ctr)
        np.add.at(sums, idx, pts)
        nonempty = counts > 0
        ctr[nonempty] = sums[nonempty] / counts[nonempty, None]
        if prev - cost <= tol * max(cost, 1e-30):
            break
        prev = cost
    return LloydResult(centers=ctr, assignment=idx, cost=history[-1],
                       iterations=it, cost_history=history)
