"""Aspect-ratio control (paper Appendix F), NumPy.

Quantise coordinates to an integer grid whose resolution is a small
fraction of a cheaply estimated optimum cost:

  1. sample 20 random points as a rough solution and compute its cost;
  2. scaling = sqrt(cost / (n * d)) / 200  (per-coordinate error budget);
  3. floor-divide every coordinate by `scaling`.

A copy of the JAX package's `quantize`: same rng draws, same arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lloyd import assign

__all__ = ["quantize", "QuantizedData"]


@dataclasses.dataclass
class QuantizedData:
    points: np.ndarray      # quantised coordinates (float64, integer-valued)
    scaling: float          # one grid unit in original coordinates
    estimate: float         # the rough 20-center solution cost used


def quantize(points: np.ndarray, rng: np.random.Generator, *,
             sample_centers: int = 20) -> QuantizedData:
    """Appendix-F quantisation of `points`; draws the rough centers from
    `rng`."""
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    idx = rng.choice(n, size=min(sample_centers, n), replace=False)
    _, d2 = assign(pts, pts[idx])
    est = float(d2.sum())
    if est <= 0:  # all points identical: nothing to scale
        return QuantizedData(points=pts.copy(), scaling=1.0, estimate=0.0)
    scaling = np.sqrt(est / (n * d)) / 200.0
    q = np.floor(pts / scaling)
    return QuantizedData(points=q, scaling=scaling, estimate=est)
