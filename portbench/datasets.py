"""Points drawn from a seed: the power-law Gaussian mixture at the paper's
(n, d).

The law of `benchmarks/datasets.py` (the JAX benchmark's stand-in for the
UCI datasets, which are not redistributable), with its structure held
fixed so that every seed asks the same work of the seeders.  Drawn once
from `structure_seed`: cluster i of `clusters` holds n / i **
`size_exponent` points (normalised, rounded down, the rows left over
given one each to the largest clusters), its center is N(0, 1) *
`center_scale` and its per-coordinate spreads are uniform in
[`spread_low`, `spread_high`); the rows' order is a fixed permutation.
The run's seed draws each point: its cluster's center plus N(0, 1) times
its cluster's spreads.  Float64.

The draws are made with `torch.Generator`s on the device, the points in
row blocks of fixed size, so the same seed on the same device gives the
same points bit for bit; they come back to the host as a float64 array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["cluster_sizes", "make_points"]

_BLOCK = 1 << 18      # rows drawn per call; part of the law's draw order


def cluster_sizes(n: int, clusters: int, exponent: float) -> np.ndarray:
    """(clusters,) int64 sizes in proportion to 1 / i ** exponent, summing
    to n."""
    w = 1.0 / np.arange(1, clusters + 1, dtype=np.float64) ** exponent
    sizes = np.floor(n * w / w.sum()).astype(np.int64)
    sizes[: n - int(sizes.sum())] += 1
    return sizes


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def make_points(law: dict, seed: int, device) -> np.ndarray:
    """(n, d) float64 host array of `law` (a configuration's ``"data"``)
    drawn from `seed` (any whole number) on `device`."""
    n, d, kc = int(law["n"]), int(law["d"]), int(law["clusters"])
    f64 = torch.float64
    fixed = _generator(law["structure_seed"], device)
    spreads = torch.empty(kc, d, dtype=f64, device=device).uniform_(
        float(law["spread_low"]), float(law["spread_high"]), generator=fixed)
    centers = torch.randn(kc, d, generator=fixed, dtype=f64,
                          device=device) * float(law["center_scale"])
    order = torch.randperm(n, generator=fixed, device=device)
    sizes = torch.as_tensor(cluster_sizes(n, kc, float(law["size_exponent"])),
                            device=device)
    assign = torch.repeat_interleave(torch.arange(kc, device=device),
                                     sizes)[order]
    g = _generator(seed, device)
    out = np.empty((n, d), dtype=np.float64)
    for lo in range(0, n, _BLOCK):
        a = assign[lo: lo + _BLOCK]
        noise = torch.randn(len(a), d, generator=g, dtype=f64, device=device)
        out[lo: lo + len(a)] = (centers[a] + noise * spreads[a]).cpu().numpy()
    return out
