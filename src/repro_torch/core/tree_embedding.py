"""Random-shift grid (quadtree) embeddings — the paper's §2/§3 construct.

NumPy only; a copy of the JAX package's host-side code, so the port's cell
codes are bit-identical for the same seed.  A tree embedding is represented
implicitly by per-level integer cell codes:
``code_h(x) = hash(floor((x - origin + shift) * 2**h / (2 * max_dist)))`` for
heights ``h = 0 .. H-1`` (height 0 is the root).  Grids nest, so code
equality is prefix-closed along the root-to-leaf path and the tree distance
has the closed form

    TreeDist(p, q) = 2 * sqrt(d) * max_dist * (2**(1 - sep) - 2**(1 - H))

where ``sep`` is the number of agreeing levels.  The d-dimensional cell
coordinate is hashed to one uint64 with a random linear hash (odd
multipliers, wrap-around arithmetic).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "TreeEmbedding",
    "MultiTreeEmbedding",
    "build_multitree",
    "compute_max_dist",
    "sep_levels",
    "tree_dist_from_sep",
    "multitree_dist_sq_points",
    "NUM_TREES",
]

NUM_TREES = 3  # the paper uses exactly three shifted trees ("multi-tree").


def compute_max_dist(points: np.ndarray) -> float:
    """Upper bound on the diameter within a factor of 2 (paper §2, fn. 6):
    twice the largest distance from the first point.  O(nd)."""
    x0 = points[0]
    d = np.sqrt(np.maximum(((points - x0) ** 2).sum(axis=1), 0.0)).max()
    return float(2.0 * d) if d > 0 else 1.0


def _num_levels(max_dist: float, resolution: float) -> int:
    """Number of grid heights H such that the leaf cell side < resolution."""
    h = int(np.ceil(np.log2(max(2.0 * max_dist / max(resolution, 1e-300),
                                2.0))))
    return max(2, min(h + 1, 60))


@dataclasses.dataclass(frozen=True)
class TreeEmbedding:
    """One random-shift grid embedding: per-level hashed cell codes."""

    codes: np.ndarray          # (H, n) uint64 — hashed cell ids per height.
    max_dist: float            # root cell side / 2.
    num_levels: int            # H.
    dim: int                   # ambient dimension d.
    shift: np.ndarray          # (d,) the random shift.
    origin: np.ndarray         # (d,) per-coordinate min, subtracted first.
    hash_mults: np.ndarray     # (d,) odd uint64 multipliers.

    def point_codes(self, x: np.ndarray) -> np.ndarray:
        """Codes for arbitrary query points x of shape (..., d)."""
        return _grid_codes(np.asarray(x, dtype=np.float64), self.origin,
                           self.shift, self.max_dist, self.num_levels,
                           self.hash_mults)


@dataclasses.dataclass(frozen=True)
class MultiTreeEmbedding:
    """Three independently shifted tree embeddings (paper §3)."""

    trees: tuple[TreeEmbedding, ...]
    max_dist: float
    num_levels: int
    dim: int
    num_points: int

    @property
    def dist_upper_bound_sq(self) -> float:
        """M = 16 d MaxDist^2, the paper's upper bound on MultiTreeDist^2."""
        return 16.0 * self.dim * self.max_dist ** 2

    def codes_array(self) -> np.ndarray:
        """All codes stacked: (num_trees, H, n) uint64."""
        return np.stack([t.codes for t in self.trees])


def _grid_codes(pts: np.ndarray, origin: np.ndarray, shift: np.ndarray,
                max_dist: float, num_levels: int,
                hash_mults: np.ndarray) -> np.ndarray:
    """Hashed cell codes for every height; returns (H, ...) uint64.

    Level sides halve exactly, so the level-h cell coordinate is the deepest
    level's coordinate right-shifted by (H-1-h) bits: one floor-divide, then
    integer shifts and the per-level linear hash.
    """
    y = (pts - origin) + shift  # all coords in [0, 2*max_dist)
    root_side = 2.0 * max_dist
    lead = pts.shape[:-1]
    out = np.empty((num_levels,) + lead, dtype=np.uint64)
    out[0] = 0
    deep_side = root_side / (1 << (num_levels - 1))
    cell_deep = np.floor(y / deep_side).astype(np.uint64)
    with np.errstate(over="ignore"):
        for h in range(1, num_levels):
            cell = cell_deep >> np.uint64(num_levels - 1 - h)
            code = (cell * hash_mults).sum(axis=-1, dtype=np.uint64)
            # Mix in the height so identical cells at different heights differ.
            out[h] = code * np.uint64(0x9E3779B97F4A7C15) + np.uint64(h)
    return out


def build_multitree(points: np.ndarray, *, seed: int = 0,
                    resolution: Optional[float] = None,
                    num_trees: int = NUM_TREES,
                    max_dist: Optional[float] = None) -> MultiTreeEmbedding:
    """MULTITREEINIT(): three random-shift grid embeddings over `points`.

    `resolution` bounds the leaf cell side (default: 1e-6 of max_dist).
    `max_dist` overrides the computed diameter bound.  O(n d H) time.
    """
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    rng = np.random.default_rng(seed)
    max_dist = compute_max_dist(pts) if max_dist is None else float(max_dist)
    if resolution is None:
        resolution = max_dist * 1e-6
    levels = _num_levels(max_dist, resolution)
    origin = pts.min(axis=0)
    trees = []
    for _ in range(num_trees):
        shift = rng.uniform(0.0, max_dist, size=d)
        mults = (rng.integers(1, 2 ** 63, size=d, dtype=np.uint64)
                 * np.uint64(2) + np.uint64(1))
        codes = _grid_codes(pts, origin, shift, max_dist, levels, mults)
        trees.append(TreeEmbedding(codes=codes, max_dist=max_dist,
                                   num_levels=levels, dim=d, shift=shift,
                                   origin=origin, hash_mults=mults))
    return MultiTreeEmbedding(trees=tuple(trees), max_dist=max_dist,
                              num_levels=levels, dim=d, num_points=n)


# --------------------------------------------------------------------------
# Separation levels and tree distances (the CPU seeders' closed form).
# --------------------------------------------------------------------------

def sep_levels(codes_a: np.ndarray, codes_b: np.ndarray) -> np.ndarray:
    """Number of agreeing heights between code columns.

    codes_a: (H, ...) vs codes_b: (H, ...) broadcastable; returns int32 (...).
    Because grids nest, equality is prefix-closed, so the count equals the
    index of the first disagreement.
    """
    eq = codes_a == codes_b
    return eq.sum(axis=0).astype(np.int32)


def tree_dist_from_sep(sep: np.ndarray, max_dist: float, num_levels: int,
                       dim: int) -> np.ndarray:
    """Closed-form TreeDist given separation level (App. A geometry)."""
    sep = np.asarray(sep)
    scale = 2.0 * np.sqrt(dim) * max_dist
    return scale * (np.exp2(1.0 - sep) - np.exp2(1.0 - num_levels))


def multitree_dist_sq_points(emb: MultiTreeEmbedding, i: np.ndarray,
                             j: np.ndarray) -> np.ndarray:
    """MULTITREEDIST(p_i, p_j)^2 for index arrays i, j (broadcastable)."""
    best = None
    for t in emb.trees:
        sep = sep_levels(t.codes[:, i], t.codes[:, j])
        dist = tree_dist_from_sep(sep, emb.max_dist, emb.num_levels, emb.dim)
        best = dist if best is None else np.minimum(best, dist)
    return best ** 2
