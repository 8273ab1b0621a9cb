"""The plain reference: what the port has to produce, worked out again
from the same points with NumPy and plain PyTorch.  It imports nothing of
the port and takes nothing the port made; the port's outputs are only
judged against it.

* The host prepare.  The paper's aspect-ratio control (Appendix F: the
  cost of 20 random points sets a grid, and every coordinate is floored
  to it), its three randomly shifted grids (sections 2 and 3: hashed cell
  codes per level), and the p-stable LSH bucket keys (section 5 and
  Appendix D.3: 15 tables of one hash of radius 10 grid units).  Their
  random draws come from the plan's seed in the order the port documents
  (its prepare is bit-identical to the JAX package's), and the arithmetic
  is a frozen copy of that prepare's, so each value is compared exactly.
* The cost of a lane's centers: the sum over the points of the squared
  distance to the nearest center, in float64, on the device in row blocks.
* The law of the opened centers.  Algorithm 3 opens each center in
  proportion to its squared multi-tree distance w to the opened ones;
  Algorithm 4 proposes in that law and accepts with probability
  min(1, d2 / (c^2 w)), d2 the squared distance to the nearest opened
  center that shares an LSH bucket with it (+inf where none does), so it
  opens in proportion to min(w, d2 / c^2).  Replaying a lane's opened
  centers in order, the reference works out each step's law and where in
  it the center opened fell: the step's mid-distribution value (the mass
  below the center's, plus half the mass level with it, over the total),
  whose mean over the steps is 1/2 under the law.
* Centers that had no probability.  Both seeders draw a new center in
  proportion to a distance to the opened centers that is 0 exactly where a
  point shares its grid cell with an opened center (the grid's leaf cells
  are narrower than one grid unit, so only at the same quantised point):
  such a point can never be opened.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["Reference", "split_codes", "cost", "zero_probability_opens",
           "law_mid_values"]

_MIX = np.uint64(0x9E3779B97F4A7C15)
_MIX_I64 = int(_MIX.view(np.int64))
_BLOCK = 1 << 18          # rows a block of the codes worked out on a device
_ROUGH_CENTERS = 20       # Appendix F's rough solution
_CHUNK = 65536            # the rows of one block of its cost


def split_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 codes -> (low, high) int32 planes, as the card holds them."""
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    hi = (codes >> np.uint64(32)).astype(np.int64).astype(np.int32)
    return lo, hi


def _quantize(pts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n, d = pts.shape
    idx = rng.choice(n, size=min(_ROUGH_CENTERS, n), replace=False)
    ctr = pts[idx]
    c_sq = (ctr ** 2).sum(axis=1)
    d2 = np.empty(n, dtype=np.float64)
    for lo in range(0, n, _CHUNK):
        x = pts[lo: lo + _CHUNK]
        dd = (x ** 2).sum(axis=1)[:, None] - 2.0 * (x @ ctr.T) + c_sq[None, :]
        d2[lo: lo + _CHUNK] = np.maximum(dd.min(axis=1), 0.0)
    est = float(d2.sum())
    if est <= 0:
        return pts.copy()
    scaling = np.sqrt(est / (n * d)) / 200.0
    return np.floor(pts / scaling)


class _Trees:
    """The shifted grids over quantised points `q`, drawn from `seed`."""

    def __init__(self, q: np.ndarray, seed: int, resolution: float,
                 trees: int):
        n, d = q.shape
        rng = np.random.default_rng(seed)
        far = np.sqrt(np.maximum(((q - q[0]) ** 2).sum(axis=1), 0.0)).max()
        self.max_dist = float(2.0 * far) if far > 0 else 1.0
        h = int(np.ceil(np.log2(max(2.0 * self.max_dist
                                    / max(resolution, 1e-300), 2.0))))
        self.num_levels = max(2, min(h + 1, 60))
        self.origin = q.min(axis=0)
        self.d = d
        self.shifts, self.mults = [], []
        for _ in range(trees):
            self.shifts.append(rng.uniform(0.0, self.max_dist, size=d))
            self.mults.append(rng.integers(1, 2 ** 63, size=d,
                                           dtype=np.uint64)
                              * np.uint64(2) + np.uint64(1))

    @property
    def statics(self) -> tuple:
        """(2 sqrt(d) MaxDist, H, 16 d MaxDist^2): the sweep's and the
        sampler's constants."""
        return (2.0 * np.sqrt(self.d) * self.max_dist, self.num_levels,
                16.0 * self.d * self.max_dist ** 2)

    def codes(self, rows: np.ndarray) -> np.ndarray:
        """(trees, H - 1, m) uint64 cell codes of the quantised `rows`, the
        trivial root level left out."""
        h = self.num_levels
        deep_side = 2.0 * self.max_dist / (1 << (h - 1))
        out = np.empty((len(self.shifts), h - 1, len(rows)), dtype=np.uint64)
        with np.errstate(over="ignore"):
            for t, (shift, mults) in enumerate(zip(self.shifts, self.mults)):
                cell_deep = np.floor(((rows - self.origin) + shift)
                                     / deep_side).astype(np.uint64)
                for lvl in range(1, h):
                    cell = cell_deep >> np.uint64(h - 1 - lvl)
                    code = (cell * mults).sum(axis=-1, dtype=np.uint64)
                    out[t, lvl - 1] = code * _MIX + np.uint64(lvl)
        return out

    def codes_on(self, q: torch.Tensor) -> torch.Tensor:
        """`codes` of all quantised rows `q` (n, d) float64 on their
        device, as int64 (the same bits as the uint64 codes)."""
        h, n = self.num_levels, q.shape[0]
        deep_side = 2.0 * self.max_dist / (1 << (h - 1))
        origin = torch.as_tensor(self.origin, device=q.device)
        out = torch.empty((len(self.shifts), h - 1, n), dtype=torch.int64,
                          device=q.device)
        for t, (shift, mults) in enumerate(zip(self.shifts, self.mults)):
            shift = torch.as_tensor(shift, device=q.device)
            mults = _i64(mults, q.device)
            for lo in range(0, n, _BLOCK):
                cell_deep = torch.floor(((q[lo: lo + _BLOCK] - origin)
                                         + shift) / deep_side).long()
                for lvl in range(1, h):
                    code = ((cell_deep >> (h - 1 - lvl)) * mults).sum(dim=1)
                    out[t, lvl - 1, lo: lo + _BLOCK] = code * _MIX_I64 + lvl
        return out


def _i64(u: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(u, dtype=np.uint64).view(np.int64),
                           device=device)


class _Lsh:
    """The p-stable hash family, drawn from `seed`."""

    def __init__(self, d: int, r: float, seed: int, tables: int,
                 hashes: int):
        rng = np.random.default_rng(seed)
        self.r, self.tables, self.hashes = float(r), tables, hashes
        self.proj = rng.standard_normal((tables * hashes, d))
        self.bias = rng.uniform(0.0, self.r, size=tables * hashes)
        self.key_mults = rng.integers(1, 2 ** 62, size=(tables, hashes),
                                      dtype=np.uint64) | np.uint64(1)
        self.key_salt = rng.integers(0, 2 ** 62, size=tables,
                                     dtype=np.uint64)

    def keys(self, rows: np.ndarray) -> np.ndarray:
        """(tables, m) uint64 bucket keys of the quantised `rows`."""
        h = np.floor((rows @ self.proj.T + self.bias) / self.r)
        h = h.astype(np.int64).astype(np.uint64).reshape(
            -1, self.tables, self.hashes)
        with np.errstate(over="ignore"):
            k = (h * self.key_mults[None]).sum(axis=-1, dtype=np.uint64)
            return ((k + self.key_salt[None]) * _MIX).T

    def keys_on(self, q: torch.Tensor) -> torch.Tensor:
        """`keys` of all quantised rows `q` on their device, as int64."""
        proj = torch.as_tensor(self.proj, device=q.device)
        bias = torch.as_tensor(self.bias, device=q.device)
        h = torch.floor((q @ proj.T + bias) / self.r).long().reshape(
            -1, self.tables, self.hashes)
        k = (h * _i64(self.key_mults, q.device)[None]).sum(dim=-1)
        return ((k + _i64(self.key_salt, q.device)[None]) * _MIX_I64).T


class Reference:
    """The prepare of `points` (n, d) float64 under a configuration's
    ``"cluster"`` and ``"prepare"`` sections and the plan's seed, each part
    worked out on first use."""

    def __init__(self, points: np.ndarray, cluster: dict, prepare: dict,
                 spec_seed: int):
        self.points = points
        self.seeder = cluster["seeder"]
        self.quantized = bool(cluster.get("quantize", True))
        self.prepare = prepare
        self.spec_seed = int(spec_seed)

    @functools.cached_property
    def _draws(self) -> tuple:
        """(quantised points, tree seed, LSH seed or None), drawn in the
        plan's order: the rough centers, then the seeder's prepare seeds."""
        rng = np.random.default_rng(self.spec_seed)
        q = _quantize(self.points, rng) if self.quantized else self.points
        if self.seeder == "rejection":
            inner = np.random.default_rng(int(rng.integers(2 ** 31)))
            return q, int(inner.integers(2 ** 31)), int(inner.integers(
                2 ** 31))
        if self.seeder == "fastkmeans++":
            return q, int(rng.integers(2 ** 31)), None
        raise ValueError(f"no reference prepare for {self.seeder!r}")

    @property
    def q(self) -> np.ndarray:
        """The quantised points, (n, d) float64."""
        return self._draws[0]

    @functools.cached_property
    def trees(self) -> _Trees:
        return _Trees(self.q, self._draws[1],
                      float(self.prepare["resolution"]),
                      int(self.prepare["trees"]))

    @functools.cached_property
    def lsh(self):
        """The LSH family, or None for a seeder that has none."""
        if self._draws[2] is None:
            return None
        cfg = self.prepare["lsh"]
        return _Lsh(self.points.shape[1],
                    float(cfg["radius"]) * float(self.prepare["resolution"]),
                    self._draws[2], int(cfg["tables"]), int(cfg["hashes"]))


def cost(points: torch.Tensor, centers: torch.Tensor,
         block: int = _CHUNK) -> float:
    """sum_x min_c ||x - c||^2 over `points` (n, d) float64 and `centers`
    (k, d) float64, on their device in row blocks."""
    c_sq = (centers * centers).sum(dim=1)
    total = torch.zeros((), dtype=torch.float64, device=points.device)
    for lo in range(0, points.shape[0], block):
        x = points[lo: lo + block]
        d2 = ((x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ centers.T)
              + c_sq[None, :])
        total += d2.min(dim=1).values.clamp_min(0.0).sum()
    return float(total)


def zero_probability_opens(q: np.ndarray, indices: np.ndarray) -> int:
    """How many of a lane's centers (indices into `q`, in the order opened)
    repeat the quantised point of an earlier one."""
    rows = q[np.asarray(indices, dtype=np.int64)]
    return len(rows) - len(np.unique(rows, axis=0))


def law_mid_values(ref: Reference, lanes, c: float, device) -> np.ndarray:
    """The mid-distribution values of the centers that `lanes` (each the
    indices of one lane, in the order opened) opened after their first,
    under the reference's law at each step: Algorithm 3's (in proportion
    to w) for the fastkmeans++ seeder, Algorithm 4's (in proportion to
    min(w, d2 / c^2)) for the rejection seeder.  Float64 on `device`."""
    q = torch.as_tensor(ref.q, dtype=torch.float64, device=device)
    n = q.shape[0]
    codes = ref.trees.codes_on(q)
    scale, levels, m_init = ref.trees.statics
    agree = torch.arange(levels, dtype=torch.float64, device=device)
    dist_sq = (scale * (torch.exp2(-agree) - 2.0 ** (1 - levels))
               ).clamp_min(0.0) ** 2
    keys = ref.lsh.keys_on(q) if ref.lsh is not None else None
    q_sq = (q * q).sum(dim=1)
    mids = []
    for idx in lanes:
        w = torch.full((n,), m_init, dtype=torch.float64, device=device)
        d2_lsh = torch.full_like(w, float("inf"))
        for i, x in enumerate(int(v) for v in idx):
            if i > 0:
                law = w if keys is None else torch.minimum(w, d2_lsh / c ** 2)
                at = law[x]
                below = torch.where(law < at, law, 0.0).sum()
                level = torch.where(law == at, law, 0.0).sum()
                mids.append((below + 0.5 * level) / law.sum())
            for tree in codes:
                same = (tree == tree[:, x: x + 1]).sum(dim=0)
                w = torch.minimum(w, dist_sq[same])
            if keys is not None:
                hit = (keys == keys[:, x: x + 1]).any(dim=0)
                d2 = (q_sq - 2.0 * (q @ q[x]) + q_sq[x]).clamp_min(0.0)
                d2_lsh = torch.where(hit, torch.minimum(d2_lsh, d2), d2_lsh)
    if not mids:
        return np.zeros(0)
    return torch.stack(mids).cpu().numpy()
