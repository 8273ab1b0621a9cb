"""Monotone p-stable LSH bucket keys (paper §5 + App. D).

Hash family (Datar et al. 2004): ``h(p) = floor((a . p + b) / r)`` with
``a ~ N(0, I_d)`` and ``b ~ U[0, r)``; ``num_tables`` tables, each keyed by
``hashes_per_table`` concatenated hashes folded into one uint64 with
per-table random mixers (App. D.3 defaults: 15 tables, one hash each).

NumPy only.  The port keeps the part of the JAX package's `MonotoneLSH`
that the device seeders use: the hash family, drawn from the seed in the
same order, and `hash_keys`, so the keys are bit-identical.  The insert and
query structure is the CPU seeder's and is not ported: on the device the
nearest colliding center is the `lsh_bucket_accept` kernel's job.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MonotoneLSH"]

_MIX = np.uint64(0x9E3779B97F4A7C15)


class MonotoneLSH:
    """Euclidean LSH hash family with precomputable bucket keys."""

    def __init__(self, dim: int, *, r: float = 10.0, num_tables: int = 15,
                 hashes_per_table: int = 1, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.dim = dim
        self.r = float(r)
        self.L = num_tables
        self.m = hashes_per_table
        # (L*m, d) projections; one matmul hashes a point for all tables.
        self.proj = rng.standard_normal((self.L * self.m, dim))
        self.bias = rng.uniform(0.0, self.r, size=self.L * self.m)
        self.key_mults = rng.integers(1, 2 ** 62, size=(self.L, self.m),
                                      dtype=np.uint64) | np.uint64(1)
        self.key_salt = rng.integers(0, 2 ** 62, size=self.L,
                                     dtype=np.uint64)

    def hash_keys(self, ps: np.ndarray) -> np.ndarray:
        """Bucket keys for a batch of points: (batch, L) uint64."""
        ps = np.asarray(ps, dtype=np.float64)
        h = np.floor((ps @ self.proj.T + self.bias) / self.r)
        h = h.astype(np.int64).astype(np.uint64).reshape(-1, self.L, self.m)
        with np.errstate(over="ignore"):
            k = (h * self.key_mults[None]).sum(axis=-1, dtype=np.uint64)
            return (k + self.key_salt[None]) * _MIX
