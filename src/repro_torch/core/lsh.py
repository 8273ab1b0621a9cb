"""Monotone p-stable LSH approximate nearest neighbour (paper §5 + App. D).

Hash family (Datar et al. 2004): ``h(p) = floor((a . p + b) / r)`` with
``a ~ N(0, I_d)`` and ``b ~ U[0, r)``; ``num_tables`` tables, each keyed by
``hashes_per_table`` concatenated hashes folded into one uint64 with
per-table random mixers (App. D.3 defaults: 15 tables, one hash each).

NumPy only, a copy of the JAX package's `MonotoneLSH`: the hash family is
drawn from the seed in the same order, so `hash_keys` (which the device
seeders precompute for every point) is bit-identical, and the insert and
query structure is the CPU rejection seeder's.  On the card the nearest
colliding center is the `lsh_bucket_accept` kernel's job.

Monotonicity (Theorem 5.1): the distance between p and Query(p) is
non-increasing under insertions.  The paper returns the *first* colliding
bucket entry; this returns the *minimum-distance* colliding entry, which
dominates that guarantee and is trivially monotone (candidate sets only
grow).  The tables are one flat sorted array of (bucket key, center id)
pairs probed with two vectorised ``searchsorted`` calls; centers inserted
since the last rebuild sit in a small pending buffer that every query
checks exactly.  A query with no bucket collision reports +inf.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MonotoneLSH"]

_MIX = np.uint64(0x9E3779B97F4A7C15)


class MonotoneLSH:
    """Euclidean LSH over a growing set of inserted points (the centers)."""

    def __init__(self, dim: int, *, r: float = 10.0, num_tables: int = 15,
                 hashes_per_table: int = 1, seed: int = 0,
                 capacity: int = 1024, rebuild_every: int = 32):
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
        self._pts = np.empty((capacity, dim), dtype=np.float64)
        self._sq = np.empty(capacity, dtype=np.float64)
        self.size = 0
        self.rebuild_every = rebuild_every
        # CSR state: sorted keys + aligned center ids for [0, csr_size).
        self._csr_keys = np.empty(0, dtype=np.uint64)
        self._csr_ids = np.empty(0, dtype=np.int64)
        self._csr_size = 0  # number of inserted points reflected in the CSR
        self._pending_keys = np.empty((rebuild_every, self.L),
                                      dtype=np.uint64)

    def hash_keys(self, ps: np.ndarray) -> np.ndarray:
        """Bucket keys for a batch of points: (batch, L) uint64."""
        ps = np.asarray(ps, dtype=np.float64)
        h = np.floor((ps @ self.proj.T + self.bias) / self.r)
        h = h.astype(np.int64).astype(np.uint64).reshape(-1, self.L, self.m)
        with np.errstate(over="ignore"):
            k = (h * self.key_mults[None]).sum(axis=-1, dtype=np.uint64)
            return (k + self.key_salt[None]) * _MIX

    def _keys(self, ps: np.ndarray) -> np.ndarray:
        """Bucket keys of float64 points (the JAX package's name)."""
        return self.hash_keys(ps)

    def insert(self, p: np.ndarray) -> int:
        """Insert a point; returns its id.  Amortised O(L m d)."""
        p = np.asarray(p, dtype=np.float64)
        if self.size == self._pts.shape[0]:
            self._pts = np.concatenate([self._pts, np.empty_like(self._pts)])
            self._sq = np.concatenate([self._sq, np.empty_like(self._sq)])
        idx = self.size
        self._pts[idx] = p
        self._sq[idx] = p @ p
        self._pending_keys[self.size - self._csr_size] = self._keys(p[None])[0]
        self.size += 1
        if self.size - self._csr_size >= self.rebuild_every:
            self._rebuild()
        return idx

    def _rebuild(self) -> None:
        keys = self._keys(self._pts[: self.size]).ravel()  # (size*L,)
        ids = np.repeat(np.arange(self.size, dtype=np.int64), self.L)
        order = np.argsort(keys, kind="stable")
        self._csr_keys = keys[order]
        self._csr_ids = ids[order]
        self._csr_size = self.size

    def query(self, p: np.ndarray) -> tuple[int, float]:
        """(argmin id, distance^2) of one query point."""
        ids, d2 = self.query_batch(np.asarray(p, dtype=np.float64)[None])
        return int(ids[0]), float(d2[0])

    def query_batch(self, ps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(argmin id, distance^2) per query; +inf and -1 on a complete
        miss (no inserted center shares a bucket with the query)."""
        if self.size == 0:
            raise ValueError("query on empty LSH structure")
        ps = np.asarray(ps, dtype=np.float64)
        b = len(ps)
        best_d2 = np.full(b, np.inf)
        best_id = np.full(b, -1, dtype=np.int64)

        if self._csr_size > 0:
            keys = self._keys(ps).ravel()  # (b*L,)
            lo = np.searchsorted(self._csr_keys, keys, side="left")
            hi = np.searchsorted(self._csr_keys, keys, side="right")
            counts = hi - lo
            total = int(counts.sum())
            if total:
                starts = np.repeat(lo, counts)
                offs = np.arange(total) - np.repeat(counts.cumsum() - counts,
                                                    counts)
                cand = self._csr_ids[starts + offs]
                qs = np.repeat(np.arange(b * self.L) // self.L, counts)
                diff = ps[qs] - self._pts[cand]
                d2 = np.einsum("ij,ij->i", diff, diff)
                np.minimum.at(best_d2, qs, d2)
                is_best = d2 <= best_d2[qs]
                best_id[qs[is_best]] = cand[is_best]

        # Pending (not yet in the CSR) centers: the same bucket-collision
        # rule by a direct key comparison, so a rebuild never changes any
        # query's candidate set.
        if self.size > self._csr_size:
            pend = self._pts[self._csr_size: self.size]
            pkeys = self._pending_keys[: self.size - self._csr_size]
            keys_q = self._keys(ps)  # (b, L)
            coll = (keys_q[:, None, :] == pkeys[None, :, :]).any(-1)  # (b, p)
            if coll.any():
                d2p = ((ps ** 2).sum(axis=1)[:, None]
                       - 2.0 * (ps @ pend.T)
                       + self._sq[self._csr_size: self.size][None, :])
                d2p = np.where(coll, np.maximum(d2p, 0.0), np.inf)
                jp = d2p.argmin(axis=1)
                mp = d2p[np.arange(b), jp]
                better = mp < best_d2
                best_d2[better] = mp[better]
                best_id[better] = jp[better] + self._csr_size
        return best_id, np.maximum(best_d2, 0.0)
