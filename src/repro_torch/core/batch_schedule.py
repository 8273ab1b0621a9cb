"""Adaptive candidate-batch scheduling for the rejection seeder.

A round draws a block of B i.i.d. candidates from the current D^2
distribution, evaluates every acceptance test and opens the first accept,
discarding the rest.  Expected candidates until the first accept is 1/p,
so a block of ``safety / p`` lanes makes a fully missed round
``exp(-safety)``-rare while bounding the wasted tail.  The acceptance rate
p drifts as centers open, hence a schedule: start from a cost-model prior,
measure p per round, and step the block size geometrically toward
``safety / p_hat`` on a static power-of-two ladder of buckets
``min_batch, 2*min_batch, ..., max_batch``.

A copy of the JAX package's `BatchSchedule` with its traced maths as plain
Python scalars: the port's seeder loop runs on the host, one round at a
time, so the bucket index and the rate EMA are Python numbers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["BatchSchedule", "shape_bucket"]


def shape_bucket(n: int, *, min_bucket: int = 1024) -> int:
    """Smallest power-of-two ladder rung ``>= n`` (floored at `min_bucket`):
    `BatchSchedule.buckets`' ladder applied to array shapes."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    ladder = BatchSchedule(
        min_batch=min_bucket,
        max_batch=max(min_bucket, 1 << math.ceil(math.log2(n))),
    )
    return ladder.buckets()[ladder.index_of(n)]


@dataclasses.dataclass(frozen=True)
class BatchSchedule:
    """Geometric candidate-batch schedule for speculative rejection.

    min_batch / max_batch: the bucket ladder endpoints (max is the cap).
    safety: target expected accepts per round (miss ~ ``exp(-safety)``).
    ema: weight of the newest per-round acceptance observation.
    prior_accept: acceptance-rate prior before any measurement.
    """

    min_batch: int = 32
    max_batch: int = 512
    safety: float = 3.0
    ema: float = 0.5
    prior_accept: float = 0.25

    def __post_init__(self):
        if self.min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {self.min_batch}")
        if self.max_batch < self.min_batch:
            raise ValueError(
                f"max_batch {self.max_batch} < min_batch {self.min_batch}")
        if not (0.0 < self.ema <= 1.0):
            raise ValueError(f"ema must be in (0, 1], got {self.ema}")
        if self.safety <= 0.0 or self.prior_accept <= 0.0:
            raise ValueError("safety and prior_accept must be positive")

    @classmethod
    def fixed(cls, batch: int) -> "BatchSchedule":
        """A one-bucket schedule: the legacy ``batch: int`` behaviour."""
        return cls(min_batch=batch, max_batch=batch)

    def buckets(self) -> tuple[int, ...]:
        """Power-of-two ladder ``min, 2 min, ... , max`` (max always last)."""
        out, b = [], self.min_batch
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)

    def _ideal(self, acc_rate: float) -> float:
        """Cost-model block size ``safety / p``, with p floored at
        ``1 / (4 max_batch)`` (below it the cap binds anyway)."""
        return self.safety / max(acc_rate, 1.0 / (4.0 * self.max_batch))

    def initial(self, n: int, k: int, num_tiles: int,
                acc_rate: float | None = None) -> int:
        """Cost-model initial batch: ``safety / p`` lanes inflated by the
        per-round overhead (log2 of the tile count and of k), clamped to the
        ladder and, unless the ladder's floor is larger, to n."""
        p = self.prior_accept if acc_rate is None else max(float(acc_rate),
                                                          1e-6)
        overhead = math.log2(max(num_tiles, 2)) + math.log2(max(k, 2))
        b = (self.safety / p) * (1.0 + overhead / 8.0)
        b = min(b, float(max(n, 1)))
        return self._snap(b)

    def propose(self, prev_batch: int, acc_rate: float) -> int:
        """The CPU rejection seeder's next block: one geometric step toward
        ``safety / p``; a bucket value, never above ``max_batch``, monotone
        non-increasing in ``acc_rate``.  ``safety / p`` is computed in
        float32, as the JAX package's traced `_ideal` is, so both packages'
        CPU seeders take the same blocks."""
        p = max(np.float32(acc_rate), np.float32(1.0 / (4.0 * self.max_batch)))
        ideal = float(np.float32(self.safety) / p)
        lo = max(prev_batch / 2.0, float(self.min_batch))
        hi = min(prev_batch * 2.0, float(self.max_batch))
        return self._snap(min(max(ideal, lo), hi))

    def target_index(self, acc_rate: float) -> int:
        """Index of the smallest bucket >= ``safety / p``; monotone
        non-increasing in ``acc_rate``."""
        ideal = self._ideal(acc_rate)
        idx = math.ceil(math.log2(max(ideal / self.min_batch, 1.0)))
        return min(max(idx, 0), len(self.buckets()) - 1)

    def next_index(self, idx: int, acc_rate: float) -> int:
        """Step toward `target_index`, at most one ladder rung per round."""
        nxt = min(max(self.target_index(acc_rate), idx - 1), idx + 1)
        return min(max(nxt, 0), len(self.buckets()) - 1)

    def update_rate(self, acc_ema: float, observed: float) -> float:
        """EMA blend of the newest per-round acceptance observation."""
        return self.ema * observed + (1.0 - self.ema) * acc_ema

    def index_of(self, batch: int) -> int:
        """Index of the smallest bucket >= ``batch``."""
        for j, b in enumerate(self.buckets()):
            if b >= batch:
                return j
        return len(self.buckets()) - 1

    def _snap(self, b: float) -> int:
        """Clamp to [min_batch, max_batch] and snap up to the ladder."""
        buckets = self.buckets()
        b = min(max(b, float(self.min_batch)), float(self.max_batch))
        return buckets[self.index_of(int(math.ceil(b)))]
