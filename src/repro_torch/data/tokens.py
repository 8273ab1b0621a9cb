"""Deterministic, resumable synthetic LM token pipeline.

A copy of the JAX package's `data/tokens.py` (NumPy only, so the port
imports nothing of that package): the same seed and cursor give the same
batches bit for bit in both packages.

Documents are sampled from a Zipf-like unigram distribution with Markov
bigram mixing (so the loss actually decreases during the example training
runs), concatenated with EOS separators, and packed into fixed-length
sequences.  The stream is a pure function of (seed, cursor): `state()`
returns the cursor, `seek(state)` resumes exactly — the property the
trainer's checkpoint/restart relies on.

Sharding: each data-parallel replica constructs the stream with its
(shard_id, num_shards) and reads disjoint slices of the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream", "synthetic_batch_for"]


@dataclasses.dataclass
class TokenStreamState:
    cursor: int


class TokenStream:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch: int,
        *,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        eos: int = 0,
    ):
        assert batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = batch
        self.local_batch = batch // num_shards
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.eos = eos
        self.cursor = 0
        # Fixed unigram (Zipf) + a small deterministic bigram shift table.
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks ** 1.1)
        self._unigram /= self._unigram.sum()
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        self._shift = rng.integers(1, vocab_size, size=997)

    # -- resumability ------------------------------------------------------

    def state(self) -> dict:
        return {"cursor": int(self.cursor), "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def seek(self, state: dict) -> None:
        assert state["seed"] == self.seed, "stream seed mismatch"
        self.cursor = int(state["cursor"])

    # -- batches ------------------------------------------------------------

    def next_batch(self) -> np.ndarray:
        """(local_batch, seq) int32; advances the cursor by one global batch."""
        out = np.empty((self.local_batch, self.seq), dtype=np.int32)
        for i in range(self.local_batch):
            global_row = self.cursor * self.global_batch + (
                self.shard_id * self.local_batch + i
            )
            out[i] = self._row(global_row)
        self.cursor += 1
        return out

    def _row(self, global_row: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ global_row)
        toks = rng.choice(self.vocab, size=self.seq, p=self._unigram)
        # Markov mixing: token t is shifted by a function of its predecessor,
        # giving learnable bigram structure.
        shifted = (toks[1:] + self._shift[toks[:-1] % 997]) % self.vocab
        mix = rng.random(self.seq - 1) < 0.5
        toks[1:] = np.where(mix, shifted, toks[1:])
        # EOS boundaries every ~512 tokens.
        doc_len = 256 + (global_row % 512)
        toks[::doc_len] = self.eos
        return toks.astype(np.int32)


def synthetic_batch_for(cfg, shape, *, seed: int = 0, rng=None) -> dict:
    """One synthetic global batch matching `make_batch_specs` (for tests)."""
    rng = rng or np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        fd = cfg.frontend_dim or cfg.d_model
        return {
            "embeddings": rng.normal(size=(b, s, fd)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        }
    if cfg.family == "vlm":
        fd = cfg.frontend_dim or cfg.d_model
        p = min(cfg.prefix_len, s // 2) or s // 2
        return {
            "patches": rng.normal(size=(b, p, fd)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s - p)).astype(np.int32),
        }
    stream = TokenStream(cfg.vocab_size, s, b, seed=seed)
    return {"tokens": stream.next_batch()}
