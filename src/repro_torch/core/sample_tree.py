"""The sample-tree: a balanced binary tree over points with subtree weights.

Paper §4: a leaf per point holds ``w_x = MultiTreeDist(x, S)^2``; internal
nodes hold subtree sums; sampling descends root->leaf choosing children in
proportion to their weights, and a weight update propagates to the root.

The tree is a flat array heap of size 2*cap (1-indexed, leaves at
[cap, cap+n)).  Three forms, as in the JAX package:

- `SampleTree`: NumPy, float64, exact — the host reference.
- `SampleTreeTorch`: the same heap as an f32 tensor on any device; its
  `scatter_update` fixes only the touched ancestors (their children's sum,
  level by level, clamped to >= 0), never an O(n) rebuild; its `descend`
  walks B heaps at once, a lane per draw (`sample` is the one-heap case).
- `TiledSampleTree`: the device seeders' two-level sampler — a coarse heap
  over per-tile weight sums (rebuilt from the sweep kernel's tile-sum
  epilogue) plus an exact intra-tile cumsum over the dense weights.  Its
  `sample_lanes` draws the blocks of B independent lanes (one heap and one
  weight row each, the lane-batched seeders' form) in one descent.

Draws take an explicit `torch.Generator` on the tensors' device, one per
lane.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SampleTree", "SampleTreeTorch", "TiledSampleTree"]


def _capacity(n: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(n, 2)))))


class SampleTree:
    """NumPy flat-heap weighted sampler (exact, float64)."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.float64)
        n = w.shape[0]
        cap = _capacity(n)
        self.n = n
        self.cap = cap
        self.levels = int(np.log2(cap))
        heap = np.zeros(2 * cap, dtype=np.float64)
        heap[cap: cap + n] = w
        idx = cap
        while idx > 1:
            half = idx // 2
            heap[half:idx] = heap[idx: 2 * idx: 2] + heap[idx + 1: 2 * idx: 2]
            idx = half
        self.heap = heap

    @property
    def total(self) -> float:
        return float(self.heap[1])

    def leaf_weights(self) -> np.ndarray:
        return self.heap[self.cap: self.cap + self.n]

    def update(self, indices: np.ndarray, new_weights: np.ndarray) -> None:
        """Set w[indices] = new_weights (unique indices) and fix every
        ancestor sum, one scatter-add per level, clamped to >= 0."""
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size == 0:
            return
        new = np.asarray(new_weights, dtype=np.float64)
        leaf = idx + self.cap
        delta = new - self.heap[leaf]
        self.heap[leaf] = new
        anc = leaf >> 1
        for _ in range(self.levels):
            np.add.at(self.heap, anc, delta)
            np.maximum.at(self.heap, anc, 0.0)
            anc = anc >> 1

    def sample(self, rng: np.random.Generator) -> int:
        """Draw one leaf index with probability w_x / total.  O(log n)."""
        u = rng.uniform(0.0, self.heap[1])
        v = 1
        while v < self.cap:
            left = 2 * v
            wl = self.heap[left]
            if u < wl:
                v = left
            else:
                u -= wl
                v = left + 1
        return int(v - self.cap)

    def sample_batch(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """Draw `size` i.i.d. leaves; vectorised descent."""
        u = rng.uniform(0.0, self.heap[1], size=size)
        v = np.ones(size, dtype=np.int64)
        for _ in range(self.levels):
            left = 2 * v
            wl = self.heap[left]
            go_left = u < wl
            u = np.where(go_left, u, u - wl)
            v = np.where(go_left, left, left + 1)
        return v - self.cap


class SampleTreeTorch:
    """Flat-heap sampler over `n` leaves as an f32 tensor (fixed shapes).

    The heap is a plain (2*cap,) tensor the caller owns; methods return the
    new heap (`scatter_update` also updates it in place).
    """

    def __init__(self, n: int):
        self.n = n
        self.cap = _capacity(n)
        self.levels = int(np.log2(self.cap))

    def init(self, weights: torch.Tensor) -> torch.Tensor:
        """Build the heap from scratch — O(n); loop preambles only.  A
        leading axis of `weights` (lanes) gives one heap per row; each is
        the heap of that row alone, bit for bit (elementwise adds)."""
        heap = torch.zeros(weights.shape[:-1] + (2 * self.cap,),
                           dtype=torch.float32, device=weights.device)
        heap[..., self.cap: self.cap + self.n] = weights.to(torch.float32)
        idx = self.cap
        while idx > 1:
            half = idx // 2
            heap[..., half:idx] = (heap[..., idx: 2 * idx: 2]
                                   + heap[..., idx + 1: 2 * idx: 2])
            idx = half
        return heap

    def scatter_update(self, heap: torch.Tensor, indices: torch.Tensor,
                       new_weights: torch.Tensor) -> torch.Tensor:
        """Set w[indices] = new_weights (unique indices) and fix ONLY the
        touched ancestors, in place: O(U log n) for U leaves.

        The JAX package scatter-adds each leaf's delta into its ancestors.
        Here each touched ancestor is set to the sum of its two children
        instead, as `init` computes it: a scatter-add on a CUDA device
        sums colliding ancestors with atomics in no fixed order, so one
        seed would not replay the same draws, and its f32 deltas drift
        from the leaves.  The result is bit-identical to `init` of the new
        weights.  Every internal level is still clamped to >= 0.
        """
        leaf = indices.to(torch.int64) + self.cap
        heap[leaf] = new_weights.to(torch.float32)
        anc = leaf >> 1
        for _ in range(self.levels):
            heap[anc] = (heap[2 * anc] + heap[2 * anc + 1]).clamp_min(0.0)
            anc = anc >> 1
        return heap

    def sample(self, heap: torch.Tensor, generator: torch.Generator,
               size: int) -> torch.Tensor:
        """Draw `size` i.i.d. leaf indices in proportion to leaf weights:
        the one-heap case of `descend`."""
        u = torch.rand(size, generator=generator, dtype=torch.float32,
                       device=heap.device)
        return self.descend(heap[None], u, torch.zeros(
            size, dtype=torch.int64, device=heap.device))

    def descend(self, heaps: torch.Tensor, u: torch.Tensor,
                lanes: torch.Tensor) -> torch.Tensor:
        """The leaves that uniforms `u` (S,) in [0, 1) pick, draw s under
        the heap of lane ``lanes[s]``: heaps (B, 2 cap), `lanes` (S,)
        int64.  Elementwise over the draws, so each lane's leaves are
        those of its heap alone, bit for bit."""
        flat = heaps.reshape(-1)
        base = lanes * heaps.shape[1]
        u = u * heaps[:, 1][lanes]
        v = torch.ones_like(lanes)
        for _ in range(self.levels):
            left = 2 * v
            wl = flat[base + left]
            go_left = u < wl
            u = torch.where(go_left, u, u - wl)
            v = torch.where(go_left, left, left + 1)
        return (v - self.cap).clamp(0, self.n - 1)


class TiledSampleTree:
    """Two-level sampler: coarse flat heap over tile sums + dense weights.

    The leaf level is the dense weight vector padded to a multiple of
    `tile`; the heap spans only the T = n_pad / tile tile sums.  Sampling
    descends the coarse heap to a tile (O(log T)) and resolves the point
    with one exact cumsum over the tile: a zero-weight leaf, padding
    included, is never chosen.
    """

    def __init__(self, n: int, tile: int = 512):
        self.n = n
        self.tile = tile
        self.num_tiles = -(-n // tile)
        self.n_pad = self.num_tiles * tile
        self.coarse = SampleTreeTorch(self.num_tiles)

    def tile_sums(self, w_pad: torch.Tensor) -> torch.Tensor:
        """(n_pad,) weights -> (T,) per-tile sums."""
        return w_pad.reshape(self.num_tiles, self.tile).sum(dim=1)

    def init(self, w_pad: torch.Tensor) -> torch.Tensor:
        """Build the coarse heap from scratch — O(T); loop preambles only."""
        return self.coarse.init(self.tile_sums(w_pad))

    def refresh(self, heap: torch.Tensor,
                tile_sums: torch.Tensor) -> torch.Tensor:
        """Per-center update from the kernels' tile sums ((T,), or (B, T)
        for B lanes' heaps).

        A sweep changes every tile sum, so this is `scatter_update` of all
        T leaves, which equals a rebuild bit for bit; the rebuild takes
        fewer launches (two per level).  `heap` is replaced, not updated.
        """
        del heap
        return self.coarse.init(tile_sums)

    def total(self, heap: torch.Tensor) -> torch.Tensor:
        return heap[1]

    def sample(self, heap: torch.Tensor, w_pad: torch.Tensor,
               generator: torch.Generator, size: int) -> torch.Tensor:
        """Draw `size` i.i.d. point indices in proportion to `w_pad`: the
        one-lane case of `sample_lanes`."""
        lanes = torch.zeros(size, dtype=torch.int64, device=w_pad.device)
        return self.sample_lanes(heap[None], w_pad[None], [generator],
                                 [size], lanes)

    def sample_lanes(self, heaps: torch.Tensor, w_pad: torch.Tensor,
                     generators, sizes, lanes: torch.Tensor) -> torch.Tensor:
        """Draw `sizes[j]` i.i.d. point indices of lane j in proportion to
        its weights `w_pad[j]`, under its heap `heaps[j]`, for every lane
        at once: heaps (B, 2 cap), w_pad (B, n_pad); `lanes` (S,) int64 is
        the lane of each draw, the lanes' blocks in lane order (S the sum
        of `sizes`; a lane of size 0 draws nothing).  Returns (S,) indices.

        Lane j draws from `generators[j]` exactly what a one-lane call
        draws, in its order: `sizes[j]` uniforms for the descent, then
        `sizes[j]` for the position in the tile.  The descent, the gathers
        and the comparisons are elementwise over all lanes, so each lane's
        indices are the one-lane call's, bit for bit.  The intra-tile
        cumsum runs per lane block: on the card a cumsum's rounding may
        depend on how many rows it is given.
        """
        dev = w_pad.device
        u_tile, u_leaf = [], []
        for j, size in enumerate(sizes):
            if size:
                for draws in (u_tile, u_leaf):
                    draws.append(torch.rand(size, generator=generators[j],
                                            dtype=torch.float32, device=dev))
        u_tile, u_leaf = (d[0] if len(d) == 1 else torch.cat(d)
                          for d in (u_tile, u_leaf))
        return self.locate(heaps, w_pad, u_tile, u_leaf, sizes, lanes)

    def locate(self, heaps: torch.Tensor, w_pad: torch.Tensor,
               u_tile: torch.Tensor, u_leaf: torch.Tensor, sizes,
               lanes: torch.Tensor) -> torch.Tensor:
        """The point indices that given uniforms pick: `sample_lanes`
        after its draws, u_tile and u_leaf (S,) in [0, 1) on the weights'
        device, one pair a draw, the lanes' blocks in lane order."""
        tiles = self.coarse.descend(heaps, u_tile, lanes)
        wt = w_pad.reshape(w_pad.shape[0], self.num_tiles,
                           self.tile)[lanes, tiles]                  # (S, tile)
        csum, start = [], 0
        for size in sizes:
            if size:
                csum.append(torch.cumsum(wt[start: start + size], dim=1))
                start += size
        csum = csum[0] if len(csum) == 1 else torch.cat(csum)
        # A fresh intra-tile uniform over the tile's exact mass keeps the
        # conditional leaf law exact even where a coarse tile sum rounds
        # differently from the cumsum.  Smallest j with csum[j] > u.
        u = u_leaf * csum[:, -1]
        off = (csum <= u[:, None]).sum(dim=1).clamp_max(self.tile - 1)
        return (tiles * self.tile + off).clamp(0, self.n - 1)
