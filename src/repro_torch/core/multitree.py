"""MULTITREEINIT / MULTITREEOPEN / MULTITREESAMPLE (paper §4), faithful form.

NumPy only, a copy of the JAX package's host structure, so the CPU seeders
open the same centers for the same rng.  The paper's amortised structure
with array-backed buckets instead of pointer trees:

* Per tree and per height the points are kept sorted by cell code (a
  CSR-like layout), so ``P_T(v)`` for the node v holding x at height h is
  one ``searchsorted`` range.
* The marking trick is kept verbatim: opening x ascends from x's leaf
  until the parent is marked, marks the path, and touches only
  ``P_T(v_l)``, so over all opens every node's point list is touched at
  most once (Lemma 4.1).
* Weights of a range are updated by walking heights shallow -> deep and
  overwriting the separation level of the still-agreeing range.
* `sample_tree.SampleTree` gives O(log n) sampling and batched updates.

Invariants: ``w_x = MultiTreeDist(x, S)^2`` (``M = 16 d MaxDist^2`` for
S empty); sample-tree nodes hold subtree sums; a tree node is marked iff
its subtree holds an opened center.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.sample_tree import SampleTree
from repro_torch.core.tree_embedding import (
    MultiTreeEmbedding,
    build_multitree,
    tree_dist_from_sep,
)

__all__ = ["MultiTreeSampler"]


class _TreeIndex:
    """Per-tree CSR bucket index + marked-node set."""

    def __init__(self, codes: np.ndarray):
        # codes: (H, n) uint64.
        self.codes = codes
        h, n = codes.shape
        self.order = np.empty((h, n), dtype=np.int64)
        self.sorted_codes = np.empty((h, n), dtype=np.uint64)
        for lvl in range(h):
            o = np.argsort(codes[lvl], kind="stable")
            self.order[lvl] = o
            self.sorted_codes[lvl] = codes[lvl][o]
        self.marked: set[int] = set()

    def bucket(self, lvl: int, code: np.uint64) -> tuple[int, int]:
        """[lo, hi) range of points whose level-`lvl` code equals `code`."""
        sc = self.sorted_codes[lvl]
        lo = int(np.searchsorted(sc, code, side="left"))
        hi = int(np.searchsorted(sc, code, side="right"))
        return lo, hi


class MultiTreeSampler:
    """The paper's §4 data structure over a fixed point set."""

    def __init__(self, points: np.ndarray, *, seed: int = 0,
                 resolution: Optional[float] = None,
                 embedding: Optional[MultiTreeEmbedding] = None):
        pts = np.asarray(points, dtype=np.float64)
        self.points = pts
        self.n, self.dim = pts.shape
        self.embedding = embedding or build_multitree(
            pts, seed=seed, resolution=resolution)
        self.H = self.embedding.num_levels
        self.max_dist = self.embedding.max_dist
        self.M = self.embedding.dist_upper_bound_sq
        self.trees = [_TreeIndex(t.codes) for t in self.embedding.trees]
        # Invariant 1: w_x = MultiTreeDist(x, {})^2 = M.
        self.weights = np.full(self.n, self.M, dtype=np.float64)
        self.sample_tree = SampleTree(self.weights)
        self.num_opened = 0
        # Tree distance squared per separation level (sep in [0, H]).
        self._dist_sq_by_sep = tree_dist_from_sep(
            np.arange(self.H + 1), self.max_dist, self.H, self.dim) ** 2
        self._sep_buf = np.empty(self.n, dtype=np.int32)

    # -- MULTITREESAMPLE ----------------------------------------------------

    def sample(self, rng: np.random.Generator) -> int:
        """One draw from the D^2 distribution w.r.t. multi-tree distances."""
        return self.sample_tree.sample(rng)

    def sample_batch(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """`size` i.i.d. draws from the same law."""
        return self.sample_tree.sample_batch(rng, size)

    def total_weight(self) -> float:
        """The sum of all weights (the sample tree's root)."""
        return self.sample_tree.total

    def dist_sq(self, x: int) -> float:
        """MultiTreeDist(x, S)^2 — the current weight of point x."""
        return float(self.weights[x])

    # -- MULTITREEOPEN ------------------------------------------------------

    def open(self, x: int) -> None:
        """Open point x as a center; restores all three invariants
        (Algorithm 1, Step 5's loop as shallow -> deep range overwrites)."""
        touched_ids: list[np.ndarray] = []
        for tree in self.trees:
            codes_x = tree.codes[:, x]
            # Steps 2-3: ascend from the leaf until root or marked parent.
            lvl = self.H - 1
            while lvl > 0 and int(codes_x[lvl - 1]) not in tree.marked:
                lvl -= 1
            # Step 4: mark the path v_0 .. v_l.
            for h in range(lvl, self.H):
                tree.marked.add(int(codes_x[h]))
            # Step 5: update points in P_T(v_l), shallow -> deep.
            lo0, hi0 = tree.bucket(lvl, codes_x[lvl])
            if hi0 <= lo0:
                continue
            sep = self._sep_buf
            ids0 = tree.order[lvl][lo0:hi0]
            sep[ids0] = lvl + 1
            for h in range(lvl + 1, self.H):
                lo, hi = tree.bucket(h, codes_x[h])
                if hi <= lo:
                    break
                sep[tree.order[h][lo:hi]] = h + 1
            new_w = self._dist_sq_by_sep[sep[ids0]]
            improved = new_w < self.weights[ids0]
            if improved.any():
                upd = ids0[improved]
                self.weights[upd] = new_w[improved]
                touched_ids.append(upd)
        self.num_opened += 1
        if touched_ids:
            if len(touched_ids) == 1:
                changed = touched_ids[0]
            else:
                changed = np.unique(np.concatenate(touched_ids))
            self.sample_tree.update(changed, self.weights[changed])

    # -- Verification helper (used by tests) --------------------------------

    def brute_force_weights(self, opened: np.ndarray) -> np.ndarray:
        """O(n * |S| * H) recomputation of invariant 1, for testing."""
        if len(opened) == 0:
            return np.full(self.n, self.M)
        best = np.full(self.n, np.inf)
        for t in self.trees:
            for c in opened:
                sep = (t.codes == t.codes[:, c][:, None]).sum(axis=0)
                best = np.minimum(best, self._dist_sq_by_sep[sep])
        return best
