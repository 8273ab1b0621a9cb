"""The port's sample structures: the invariants of `tests/test_sample_tree.py`
(internal sums, zero-weight leaves never drawn, scatter_update equal to
init, bounded f32 drift over 10k updates, the tiled sampler against a
rebuild), plus the torch heaps against the JAX package's `SampleTreeJax` /
`TiledSampleTree` on the same weights."""

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.core import sample_tree as jst
from repro_torch.core.sample_tree import (
    SampleTree,
    SampleTreeTorch,
    TiledSampleTree,
)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@settings(max_examples=25, deadline=None)
@given(
    st.integers(1, 300),
    st.lists(st.integers(0, 10_000), min_size=1, max_size=8),
    st.integers(0, 2 ** 31 - 1),
)
def test_internal_sums_invariant(n, update_seeds, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 10, size=n)
    tree = SampleTree(w)
    for s in update_seeds:
        r = np.random.default_rng(s)
        m = r.integers(1, n + 1)
        idx = r.choice(n, size=m, replace=False)
        new = r.uniform(0, 5, size=m)
        tree.update(idx, new)
        w[idx] = new
    heap, cap = tree.heap, tree.cap
    for v in range(1, cap):
        assert np.isclose(heap[v], heap[2 * v] + heap[2 * v + 1], atol=1e-6)
    assert np.allclose(tree.leaf_weights(), w)
    assert np.isclose(tree.total, w.sum(), rtol=1e-9)


def test_zero_weight_never_sampled():
    w = np.zeros(17)
    w[5] = 2.0
    assert (SampleTree(w).sample_batch(np.random.default_rng(1), 500)
            == 5).all()
    tt = SampleTreeTorch(17)
    heap = tt.init(torch.from_numpy(w).float())
    assert (tt.sample(heap, _gen(1), 500) == 5).all()
    ts = TiledSampleTree(17, tile=8)
    w_pad = torch.zeros(ts.n_pad)
    w_pad[5] = 2.0
    assert (ts.sample(ts.init(w_pad), w_pad, _gen(2), 500) == 5).all()


def test_sampling_distribution():
    rng = np.random.default_rng(0)
    w = np.array([1.0, 0.0, 3.0, 6.0])
    freq = np.bincount(SampleTree(w).sample_batch(rng, 20000),
                       minlength=4) / 20000
    assert freq[1] == 0.0
    assert np.allclose(freq, w / w.sum(), atol=0.02)
    tt = SampleTreeTorch(4)
    draws = tt.sample(tt.init(torch.from_numpy(w).float()), _gen(0), 20000)
    freq = np.bincount(draws.numpy(), minlength=4) / 20000
    assert freq[1] == 0.0
    assert np.allclose(freq, w / w.sum(), atol=0.02)


@settings(max_examples=20, deadline=None)
@given(
    st.integers(1, 400),
    st.integers(1, 6),
    st.integers(0, 2 ** 31 - 1),
    st.booleans(),
)
def test_scatter_update_matches_init_property(n, k_open, seed, duplicates):
    """After each opened center, patching only the changed leaves with
    `scatter_update` leaves a heap equal (<= 1e-4 relative) to a
    from-scratch `init` of the new weights; leaves are patched bitwise."""
    rng = np.random.default_rng(seed)
    d = 4
    if duplicates:
        pts = np.tile(rng.normal(size=(1, d)), (n, 1))   # all-duplicate
    else:
        pts = rng.normal(size=(n, d)) * 5
    w = np.full(n, 1e4, dtype=np.float32)
    tt = SampleTreeTorch(n)
    heap = tt.init(torch.from_numpy(w))
    for _ in range(k_open):
        c = pts[rng.integers(n)]
        w_new = np.minimum(w, ((pts - c) ** 2).sum(1)).astype(np.float32)
        changed = np.flatnonzero(w_new != w)
        heap = tt.scatter_update(heap, torch.from_numpy(changed),
                                 torch.from_numpy(w_new[changed]))
        w = w_new
        expect = tt.init(torch.from_numpy(w))
        scale = max(float(expect[1]), 1.0)
        np.testing.assert_allclose(heap.numpy(), expect.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale)
        np.testing.assert_array_equal(heap[tt.cap: tt.cap + n].numpy(), w)
    assert (heap[1:] >= 0.0).all()


def test_scatter_update_float32_drift_10k():
    """10k interleaved incremental updates and draws must not drift the f32
    partial sums measurably away from the exact leaf totals."""
    n, u = 4096, 8
    tt = SampleTreeTorch(n)
    gen = _gen(7)
    heap = tt.init(torch.from_numpy(
        np.random.default_rng(0).uniform(0.5, 2.0, n)).float())
    sink = 0
    for i in range(10_000):
        # u unique leaves per step (stride pattern), fresh weights
        idx = (i * 37 + torch.arange(u) * (n // u)) % n
        new = torch.rand(u, generator=gen) * 2.9 + 0.1
        heap = tt.scatter_update(heap, idx, new)
        sink += int(tt.sample(heap, gen, 4).sum())   # interleaved draws
    assert sink >= 0
    leaves = heap[tt.cap: tt.cap + n].double()
    total = float(heap[1])
    assert abs(total - float(leaves.sum())) / float(leaves.sum()) < 1e-3
    rebuilt = tt.init(leaves.float())
    np.testing.assert_allclose(heap.numpy(), rebuilt.numpy(),
                               atol=2e-3 * max(total, 1.0))
    assert (heap[1:] >= 0.0).all()


def test_tiled_sampler_matches_rebuild_distribution():
    """The two-level TiledSampleTree draws from the same law as the
    full-heap rebuild path on the same weights; holes are never drawn."""
    rng = np.random.default_rng(5)
    n, tile, m = 700, 64, 150_000
    w = rng.uniform(0, 3, size=n).astype(np.float32)
    w[rng.choice(n, 100, replace=False)] = 0.0
    ts = TiledSampleTree(n, tile=tile)
    w_pad = torch.zeros(ts.n_pad)
    w_pad[:n] = torch.from_numpy(w)
    tiled = ts.sample(ts.init(w_pad), w_pad, _gen(0), m).numpy()
    full_tree = SampleTreeTorch(n)
    full = full_tree.sample(full_tree.init(torch.from_numpy(w)), _gen(1),
                            m).numpy()
    p = w / w.sum()
    f_tiled = np.bincount(tiled, minlength=n) / m
    f_full = np.bincount(full, minlength=n) / m
    assert (f_tiled[w == 0.0] == 0.0).all()
    np.testing.assert_allclose(f_tiled, p, atol=0.006)
    np.testing.assert_allclose(f_full, p, atol=0.006)
    np.testing.assert_allclose(f_tiled, f_full, atol=0.008)


def test_torch_tree_matches_numpy():
    rng = np.random.default_rng(2)
    n = 37
    w = rng.uniform(0, 4, size=n).astype(np.float32)
    tt = SampleTreeTorch(n)
    heap = tt.init(torch.from_numpy(w))
    nt = SampleTree(w)
    assert np.isclose(float(heap[1]), nt.total, rtol=1e-5)
    idx = np.array([0, 5, 36])
    new = np.array([9.0, 0.5, 1.5], dtype=np.float32)
    heap = tt.scatter_update(heap, torch.from_numpy(idx), torch.from_numpy(new))
    nt.update(idx, new)
    assert np.allclose(heap[tt.cap: tt.cap + n].numpy(), nt.leaf_weights(),
                       rtol=1e-5)
    w[idx] = new
    freq = np.bincount(tt.sample(heap, _gen(0), 4000).numpy(),
                       minlength=n) / 4000
    assert np.allclose(freq, w / w.sum(), atol=0.03)


def test_descend_over_lanes_equals_each_heap_alone():
    """`descend` over B heaps (draws in any lane order, a lane with none)
    picks, draw by draw, the leaf that `sample`'s descent of that lane's
    heap alone picks from the same uniform: one descent serves both."""
    rng = np.random.default_rng(4)
    n, b = 45, 4
    w = rng.uniform(0, 3, size=(b, n)).astype(np.float32)
    w[1, ::2] = 0.0
    tt = SampleTreeTorch(n)
    heaps = tt.init(torch.from_numpy(w))
    lanes = torch.tensor([2, 0, 0, 3, 1, 2, 0, 3, 3], dtype=torch.int64)
    lanes = torch.cat([lanes, lanes[lanes != 2]])      # lane 2: fewer draws
    u = torch.rand(len(lanes), generator=_gen(5))
    got = tt.descend(heaps, u, lanes)
    for s, j in enumerate(lanes.tolist()):
        one = tt.descend(heaps[j][None], u[s: s + 1],
                         torch.zeros(1, dtype=torch.int64))
        assert int(got[s]) == int(one[0])
        assert w[j, int(got[s])] > 0
    # `sample` is the one-heap case: the same draws as descend of its u.
    u0 = torch.rand(64, generator=_gen(6))
    assert torch.equal(tt.sample(heaps[1], _gen(6), 64),
                       tt.descend(heaps[1][None], u0,
                                  torch.zeros(64, dtype=torch.int64)))


def test_heaps_match_jax():
    """Same weights and updates: `init` is bit-identical to the JAX
    package's (the same pairwise f32 sums), and the tile sums, the coarse
    heap, `scatter_update` and the tiled `refresh` agree to f32 rounding."""
    rng = np.random.default_rng(3)
    n = 300
    w = rng.uniform(0, 5, size=n).astype(np.float32)
    tt, jt = SampleTreeTorch(n), jst.SampleTreeJax(n)
    heap, jheap = tt.init(torch.from_numpy(w)), jt.init(jnp.asarray(w))
    np.testing.assert_array_equal(heap.numpy(), np.asarray(jheap))
    idx = rng.choice(n, 40, replace=False)
    new = rng.uniform(0, 1, 40).astype(np.float32)
    heap = tt.scatter_update(heap, torch.from_numpy(idx), torch.from_numpy(new))
    jheap = jt.scatter_update(jheap, jnp.asarray(idx), jnp.asarray(new))
    np.testing.assert_allclose(heap.numpy(), np.asarray(jheap), rtol=1e-6,
                               atol=1e-5)

    ts, jts = TiledSampleTree(n, tile=32), jst.TiledSampleTree(n, tile=32)
    assert (ts.num_tiles, ts.n_pad) == (jts.num_tiles, jts.n_pad)
    w_pad = np.zeros(ts.n_pad, np.float32)
    w_pad[:n] = w
    # Tile sums reduce 32 values in another order than XLA's: f32 rounding.
    np.testing.assert_allclose(
        ts.tile_sums(torch.from_numpy(w_pad)).numpy(),
        np.asarray(jts.tile_sums(jnp.asarray(w_pad))), rtol=1e-6)
    coarse = ts.init(torch.from_numpy(w_pad))
    jcoarse = jts.init(jnp.asarray(w_pad))
    np.testing.assert_allclose(coarse.numpy(), np.asarray(jcoarse), rtol=1e-6)
    sums = rng.uniform(0, 50, ts.num_tiles).astype(np.float32)
    coarse = ts.refresh(coarse, torch.from_numpy(sums))
    jcoarse = jts.refresh(jcoarse, jnp.asarray(sums))
    np.testing.assert_allclose(coarse.numpy(), np.asarray(jcoarse), rtol=1e-6,
                               atol=1e-4)
    assert float(ts.total(coarse)) == float(coarse[1])
    # The refresh is a rebuild: the same heap as `init` from those sums, and
    # as `scatter_update` of every tile.
    rebuilt = ts.coarse.init(torch.from_numpy(sums))
    np.testing.assert_array_equal(coarse.numpy(), rebuilt.numpy())
    patched = ts.coarse.scatter_update(
        ts.init(torch.from_numpy(w_pad)), torch.arange(ts.num_tiles),
        torch.from_numpy(sums))
    np.testing.assert_array_equal(coarse.numpy(), patched.numpy())
