"""The port's host prepare against the JAX package's, on the CPU.

The same NumPy inputs and seeds go through both packages: quantisation,
the multi-tree embedding, the LSH keys, `prepare_embedding`,
`prepare_rejection` and the plan's prepare stage give bit-identical codes,
keys and coordinates, equal `scale` / `num_levels` / `m_init`, and leave the
NumPy generator in the same state.  `seeding_data_from_arrays` carries the
JAX package's `DeviceSeedingData` across, so later tests can feed both
packages the same artifacts.
"""

import numpy as np
import pytest
import torch

from repro.core import batch_schedule as jbs
from repro.core import device_seeding as jds
from repro.core import lsh as jlsh
from repro.core import plan as jplan
from repro.core import preprocess as jpre
from repro.core import seeding as jseeding
from repro.core import tree_embedding as jte
from repro_torch.core import batch_schedule as bs
from repro_torch.core import device_seeding as ds
from repro_torch.core import lsh, preprocess, seeding, tree_embedding
from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec


def _mixture(n=1200, d=5, k_true=12, spread=40.0, seed=0):
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * spread
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _assert_data_equal(mine, theirs):
    """Every tensor field bit-identical, every scalar field equal."""
    for name in ("codes_lo", "codes_hi", "points", "keys_lo", "keys_hi"):
        a = getattr(mine, name).cpu().numpy()
        b = np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.scale == theirs.scale
    assert mine.num_levels == theirs.num_levels
    assert mine.m_init == theirs.m_init


def test_quantize_bit_identical():
    pts = _mixture(seed=1)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    mine, theirs = preprocess.quantize(pts, r1), jpre.quantize(pts, r2)
    np.testing.assert_array_equal(mine.points, theirs.points)
    assert mine.scaling == theirs.scaling
    assert mine.estimate == theirs.estimate
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("n", [100, 20_500])
def test_estimate_scale_matches(n):
    pts = np.random.default_rng(n).normal(size=(n, 3)) * 7.0
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    assert seeding._estimate_scale(pts, r1) == jseeding._estimate_scale(pts,
                                                                       r2)
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("resolution", [None, 1.0, 0.05])
def test_tree_embedding_bit_identical(resolution):
    pts = _mixture(n=700, d=6, seed=2)
    assert tree_embedding.compute_max_dist(pts) == jte.compute_max_dist(pts)
    for md, res in [(1.0, 1e-6), (37.5, 0.3), (1e4, 2.0), (5.0, 10.0)]:
        assert tree_embedding._num_levels(md, res) == jte._num_levels(md, res)
    mine = tree_embedding.build_multitree(pts, seed=11,
                                          resolution=resolution)
    theirs = jte.build_multitree(pts, seed=11, resolution=resolution)
    assert (mine.max_dist, mine.num_levels, mine.dim, mine.num_points) == (
        theirs.max_dist, theirs.num_levels, theirs.dim, theirs.num_points)
    assert mine.dist_upper_bound_sq == theirs.dist_upper_bound_sq
    np.testing.assert_array_equal(mine.codes_array(), theirs.codes_array())
    queries = pts[:9] + 0.25
    for a, b in zip(mine.trees, theirs.trees):
        np.testing.assert_array_equal(a.shift, b.shift)
        np.testing.assert_array_equal(a.hash_mults, b.hash_mults)
        np.testing.assert_array_equal(a.point_codes(queries),
                                      b.point_codes(queries))


@pytest.mark.parametrize("tables,hashes", [(15, 1), (4, 3)])
def test_lsh_hash_keys_bit_identical(tables, hashes):
    pts = _mixture(n=300, d=7, seed=4)
    mine = lsh.MonotoneLSH(7, r=3.5, num_tables=tables,
                           hashes_per_table=hashes, seed=9)
    theirs = jlsh.MonotoneLSH(7, r=3.5, num_tables=tables,
                              hashes_per_table=hashes, seed=9)
    keys = mine.hash_keys(pts)
    assert keys.dtype == np.uint64 and keys.shape == (300, tables)
    np.testing.assert_array_equal(keys, theirs.hash_keys(pts))


@pytest.mark.parametrize("resolution", [None, 1.0])
def test_prepare_embedding_bit_identical(resolution):
    pts = _mixture(n=900, d=4, seed=5)
    lo, hi, meta = ds.prepare_embedding(pts, seed=21, resolution=resolution,
                                        device="cpu")
    jlo, jhi, jmeta = jds.prepare_embedding(pts, seed=21,
                                            resolution=resolution)
    assert lo.dtype == hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert meta == jmeta


@pytest.mark.parametrize("kwargs", [
    {},                                   # LSH radius from the rng estimate
    {"resolution": 1.0},                  # quantised space, as the plan runs
    {"lsh_r": 1e6, "resolution": 0.05},   # the conformance fixture's
    {"num_tables": 4, "hashes_per_table": 2},
])
def test_prepare_rejection_bit_identical(kwargs):
    pts = _mixture(n=1100, d=6, seed=6)
    if kwargs.get("resolution") == 1.0:
        pts = jpre.quantize(pts, np.random.default_rng(0)).points
    mine = ds.prepare_rejection(pts, seed=8, device="cpu", **kwargs)
    theirs = jds.prepare_rejection(pts, seed=8, **kwargs)
    _assert_data_equal(mine, theirs)


def test_seeding_data_from_arrays_carries_jax_artifacts():
    theirs = jds.prepare_rejection(_mixture(n=500, seed=7), seed=2)
    mine = ds.seeding_data_from_arrays(theirs, device="cpu")
    _assert_data_equal(mine, theirs)


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_plan_prepare_matches_jax(seeder):
    """The plan's prepare stage (quantise, then the seeder's prepare) takes
    the JAX package's rng draws in its order: same artifacts, same
    seeding-space points, same post-prepare generator state."""
    pts = _mixture(n=1000, d=5, seed=8)
    spec = dict(k=10, seeder=seeder, seed=4)
    mine = ClusterPlan(ClusterSpec(**spec),
                       ExecutionSpec(device="cpu")).prepare_data(pts)
    theirs = jplan.ClusterPlan(
        jplan.ClusterSpec(**spec),
        jplan.ExecutionSpec(backend="device")).prepare_data(pts)
    np.testing.assert_array_equal(mine.seed_pts, theirs.seed_pts)
    assert mine.resolution == theirs.resolution
    assert mine.rng_state == theirs.rng_state
    if seeder == "rejection":
        _assert_data_equal(mine.artifacts, theirs.artifacts)
    else:
        for a, b in zip(mine.artifacts[:2], theirs.artifacts[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert mine.artifacts[2] == theirs.artifacts[2]


def test_batch_schedule_matches_jax():
    for kw in [{}, {"min_batch": 16, "max_batch": 1024, "safety": 2.0},
               {"min_batch": 64, "max_batch": 64}]:
        mine, theirs = bs.BatchSchedule(**kw), jbs.BatchSchedule(**kw)
        assert mine.buckets() == theirs.buckets()
        for n, k, tiles in [(96, 2, 1), (1200, 24, 3), (311_029, 1000, 608)]:
            assert mine.initial(n, k, tiles) == theirs.initial(n, k, tiles)
        for rate in [0.0, 1e-4, 0.01, 0.1, 0.25, 0.7, 1.0]:
            assert mine.target_index(rate) == int(theirs.target_index(rate))
            for idx in range(len(mine.buckets())):
                assert mine.next_index(idx, rate) == int(
                    theirs.next_index(idx, rate))
            assert mine.update_rate(0.25, rate) == pytest.approx(
                float(theirs.update_rate(0.25, rate)), rel=1e-6)
    for n in [1, 1000, 1025, 70_000, 311_029]:
        assert bs.shape_bucket(n) == jbs.shape_bucket(n)
