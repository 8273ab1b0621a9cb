"""Stacked lanes (ROADMAP item 6) against the JAX package, on the CPU.

  * The canonical lane prepare (`prepare_stacked`) gives the JAX package's
    `StackedLane` bit for bit: arrays, statics, `n_real` and the rng state
    after it, a user `lsh_r` rescaled with the points.
  * The lane-axis forms of `tree_sep_update`, `tree_sep_update_tiles` and
    `lsh_bucket_accept` equal the one-lane ops lane by lane, bit for bit
    (shared codes with a stride-0 lane axis, and lanes with blocks of
    different sizes, included), and equal `jax.vmap` over the JAX
    package's ops in interpret mode: the sweeps exactly where XLA's CPU
    `exp2` is exact and to 1e-5 elsewhere (`tests/test_torch_kernels.py`
    explains that dust), the LSH distances and probabilities to rtol 1e-5.
  * The stacked contracts of `tests/test_engine.py` hold for the port:
    one solve per bucket and a second same-bucket batch that builds
    nothing, a lane equal to its single-dataset fit, per-dataset seeds,
    mixed sizes in shape buckets, a fingerprint-cached prepare, and a loop
    backend's stacked result.
  * `fit_batch(seeds)` lanes equal refits, whatever the other lanes, and
    the lanes' trials are the refits'.
  * In law (Philox cannot replay threefry): the 16-lane mean cost of the
    stacked lanes is within 5% of the JAX package's on the same datasets.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusterPlan as JaxClusterPlan
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import ExecutionSpec as JaxExecutionSpec
from repro.core import device_seeding as jds
from repro.kernels import ops as jops
from repro_torch.core import (
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    no_retrace,
    shape_bucket,
)
from repro_torch.core import device_seeding as ds
from repro_torch.core.seeding import clustering_cost
from repro_torch.kernels import ops
from repro_torch.kernels.ref import LSH_MISS

MISS32 = np.float32(LSH_MISS)


def _mixture(n, d=4, k_true=8, seed=0):
    """The JAX suite's mixture (`tests/test_engine.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _plan(seeder="rejection", k=3, seed=0, backend="device", **options):
    return ClusterPlan(ClusterSpec(k=k, seeder=seeder, seed=seed,
                                   options=options),
                       ExecutionSpec(backend=backend, device="cpu"))


def _jax_plan(seeder="rejection", k=3, seed=0, **options):
    return JaxClusterPlan(JaxClusterSpec(k=k, seeder=seeder, seed=seed,
                                         options=options),
                          JaxExecutionSpec(backend="device"))


# -- the canonical lane prepare ------------------------------------------------

@pytest.mark.parametrize("n,lsh_r", [(300, None), (1500, None), (700, 60.0)])
@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_stacked_lane_matches_jax_package(seeder, n, lsh_r):
    pts = _mixture(n, d=5, seed=n)
    options = {} if lsh_r is None else {"lsh_r": lsh_r}
    if seeder == "fastkmeans++":
        options = {}
    mine = _plan(seeder, **options).prepare_stacked(pts)
    theirs = _jax_plan(seeder, **options).prepare_stacked(pts)
    lane, jlane = mine.artifacts, theirs.artifacts
    assert len(lane.arrays) == len(jlane.arrays) == \
        (5 if seeder == "rejection" else 2)
    for a, ja in zip(lane.arrays, jlane.arrays):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert lane.statics == jlane.statics
    assert lane.n_real == jlane.n_real == n
    assert lane.shape_key == (tuple(tuple(a.shape) for a in jlane.arrays),
                              jlane.statics)
    assert lane.arrays[0].shape[-1] == shape_bucket(n)
    assert mine.rng_state == theirs.rng_state
    assert mine.fingerprint.endswith("/stacked")


def test_canonical_scale_is_the_jax_packages():
    for scale in (1e-3, 0.7, 1.0, 3.0, 1e5):
        pts = _mixture(200, seed=1) * scale
        assert ds.canonical_pow2_scale(pts) == jds.canonical_pow2_scale(pts)
    assert ds.canonical_pow2_scale(np.zeros((4, 2))) == 1.0


# -- the lane-axis ops ---------------------------------------------------------

def _lane_codes(b, h, n, seed, shared):
    """(B, H, n) int32 code planes (a stride-0 lane axis when `shared`),
    x (B,) and w (B, n); lane j's point x[j] shares its first levels with
    many rows, so every separation level occurs."""
    rng = np.random.default_rng(seed)
    planes = 1 if shared else b
    codes = rng.integers(0, 2 ** 63, size=(planes, h, n), dtype=np.uint64)
    for p in range(planes):
        for j in range(1, min(h + 1, n)):
            codes[p, : j - 1, j] = codes[p, : j - 1, 0]
    lo, hi = ops.split_codes_u64(codes)
    x = rng.integers(0, n, size=b)
    x[0] = 0
    w = rng.uniform(0, 1e8, size=(b, n)).astype(np.float32)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    if shared:
        lo_t, hi_t = lo_t.expand(b, h, n), hi_t.expand(b, h, n)
        lo, hi = np.broadcast_to(lo, (b, h, n)), np.broadcast_to(hi, (b, h, n))
    return lo_t, hi_t, lo, hi, x, w


def _jax_sweep_check(out, expect, lo, hi, x):
    """Bit-identical where XLA's CPU exp2 is exact on the lane's separation
    levels, within 1e-5 elsewhere."""
    for j in range(out.shape[0]):
        col = x[j]
        sep = 1 + ((lo[j] == lo[j][:, col:col + 1])
                   & (hi[j] == hi[j][:, col:col + 1])).sum(0)
        xla_exact = np.asarray(jnp.exp2(1.0 - jnp.asarray(sep, jnp.float32))) \
            == np.ldexp(np.float32(1.0), 1 - sep)
        np.testing.assert_array_equal(out[j][xla_exact],
                                      expect[j][xla_exact])
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-28)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b,h,n", [(1, 11, 300), (3, 14, 1025),
                                   (4, 21, 700)])
def test_tree_sep_update_lanes(b, h, n, shared):
    lo_t, hi_t, lo, hi, x, w = _lane_codes(b, h, n, b * h + n, shared)
    kw = dict(scale=7.5 * np.sqrt(3.0), num_levels=h + 1)
    out = ops.tree_sep_update_lanes(lo_t, hi_t, torch.from_numpy(x),
                                    torch.from_numpy(w), **kw)
    assert out.shape == (b, n) and out.dtype == torch.float32
    for j in range(b):
        solo = ops.tree_sep_update(lo_t[j], hi_t[j], lo_t[j][:, x[j]],
                                   hi_t[j][:, x[j]], torch.from_numpy(w[j]),
                                   **kw)
        assert torch.equal(out[j], solo)
        assert out[j, x[j]] == 0.0                 # the center itself
    cols = np.stack([lo[j][:, x[j]] for j in range(b)])
    cols_hi = np.stack([hi[j][:, x[j]] for j in range(b)])
    expect = jax.vmap(functools.partial(jops.tree_sep_update, **kw))(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(cols),
        jnp.asarray(cols_hi), jnp.asarray(w))
    _jax_sweep_check(out.numpy(), np.asarray(expect), lo, hi, x)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b,h,n,block", [(2, 11, 1024, 512), (3, 9, 384, 128),
                                         (1, 14, 512, 512)])
def test_tree_sep_update_tiles_lanes(b, h, n, block, shared):
    lo_t, hi_t, lo, hi, x, w = _lane_codes(b, h, n, b * h + n + 1, shared)
    w = w / 100.0
    kw = dict(scale=7.5, num_levels=h + 1)
    out, sums = ops.tree_sep_update_tiles_lanes(
        lo_t, hi_t, torch.from_numpy(x), torch.from_numpy(w), block_n=block,
        **kw)
    assert out.shape == (b, n) and sums.shape == (b, n // block)
    for j in range(b):
        solo, solo_sums = ops.tree_sep_update_tiles(
            lo_t[j], hi_t[j], lo_t[j][:, x[j]], hi_t[j][:, x[j]],
            torch.from_numpy(w[j]), block_n=block, **kw)
        assert torch.equal(out[j], solo) and torch.equal(sums[j], solo_sums)
    cols = np.stack([lo[j][:, x[j]] for j in range(b)])
    cols_hi = np.stack([hi[j][:, x[j]] for j in range(b)])
    jout, jsums = jax.vmap(functools.partial(
        jops.tree_sep_update_tiles, block_n=block, **kw))(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(cols),
        jnp.asarray(cols_hi), jnp.asarray(w))
    _jax_sweep_check(out.numpy(), np.asarray(jout), lo, hi, x)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5)


def test_tree_sep_update_tiles_lanes_needs_whole_tiles():
    lo_t, hi_t, _, _, x, w = _lane_codes(2, 5, 300, 0, False)
    with pytest.raises(ValueError, match="multiple of the tile"):
        ops.tree_sep_update_tiles_lanes(lo_t, hi_t, torch.from_numpy(x),
                                        torch.from_numpy(w), scale=1.0,
                                        num_levels=6, block_n=128)


def _lsh_lanes(sizes, k, l, d, seed):
    """Candidates of len(sizes) lanes (lane j's block of sizes[j] in lane
    order) and each lane's K center slots."""
    rng = np.random.default_rng(seed)
    b, s = len(sizes), sum(sizes)
    lanes = np.repeat(np.arange(b), sizes)
    qk = rng.integers(-5, 5, size=(2, l, s)).astype(np.int32)
    ck = rng.integers(-5, 5, size=(2, b, l, k)).astype(np.int32)
    q = rng.normal(size=(s, d)).astype(np.float32)
    c = rng.normal(size=(b, k, d)).astype(np.float32)
    mtd2 = rng.uniform(0, 3, size=s).astype(np.float32)
    mtd2[::5] = 0.0
    return qk[0], qk[1], q, lanes, ck[0], ck[1], c, mtd2


@pytest.mark.parametrize("sizes,k,count", [
    ((64, 32, 128), 40, 17), ((7, 0, 30), 20, 20), ((50,), 33, 0),
    ((32, 32, 32, 32), 129, 100)])
def test_lsh_bucket_accept_lanes_equals_one_lane_calls(sizes, k, count):
    qlo, qhi, q, lanes, clo, chi, c, mtd2 = _lsh_lanes(sizes, k, 15, 12,
                                                       sum(sizes) + k)
    t = [torch.from_numpy(a) for a in (qlo, qhi, q, lanes, clo, chi, c,
                                        mtd2)]
    d2, p = ops.lsh_bucket_accept_lanes(*t, count, c2=1.44)
    assert d2.shape == p.shape == (sum(sizes),)
    start = 0
    for j, size in enumerate(sizes):
        seg = slice(start, start + size)
        sd2, sp = ops.lsh_bucket_accept(t[0][:, seg], t[1][:, seg],
                                        t[2][seg], t[4][j], t[5][j], t[6][j],
                                        t[7][seg], count, c2=1.44)
        assert torch.equal(d2[seg], sd2) and torch.equal(p[seg], sp)
        start += size
    if count == 0:
        assert (d2.numpy() == MISS32).all()


@pytest.mark.parametrize("count", [0, 9, 40])
def test_lsh_bucket_accept_lanes_matches_jax_vmap(count):
    b, size = 3, 48
    qlo, qhi, q, lanes, clo, chi, c, mtd2 = _lsh_lanes((size,) * b, 40, 15,
                                                       74, count + 5)
    d2, p = ops.lsh_bucket_accept_lanes(
        *map(torch.from_numpy, (qlo, qhi, q, lanes, clo, chi, c, mtd2)),
        count, c2=4.0)
    per_lane = [a.reshape(a.shape[0], b, size).transpose(1, 0, 2)
                for a in (qlo, qhi)]
    jd2, jp = jax.vmap(
        lambda a, bb, qq, cl, ch, cc, m: jops.lsh_bucket_accept(
            a, bb, qq, cl, ch, cc, m, count, c2=4.0))(
        *map(jnp.asarray, (per_lane[0], per_lane[1], q.reshape(b, size, -1),
                           clo, chi, c, mtd2.reshape(b, size))))
    jd2, jp = np.asarray(jd2).reshape(-1), np.asarray(jp).reshape(-1)
    d2, p = d2.numpy(), p.numpy()
    miss = jd2 == MISS32
    np.testing.assert_array_equal(d2 == MISS32, miss)
    if count:
        assert (~miss).any()
    np.testing.assert_allclose(d2[~miss], jd2[~miss], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5)


# -- the stacked contracts of tests/test_engine.py -----------------------------

def test_stacked_same_bucket_is_one_solve_and_builds_nothing_again():
    """8 distinct same-bucket datasets are one group (one solve); a second
    same-bucket batch builds nothing (the port's `no_retrace` counts
    kernel builds, where the JAX package counts traces)."""
    datasets = [_mixture(280 + 13 * i, seed=20 + i) for i in range(8)]
    assert {shape_bucket(len(x)) for x in datasets} == {1024}
    plan = _plan("fastkmeans++", k=3, seed=1)
    batch = plan.fit_batch(datasets=datasets)
    assert batch.extras["stacked"] and batch.extras["shape_buckets"] == 1
    assert tuple(batch.indices.shape) == (8, 3)
    assert tuple(batch.centers.shape) == (8, 3, 4)
    assert batch.extras["donated"] is False
    more = [_mixture(300 + 7 * i, seed=50 + i) for i in range(8)]
    with no_retrace():
        plan.fit_batch(datasets=more)


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_stacked_lane_equals_single_dataset_fit(seeder):
    datasets = [_mixture(300 + 11 * i, seed=30 + i) for i in range(5)]
    # lsh_r is given in ORIGINAL data units: the canonical lane prepare must
    # rescale it with the points.
    options = {"lsh_r": 60.0} if seeder == "rejection" else {}
    plan = _plan(seeder, k=4, seed=3, **options)
    batch = plan.fit_batch(datasets=datasets)
    assert batch.extras["stacked"] and batch.extras["vmapped"]
    solo = plan.fit_batch(datasets=[datasets[2]])
    assert torch.equal(solo.indices[0], batch.indices[2])
    assert torch.equal(solo.cost[0], batch.cost[2])
    if seeder == "rejection":
        assert torch.equal(solo.extras["trials"][0], batch.extras["trials"][2])
        assert tuple(batch.extras["trials"].shape) == (5, 4)
    # the per-dataset cost is in ORIGINAL coordinates
    x = datasets[2]
    idx = batch.indices[2].numpy().astype(np.int64)
    np.testing.assert_allclose(float(batch.cost[2]),
                               clustering_cost(x, x[idx]), rtol=1e-4)
    np.testing.assert_array_equal(batch.centers[2].numpy(),
                                  x[idx].astype(np.float32))


def test_stacked_respects_per_dataset_seeds():
    datasets = [_mixture(270, seed=40 + i) for i in range(2)]
    plan = _plan("fastkmeans++", k=3)
    b1 = plan.fit_batch(datasets=datasets, seeds=[5, 6])
    solo = plan.fit_batch(datasets=[datasets[1]], seeds=[6])
    assert torch.equal(solo.indices[0], b1.indices[1])
    b2 = plan.fit_batch(datasets=datasets, seeds=[5, 7])
    assert torch.equal(b1.indices[0], b2.indices[0])
    assert not torch.equal(b1.indices[1], b2.indices[1])


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_stacked_mixed_sizes_split_into_shape_buckets(seeder):
    datasets = [_mixture(200, seed=1), _mixture(1500, seed=2),
                _mixture(900, seed=3)]
    plan = _plan(seeder, k=3)
    batch = plan.fit_batch(datasets=datasets)
    jbatch = _jax_plan(seeder, k=3).fit_batch(datasets=datasets)
    for key in ("stacked", "vmapped", "shape_buckets", "lane_rows",
                "bucket_rows", "seeds"):
        assert batch.extras[key] == jbatch.extras[key], key
    assert batch.extras["shape_buckets"] == 2        # rungs 1024 and 2048
    assert batch.extras["bucket_rows"] == (1024, 2048, 1024)
    assert batch.extras["lane_rows"] == (200, 1500, 900)
    # every lane index points at a real row of its own dataset
    for i, x in enumerate(datasets):
        assert int(batch.indices[i].max()) < len(x)
        solo = plan.fit_batch(datasets=[x])
        assert torch.equal(solo.indices[0], batch.indices[i])


def test_stacked_prepare_is_fingerprint_cached():
    datasets = [_mixture(256, seed=60 + i) for i in range(3)]
    plan = _plan("rejection", k=3)
    plan.fit_batch(datasets=datasets)
    builds = plan.cache_info()["prepare_builds"]
    plan.fit_batch(datasets=datasets, seeds=[1, 2, 3])
    info = plan.cache_info()
    assert info["prepare_builds"] == builds == 3, "stacked lanes re-prepared"
    assert info["prepare_hits"] >= 3
    # The stacked and the solo prepare of one dataset are distinct entries.
    plan.prepare_data(datasets[0])
    assert plan.cache_info()["prepare_builds"] == 4


def test_fallback_loop_backends_stack_results():
    datasets = [_mixture(150, seed=70 + i) for i in range(3)]
    plan = _plan("kmeans++", k=3, seed=1, backend="cpu")
    batch = plan.fit_batch(datasets=datasets)
    assert batch.extras["stacked"] is False
    assert tuple(batch.indices.shape) == (3, 3)
    ref = plan.fit_prepared(plan.prepare_data(datasets[1]))
    assert torch.equal(batch.indices[1], ref.indices)
    with pytest.raises(ValueError, match="no stacked lanes"):
        plan.prepare_stacked(datasets[0])


def test_lloyd_falls_back_to_the_solo_loop():
    datasets = [_mixture(200, seed=80 + i) for i in range(2)]
    plan = ClusterPlan(ClusterSpec(k=3, seeder="rejection", lloyd_iters=2),
                       ExecutionSpec(device="cpu"))
    batch = plan.fit_batch(datasets=datasets)
    assert batch.extras["stacked"] is False
    assert batch.extras["vmapped"] is False


def test_fit_batch_prepared_checks_its_handles():
    plan = _plan("rejection", k=3)
    a, b = _mixture(200, seed=1), _mixture(300, d=5, seed=2)
    with pytest.raises(ValueError, match="prepare_stacked handles"):
        plan.fit_batch_prepared([plan.prepare_data(a)])
    with pytest.raises(ValueError, match="one feature dimension"):
        plan.fit_batch_prepared([plan.prepare_stacked(a),
                                 plan.prepare_stacked(b)])
    with pytest.raises(ValueError, match="1 seeds for 2 lanes"):
        plan.fit_batch_prepared([plan.prepare_stacked(a)] * 2, seeds=[1])
    with pytest.raises(ValueError, match=">= 1 lane"):
        plan.fit_batch_prepared([])
    lane = plan.prepare_stacked(a)
    out = plan.fit_batch_prepared([lane, lane], seeds=[4, 4])
    assert torch.equal(out.indices[0], out.indices[1])


# -- fit_batch(seeds): one lane-batched solve over one dataset ------------------

@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_fit_batch_seeds_lanes_equal_refits_whatever_the_batch(seeder):
    pts = _mixture(900, d=5, seed=12)
    plan = _plan(seeder, k=12, seed=2)
    batch = plan.fit_batch([3, 0, 2, 7, 2], pts)
    assert batch.extras["vmapped"] is True
    assert batch.extras["seeds"] == (3, 0, 2, 7, 2)
    assert torch.equal(batch.indices[2], batch.indices[4])
    for i, s in enumerate((3, 0, 2, 7, 2)):
        lane = plan.refit(seed=s)
        assert torch.equal(batch.indices[i], lane.indices)
        assert torch.equal(batch.cost[i], lane.cost)
        if seeder == "rejection":
            assert torch.equal(batch.extras["trials"][i],
                               lane.extras["trials"])
    one = plan.fit_batch([7])
    assert torch.equal(one.indices[0], batch.indices[3])
    # The spec's seed replays the prepare-time rng: lane 0 is the fit.
    assert torch.equal(plan.fit_batch([2, 9]).indices[0],
                       plan.fit(pts).indices)


def test_lanes_sit_out_once_they_accept():
    """A degenerate lane (every row the same point: the weights are 0 after
    the first center, so each later center is a uniform draw) beside a
    normal one: each is its one-lane solve, draws, trials and rounds."""
    pts = _mixture(400, d=3, seed=5)
    flat = np.repeat(pts[:1], 400, axis=0)
    plan = _plan("rejection", k=6)
    lanes = [plan.prepare_stacked(x) for x in (pts, flat)]
    batch = plan.fit_batch_prepared(lanes, seeds=[1, 1])
    for i, lane in enumerate(lanes):
        solo = plan.fit_batch_prepared([lane], seeds=[1])
        assert torch.equal(batch.indices[i], solo.indices[0])
        assert torch.equal(batch.extras["trials"][i], solo.extras["trials"][0])
    assert (batch.extras["trials"][1] == 1).all()


def test_solo_rounds_are_the_one_lane_case():
    """`device_rejection_sampling` is `stacked_rejection_sampling` of one
    lane: the same indices, trials and round log."""
    pts = _mixture(700, d=4, seed=6)
    data = _plan("rejection").prepare_data(pts).artifacts
    kw = dict(scale=data.scale, num_levels=data.num_levels,
              m_init=data.m_init, c=1.2)
    log, logs = [], [[], []]
    chosen, trials = ds.device_rejection_sampling(
        data.codes_lo, data.codes_hi, data.points, data.keys_lo,
        data.keys_hi, 10, torch.Generator().manual_seed(4), round_log=log,
        **kw)
    arrays = [torch.stack([a, a]) for a in (
        data.codes_lo, data.codes_hi, data.points, data.keys_lo,
        data.keys_hi)]
    gens = [torch.Generator().manual_seed(s) for s in (9, 4)]
    lanes, lane_trials = ds.stacked_rejection_sampling(
        *arrays, 10, gens, round_logs=logs, **kw)
    assert torch.equal(lanes[1], chosen)
    assert torch.equal(lane_trials[1], trials)
    assert logs[1] == log
    with pytest.raises(ValueError, match="generators"):
        ds.stacked_rejection_sampling(*arrays, 10, gens[:1], **kw)


# -- the law ---------------------------------------------------------------------

@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_stacked_mean_cost_matches_jax_package(seeder):
    """16 lanes over two datasets (8 seeds each) in one call of each
    package; per-lane costs spread by about 7% here, so the two 16-lane
    means differ by about 2.6% at one standard error."""
    data = [_mixture(900, d=5, k_true=12, seed=1),
            _mixture(1000, d=5, k_true=12, seed=2)]
    datasets = [data[i % 2] for i in range(16)]
    seeds = list(range(16))
    mine = _plan(seeder, k=24).fit_batch(datasets=datasets, seeds=seeds)
    theirs = _jax_plan(seeder, k=24).fit_batch(datasets=datasets,
                                               seeds=seeds)

    def mean_cost(indices):
        return np.mean([clustering_cost(x, x[np.asarray(idx, np.int64)])
                        for x, idx in zip(datasets, indices)])

    ratio = mean_cost(mine.indices.numpy()) / mean_cost(
        np.asarray(theirs.indices))
    assert abs(ratio - 1.0) < 0.05, ratio
