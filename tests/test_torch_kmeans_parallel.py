"""The port's k-means|| on the device backend against the JAX package's, on
the CPU.

  * The host recluster (`_candidate_pool_to_centers`) is a NumPy copy: for
    the same pool and the same rng state it returns the JAX package's
    indices bit for bit, a pool smaller than k (the padding branch)
    included.
  * The rounds run on torch generators, which cannot replay JAX's threefry
    stream, so they are held to their law: in one round each point is
    picked with probability ``min(1, ell * d2 / phi)`` (a binomial z-bound
    per point and a chi-square over all of them), only the first `cap`
    wanted points in index order are kept, and the returned d2 is the f32
    minimum distance to the selected set.
  * The slice as a whole: 32-seed mean costs of the port's plan and of the
    JAX package's `kmeans||/device` seeder (its Pallas kernel in interpret
    mode) agree within 5% on the mixture of `tests/test_torch_seeding.py`.
    Per-seed costs spread by 5 to 6% there (64 seeds a side), so the
    difference of two 32-seed means has a standard error of about 1.5%
    and the gate stands at more than three.
  * The plan's contract: k distinct indices, the cost program's cost, no
    re-prepare on refit, and one seed replays.
"""

import numpy as np
import pytest
import torch

import test_conformance as conf
from repro.core import device_seeding as jds
from repro.core import registry as jregistry
from repro.core import seeding as jseeding
from repro_torch.core import device_seeding as ds
from repro_torch.core import seeding
from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
from repro_torch.kernels import ops

CPU = ExecutionSpec(device="cpu")


def _mixture(n=1200, d=5, k_true=12, spread=40.0, seed=6):
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * spread
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _plan(k, seed=0, **options):
    return ClusterPlan(ClusterSpec(k=k, seeder="kmeans||", seed=seed,
                                   options=options), CPU)


# -- the host recluster -------------------------------------------------------

@pytest.mark.parametrize("n,d,pool,k", [
    (1500, 5, 300, 24),     # a pool as the rounds leave it
    (900, 74, 120, 40),     # the main path's width
    (400, 3, 9, 20),        # fewer candidates than k: the padding branch
    (200, 4, 200, 50),      # every point a candidate
])
def test_recluster_is_bit_identical(n, d, pool, k):
    pts = _mixture(n=n, d=d, seed=n + d)
    rng0 = np.random.default_rng(pool)
    cand = rng0.choice(n, pool, replace=False)
    cand = np.concatenate([cand, cand[: pool // 4]])   # duplicates
    mine, my_pool = seeding._candidate_pool_to_centers(
        pts, cand, k, np.random.default_rng(7))
    theirs, their_pool = jseeding._candidate_pool_to_centers(
        pts, cand, k, np.random.default_rng(7))
    np.testing.assert_array_equal(mine, theirs)
    assert my_pool == their_pool == max(len(np.unique(cand)), k)
    assert len(np.unique(mine)) == k
    if len(np.unique(cand)) >= k:
        assert np.isin(mine, cand).all()


def test_recluster_helpers_are_the_reference():
    pts = _mixture(n=700, d=6, seed=2)
    ctr = pts[::37]
    their_idx, _ = jseeding._nearest_chunked(pts, ctr, chunk=256)
    np.testing.assert_array_equal(
        seeding._nearest_chunked(pts, ctr, chunk=256), their_idx)
    w = np.random.default_rng(1).integers(1, 9, size=len(ctr)).astype(float)
    np.testing.assert_array_equal(
        seeding._weighted_kmeanspp_indices(ctr, w, 12,
                                           np.random.default_rng(4)),
        jseeding._weighted_kmeanspp_indices(ctr, w, 12,
                                            np.random.default_rng(4)))


# -- the law of one round -----------------------------------------------------

def test_round_pick_law():
    """Over 3,000 generators, each point's pick count in one round is
    binomial with p = min(1, ell * d2 / phi): a z-bound per point (Bonferroni
    over the points) and a chi-square over all points with 0 < p < 1."""
    n, ell, reps = 64, 32.0, 3000
    pts = torch.from_numpy(_mixture(n=n, d=3, k_true=4, spread=5.0,
                                    seed=1).astype(np.float32))
    d2 = ((pts - pts[0]) ** 2).sum(dim=1)
    p = torch.clamp(ell * d2 / d2.sum(), max=1.0).double().numpy()
    assert (p == 1.0).any() and (p == 0.0).sum() == 1     # x0 itself
    counts = np.zeros(n)
    for s in range(reps):
        g = torch.Generator().manual_seed(s)
        picked, _ = ds._kmeans_parallel_round(pts, d2, g, ell, cap=n)
        counts += picked.numpy()
    assert (counts[p == 1.0] == reps).all() and counts[p == 0.0].sum() == 0
    mid = (p > 0) & (p < 1)
    var = reps * p[mid] * (1 - p[mid])
    z = (counts[mid] - reps * p[mid]) / np.sqrt(var)
    assert np.abs(z).max() < 4.5, np.abs(z).max()    # ~1e-3 over 64 points
    stat = float((z ** 2).sum())
    crit = conf._chi2_isf(1e-3, int(mid.sum()))
    assert stat < crit, (stat, crit)


def test_round_keeps_the_first_cap_wanted_points():
    """With a small cap, the kept picks are the lowest-index wanted points;
    the dropped ones neither count as picked nor lower d2, and the kept
    ones lower d2 to their exact distance."""
    n, cap = 200, 5
    pts = torch.from_numpy(_mixture(n=n, d=4, seed=3).astype(np.float32))
    d2 = ((pts - pts[7]) ** 2).sum(dim=1)
    g = torch.Generator().manual_seed(11)
    u = torch.rand(n, generator=torch.Generator().set_state(g.get_state()))
    want = u < torch.clamp(50.0 * d2 / d2.sum(), max=1.0)
    assert int(want.sum()) > 3 * cap
    picked, new_d2 = ds._kmeans_parallel_round(pts, d2, g, 50.0, cap)
    first = torch.nonzero(want).flatten()[:cap]
    assert torch.equal(torch.nonzero(picked).flatten(), first)
    exact = ((pts[:, None, :].double() - pts[first][None].double()) ** 2
             ).sum(-1).min(dim=1).values
    expect = torch.minimum(d2.double(), exact)
    x_sq = (pts.double() ** 2).sum(dim=1)
    torch.testing.assert_close(new_d2.double(), expect, rtol=1e-5,
                               atol=float(1e-5 * x_sq.max()))


def test_rounds_return_the_distance_to_the_selected_set():
    pts = torch.from_numpy(_mixture(n=600, d=5, spread=3.0,
                                    seed=4).astype(np.float32))
    sel, d2 = ds.device_kmeans_parallel_rounds(
        pts, torch.Generator().manual_seed(0), 12.0, rounds=5, cap=48)
    chosen = torch.nonzero(sel).flatten()
    assert 1 < len(chosen) <= 1 + 5 * 48
    exact = ((pts[:, None, :].double() - pts[chosen][None].double()) ** 2
             ).sum(-1).min(dim=1).values
    x_sq = (pts.double() ** 2).sum(dim=1)
    torch.testing.assert_close(d2.double(), exact, rtol=1e-5,
                               atol=float(1e-5 * x_sq.max()))
    assert float(d2[chosen].max()) <= float(1e-5 * x_sq.max())


# -- the slice as a whole against the JAX package ------------------------------

def test_cost_cross_check_vs_jax():
    """32-seed mean costs of the port's plan and of the JAX package's
    `kmeans||/device` seeder within 5%, and both clearly below uniform
    seeding."""
    pts = _mixture()
    k = 24
    plan = _plan(k)
    plan.prepare(pts)
    jax_costs, port_costs = [], []
    for s in range(32):
        theirs = jds.device_kmeans_parallel_seeder(
            pts, k, np.random.default_rng(s), interpret=True)
        # The prepare draws nothing, so refit(seed=s) takes the draws of
        # a fresh plan with seed s.
        mine = plan.refit(seed=s)
        idx = mine.indices.numpy()
        assert len(np.unique(idx)) == k
        jax_costs.append(seeding.clustering_cost(pts, pts[theirs.indices]))
        port_costs.append(seeding.clustering_cost(pts, pts[idx]))
    jax_mean, port_mean = np.mean(jax_costs), np.mean(port_costs)
    assert abs(port_mean / jax_mean - 1.0) < 0.05, (jax_mean, port_mean)
    rng = np.random.default_rng(0)
    uni = np.mean([
        seeding.clustering_cost(pts, pts[rng.choice(len(pts), k,
                                                    replace=False)])
        for _ in range(4)
    ])
    assert port_mean < 0.7 * uni


# -- the plan contract ---------------------------------------------------------

def test_plan_fit_contract():
    pts = _mixture(n=900, d=4, k_true=10, seed=3)
    plan = _plan(20, seed=5)
    ops.reset_launch_counts()
    res = plan.fit(pts)
    assert ops.launch_counts()["pairwise_argmin"] == 0    # CPU: plain only
    idx = res.indices
    assert idx.dtype == torch.int32 and idx.shape == (20,)
    assert len(torch.unique(idx)) == 20
    host = idx.numpy().astype(np.int64)
    np.testing.assert_array_equal(res.centers.numpy(),
                                  pts[host].astype(np.float32))
    assert float(res.cost) == pytest.approx(
        seeding.clustering_cost(pts, pts[host]), rel=1e-4)
    assert res.extras["pool_size"] == res.extras["num_candidates"] >= 20
    assert plan.caps.needs_quantize is False
    assert plan.impl.device_native is False


def test_refit_does_no_reprepare_and_one_seed_replays():
    pts = _mixture(n=800, d=4, seed=8)
    plan = _plan(16, seed=2)
    first = plan.fit(pts)
    other = plan.refit(seed=9)
    again = plan.fit()
    same = plan.fit(pts)
    info = plan.cache_info()
    assert info["prepare_builds"] == 1 and info["prepare_hits"] == 1
    assert info["solves"] == 4 and info["entries"] == 1
    torch.testing.assert_close(again.indices, first.indices, rtol=0, atol=0)
    torch.testing.assert_close(same.indices, first.indices, rtol=0, atol=0)
    torch.testing.assert_close(plan.refit(seed=9).indices, other.indices,
                               rtol=0, atol=0)
    assert not torch.equal(other.indices, first.indices)


@pytest.mark.parametrize("name", ["fastkmeans++", "rejection", "kmeans||"])
def test_seed_fn_contract(name):
    """The `DEVICE_SEEDERS` facades, as `tests/test_kmeans_parallel.py`
    holds the JAX package's: k distinct indices, their centers, and the
    same indices as the plan's solve from the same rng."""
    pts = _mixture(n=900, d=4, k_true=10, seed=3)
    k = 20
    res = ds.DEVICE_SEEDERS[name](pts, k, np.random.default_rng(0),
                                  device="cpu")
    assert res.indices.shape == (k,) and res.indices.dtype == np.int64
    assert len(np.unique(res.indices)) == k
    np.testing.assert_array_equal(res.centers, pts[res.indices])
    assert res.num_candidates >= k
    plan = ClusterPlan(ClusterSpec(k=k, seeder=name, c=1.2, quantize=False),
                       CPU)
    np.testing.assert_array_equal(plan.fit(pts).indices.numpy(), res.indices)
    if name == "kmeans||":
        assert res.extras["pool_size"] == res.num_candidates
    # `device_native` is read by no code of the port; it is held here to
    # the JAX registration.
    assert (plan.impl.device_native
            is jregistry.get_seeder_spec(name).impl("device").device_native)
