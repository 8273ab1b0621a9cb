"""The port's seeders and plan against the JAX package's, on the CPU.

Torch's generators cannot replay JAX's threefry stream, so the port's draws
are held to the same law rather than to the same indices:

  * the chi-square and total-variation tests of `tests/test_conformance.py`
    on the first two centers, with its fixture and thresholds;
  * the cost cross-check of `tests/test_device_rejection.py`: 8-seed mean
    costs of the port and of the JAX `rejection/device` seeder within 5%
    (and the same for Algorithm 3);
  * the Lemma 5.3 trials ballpark.

Where no randomness is involved the port is held to the JAX package's
numbers directly: replaying the same centers through both packages' sweeps
gives the same weights and coarse heap.  `refit` does no re-prepare.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_conformance as conf
from repro.core import device_seeding as jds
from repro.core import sample_tree as jst
from repro.core.lloyd import lloyd as jax_package_lloyd
from repro.core.seeding import clustering_cost
from repro_torch.core import device_seeding as ds
from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec

CPU = ExecutionSpec(device="cpu")


def _mixture(n=1200, d=5, k_true=12, spread=40.0, seed=0):
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * spread
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _fit_indices(pts, k, seed, seeder="rejection", **spec):
    """The port's plan on unquantised points: the same rng draws, in the
    same order, as the JAX package's `<seeder>/device` seed_fn."""
    plan = ClusterPlan(ClusterSpec(k=k, seeder=seeder, quantize=False,
                                   seed=seed, **spec), CPU)
    return plan.fit(pts)


# -- the conformance law ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_draws() -> np.ndarray:
    pts = conf._fixture()
    kw = conf.SEEDER_KW
    out = np.empty((conf.R, 2), dtype=np.int64)
    for s in range(conf.R):
        res = _fit_indices(pts, 2, 10_000 + s, c=kw["c"],
                           options={"lsh_r": kw["lsh_r"],
                                    "resolution": kw["resolution"]})
        out[s] = res.indices.numpy()
    return out


def _chi2(draws: np.ndarray, law: np.ndarray):
    assignment = conf._mass_balanced_bins(law, conf.BINS)
    counts = conf._binned(np.bincount(draws, minlength=conf.N).astype(float),
                          assignment, conf.BINS)
    expected = conf._binned(law, assignment, conf.BINS) * conf.R
    return counts, expected, conf._chi2_stat(counts, expected)


def test_first_center_uniform():
    uniform, _ = conf._exact_laws(conf._fixture())
    _, _, stat = _chi2(_port_draws()[:, 0], uniform)
    crit = conf._chi2_isf(conf.ALPHA / conf.N_TESTS, conf.BINS - 1)
    assert stat < crit, (stat, crit)


def test_second_center_exact_d2():
    _, marg2 = conf._exact_laws(conf._fixture())
    counts, expected, stat = _chi2(_port_draws()[:, 1], marg2)
    assert expected.min() > 20.0
    crit = conf._chi2_isf(conf.ALPHA / conf.N_TESTS, conf.BINS - 1)
    assert stat < crit, (stat, crit)
    tv = 0.5 * np.abs(counts / conf.R - expected / conf.R).sum()
    assert tv < conf.TV_BOUND, tv


# -- the slice as a whole against the JAX package -----------------------------

@pytest.mark.parametrize("seeder,jax_seed_fn", [
    ("rejection", jds.device_rejection_seeder),
    ("fastkmeans++", jds.device_fast_kmeanspp_seeder),
])
def test_cost_cross_check_vs_jax(seeder, jax_seed_fn):
    """8-seed mean costs of the port and of the JAX device seeder agree
    within 5% on the `test_device_rejection.py` mixture, and both clearly
    beat uniform seeding."""
    pts = _mixture(n=1200, d=5, k_true=12, seed=6)
    k = 24
    jax_costs, port_costs = [], []
    for s in range(8):
        theirs = jax_seed_fn(pts, k, np.random.default_rng(s), c=1.2)
        mine = _fit_indices(pts, k, s, seeder=seeder, c=1.2)
        idx = mine.indices.numpy()
        assert len(np.unique(idx)) == k
        jax_costs.append(clustering_cost(pts, pts[theirs.indices]))
        port_costs.append(clustering_cost(pts, pts[idx]))
        assert float(mine.cost) == pytest.approx(port_costs[-1], rel=1e-4)
    jax_mean, port_mean = np.mean(jax_costs), np.mean(port_costs)
    assert abs(port_mean / jax_mean - 1.0) < 0.05, (jax_mean, port_mean)
    rng = np.random.default_rng(0)
    uni = np.mean([
        clustering_cost(pts, pts[rng.choice(len(pts), k, replace=False)])
        for _ in range(4)
    ])
    assert port_mean < 0.7 * uni


def test_trials_per_center_lemma_ballpark():
    """Lemma 5.3: E[trials/center] = O(c^2 d^2), with the constant of the
    JAX package's test."""
    pts = _mixture(n=1500, d=6, k_true=15, seed=7)
    res = _fit_indices(pts, 30, 1, c=1.2)
    trials = res.extras["trials"]
    assert trials.shape == (30,) and (trials >= 1).all()
    tpc = float(trials.sum()) / 30
    assert 1.0 <= tpc <= 48 * (1.2 ** 2) * 6 * 6
    assert sum(res.extras["rounds_per_batch"].values()) >= 29


def test_replayed_centers_match_jax_sweeps():
    """The same artifacts (carried across from the JAX package) and the same
    sequence of opened centers give the same weights and coarse heap in both
    packages: the port's per-center sweep over all trees, its padding and
    its heap refresh are the JAX package's.  The port's refresh sums each
    ancestor from its children, where the JAX package's adds deltas that
    drift, so its heap is held to the JAX package's heap rebuilt from the
    JAX package's own tile sums."""
    pts = _mixture(n=1100, d=5, seed=9)
    jdata = jds.prepare_rejection(pts, seed=3, resolution=0.5)
    data = ds.seeding_data_from_arrays(jdata, device="cpu")
    n = pts.shape[0]
    meta = dict(scale=data.scale, num_levels=data.num_levels, tile=512)
    ts, open_center, weights, coarse = ds._initial_state(
        data.codes_lo, data.codes_hi, m_init=data.m_init, **meta)
    jts = jst.TiledSampleTree(n, tile=512)
    jopen = jds._make_open_center(
        jds._pad_axis(jdata.codes_lo, 2, jts.n_pad),
        jds._pad_axis(jdata.codes_hi, 2, jts.n_pad), interpret=True, **meta)
    jweights = jnp.asarray(weights.numpy())
    jcoarse = jts.init(jweights)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(jcoarse), rtol=1e-6)
    for x in np.random.default_rng(0).choice(n, 12, replace=False):
        weights, tsums = open_center(weights, int(x))
        coarse = ts.refresh(coarse, tsums)
        jweights, jtsums = jopen(jweights, int(x))
        jcoarse = jts.coarse.init(jtsums)
        # XLA's CPU exp2 is a few ulps off on deep separation levels (see
        # test_torch_kernels): f32 rounding, not a different weight.
        np.testing.assert_allclose(weights.numpy(), np.asarray(jweights),
                                   rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(coarse.numpy(), np.asarray(jcoarse),
                                   rtol=1e-5, atol=1e-6 * float(coarse[1]))
        assert float(weights[int(x)]) == 0.0


# -- the plan contract and the seeder's edge cases ---------------------------

def test_refit_does_no_reprepare(monkeypatch):
    pts = _mixture(n=900, d=4, seed=10)
    plan = ClusterPlan(ClusterSpec(k=12, seed=5), CPU)
    first = plan.fit(pts)

    def no_prepare(*args, **kwargs):
        raise AssertionError("refit must not re-prepare")

    monkeypatch.setattr(ds, "prepare_rejection", no_prepare)
    other = plan.refit(seed=7)
    again = plan.fit()                     # the spec's seed: replayed draws
    same = plan.fit(pts)                   # same data: a cache hit
    info = plan.cache_info()
    assert info["prepare_builds"] == 1 and info["prepare_hits"] == 1
    assert info["solves"] == 4 and info["entries"] == 1
    assert other.prepare_seconds == first.prepare_seconds
    torch.testing.assert_close(again.indices, first.indices)
    torch.testing.assert_close(same.indices, first.indices)
    assert not torch.equal(other.indices, first.indices)
    assert first.centers.shape == (12, 4) and first.indices.dtype == torch.int32
    np.testing.assert_array_equal(first.centers.numpy(),
                                  pts[first.indices.numpy()].astype(np.float32))
    host = first.to_numpy()
    assert host.indices.dtype == np.int64 and isinstance(host.cost, float)
    predicted = first.predict(pts).numpy()
    assert predicted.shape == (900,) and predicted.max() < 12


def test_lloyd_refinement_matches_jax_package():
    """`lloyd_iters > 0` refines the seeding on the host exactly as the JAX
    package's `lloyd` does from the same centers."""
    pts = _mixture(n=800, d=4, seed=12)
    res = ClusterPlan(ClusterSpec(k=10, lloyd_iters=3), CPU).fit(pts)
    seeded = ClusterPlan(ClusterSpec(k=10), CPU).fit(pts)
    torch.testing.assert_close(res.indices, seeded.indices)
    expect = jax_package_lloyd(pts, pts[seeded.indices.numpy()], max_iters=3)
    assert res.extras["lloyd_iterations"] == expect.iterations
    np.testing.assert_allclose(res.centers.numpy(), expect.centers,
                               rtol=1e-6)
    assert float(res.cost) == pytest.approx(expect.cost, rel=1e-6)
    assert float(res.cost) <= float(seeded.cost) * (1 + 1e-6)


def test_exhausted_rounds_open_the_first_candidate():
    """With every point colliding and c huge, acceptance has probability
    below 1e-4, so each center after the first exhausts `max_rounds` and
    opens `cand[0]` of its last block, an exact multi-tree D^2 draw."""
    pts = _mixture(n=400, d=3, seed=11)
    res = _fit_indices(pts, 6, 2, c=100.0,
                       options={"lsh_r": 1e6, "max_rounds": 2, "batch": 32})
    trials = res.extras["trials"].numpy()
    assert trials[0] == 1 and (trials[1:] == 64).all()
    assert len(np.unique(res.indices.numpy())) == 6


def test_all_zero_weights_open_uniform_draws():
    """All-duplicate points: after the first center every weight is 0, so
    each later center is a uniform draw with one trial, as in the JAX
    package."""
    pts = np.tile(np.array([[1.0, 2.0, 3.0]]), (50, 1))
    res = _fit_indices(pts, 5, 0)
    assert res.indices.shape == (5,) and (res.indices < 50).all()
    assert (res.extras["trials"] == 1).all()
    assert float(res.cost) == 0.0
