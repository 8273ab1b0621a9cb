"""The port's CPU seeders and host structures against the JAX package's.

Both packages' CPU seeders are NumPy driven by one `np.random.Generator`,
so the port is held to the same indices, not only to the same law:

  * each of the six seeders (and Algorithm 4 under a `BatchSchedule`), over
    three seeds and two shapes (one quantised, seeded with
    ``resolution=1.0``): the same indices, `num_candidates`, extras and
    generator state afterwards;
  * `BatchSchedule.propose`, `MultiTreeSampler`'s weights and draws,
    `MonotoneLSH.query_batch` and the tree-distance helpers: equal values;
  * the contracts of `tests/test_seeding.py` and `tests/test_multitree.py`,
    run against the port.
"""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import seeding as jseeding
from repro.core import tree_embedding as jtree
from repro.core.batch_schedule import BatchSchedule as JaxBatchSchedule
from repro.core.lsh import MonotoneLSH as JaxMonotoneLSH
from repro.core.multitree import MultiTreeSampler as JaxMultiTreeSampler
from repro.core.preprocess import quantize as jax_quantize
from repro_torch.core import KMeansConfig, fit
from repro_torch.core import seeding
from repro_torch.core import tree_embedding
from repro_torch.core.batch_schedule import BatchSchedule
from repro_torch.core.lloyd import assign
from repro_torch.core.lsh import MonotoneLSH
from repro_torch.core.multitree import MultiTreeSampler

CPU_SEEDERS = ["kmeans++", "fastkmeans++", "rejection", "kmeans||", "afkmc2",
               "uniform"]


def _mixture(n=600, d=4, k_true=10, seed=0):
    """The JAX suite's mixture (`tests/test_plan.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _clustered(n=4000, d=8, k_true=25, seed=0):
    """`tests/test_seeding.py`'s fixture."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 10
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


SHAPES = {
    "raw": (_mixture(seed=3), {}),
    "quantised": (jax_quantize(_mixture(n=800, d=6, seed=4),
                               np.random.default_rng(1)).points,
                  {"resolution": 1.0}),
}


# -- the same indices as the JAX package ------------------------------------

def _both(name, pts, k, seed, kw, schedule=False):
    jkw, pkw = dict(kw), dict(kw)
    if schedule:
        jkw["schedule"], pkw["schedule"] = JaxBatchSchedule(), BatchSchedule()
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jseeding.SEEDERS[name](pts, k, jrng, **jkw)
    got = seeding.SEEDERS[name](pts, k, prng, **pkw)
    return want, got, jrng, prng


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", CPU_SEEDERS)
def test_cpu_seeder_matches_jax_package(name, shape, seed):
    pts, kw = SHAPES[shape]
    want, got, jrng, prng = _both(name, pts, 12, seed, kw)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.centers, want.centers)
    assert got.num_candidates == want.num_candidates
    assert got.extras == want.extras
    assert prng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_rejection_with_schedule_matches_jax_package(shape, seed):
    """A `BatchSchedule` steps the block with `propose` every block."""
    pts, kw = SHAPES[shape]
    want, got, jrng, prng = _both("rejection", pts, 12, seed, kw,
                                  schedule=True)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.num_candidates == want.num_candidates
    assert got.extras == want.extras
    assert prng.bit_generator.state == jrng.bit_generator.state


def test_propose_matches_jax_package():
    """Float32 `safety / p`, as the JAX package's traced `_ideal`: the same
    bucket for every rate, the ladder's exact boundaries included."""
    rates = np.concatenate([np.random.default_rng(0).uniform(0, 1, 500),
                            3.0 / np.arange(1, 600), [0.0, 1.0]])
    for sched, jsched in ((BatchSchedule(), JaxBatchSchedule()),
                          (BatchSchedule(min_batch=16, max_batch=1024,
                                         safety=2.5),
                           JaxBatchSchedule(min_batch=16, max_batch=1024,
                                            safety=2.5))):
        for prev in sched.buckets():
            got = [sched.propose(prev, float(a)) for a in rates]
            want = [jsched.propose(prev, float(a)) for a in rates]
            assert got == want


def test_registry_declares_the_jax_packages_chain():
    from repro.core import registry as jregistry
    from repro_torch.core import registry

    for name in CPU_SEEDERS:
        spec, jspec = (registry.get_seeder_spec(name),
                       jregistry.get_seeder_spec(name))
        assert (spec.doc, spec.fallback) == (jspec.doc, jspec.fallback)
        assert _fields(spec.caps) == _fields(jspec.caps)
        assert seeding.SEEDERS[name] is spec.impl("cpu").run


def _fields(obj) -> dict:
    return {f: getattr(obj, f) for f in obj.__dataclass_fields__}


# -- host structures against the JAX package --------------------------------

@pytest.mark.parametrize("n,d,seed", [(400, 3, 0), (2000, 8, 5)])
def test_multitree_sampler_matches_jax_package(n, d, seed):
    """Weights and sample-tree heap after a sequence of opens equal the JAX
    package's bit for bit and the brute force to 1e-9; draws agree."""
    pts = np.random.default_rng(seed).normal(size=(n, d)) * 7
    mt = MultiTreeSampler(pts, seed=seed)
    jmt = JaxMultiTreeSampler(pts, seed=seed)
    r, jr = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    opened = []
    for i in range(30):
        x = int(r.integers(n)) if i == 0 else mt.sample(r)
        jx = int(jr.integers(n)) if i == 0 else jmt.sample(jr)
        assert x == jx
        mt.open(x)
        jmt.open(jx)
        opened.append(x)
        np.testing.assert_array_equal(mt.weights, jmt.weights)
    np.testing.assert_array_equal(mt.sample_tree.heap, jmt.sample_tree.heap)
    np.testing.assert_array_equal(mt.sample_batch(r, 256),
                                  jmt.sample_batch(jr, 256))
    bf = mt.brute_force_weights(np.array(opened))
    np.testing.assert_array_equal(bf, jmt.brute_force_weights(
        np.array(opened)))
    assert np.allclose(mt.weights, bf, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("inserts", [5, 32, 70])
def test_lsh_query_batch_matches_jax_package(inserts):
    """Ids and distances of `query_batch` equal the JAX package's, with
    centers in the sorted tables, in the pending buffer and in both."""
    rng = np.random.default_rng(inserts)
    pts = rng.normal(size=(1500, 6)) * 5
    lsh = MonotoneLSH(6, r=4.0, seed=3, capacity=16, rebuild_every=32)
    jlsh = JaxMonotoneLSH(6, r=4.0, seed=3, capacity=16, rebuild_every=32)
    for x in rng.choice(len(pts), inserts, replace=False):
        assert lsh.insert(pts[x]) == jlsh.insert(pts[x])
    ids, d2 = lsh.query_batch(pts)
    jids, jd2 = jlsh.query_batch(pts)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d2, jd2)
    assert lsh.query(pts[0]) == jlsh.query(pts[0])
    np.testing.assert_array_equal(lsh.hash_keys(pts), jlsh.hash_keys(pts))
    assert np.isinf(d2[ids < 0]).all() and (ids >= 0).any()


def test_lsh_query_on_empty_raises():
    with pytest.raises(ValueError, match="empty"):
        MonotoneLSH(3).query_batch(np.zeros((2, 3)))


def test_tree_distance_helpers_match_jax_package():
    pts = np.random.default_rng(2).normal(size=(300, 5)) * 3
    emb = tree_embedding.build_multitree(pts, seed=4)
    jemb = jtree.build_multitree(pts, seed=4)
    i = np.arange(300)
    j = np.random.default_rng(3).permutation(300)
    for t, jt in zip(emb.trees, jemb.trees):
        np.testing.assert_array_equal(
            tree_embedding.sep_levels(t.codes[:, i], t.codes[:, j]),
            jtree.sep_levels(jt.codes[:, i], jt.codes[:, j]))
    sep = np.arange(emb.num_levels + 1)
    np.testing.assert_array_equal(
        tree_embedding.tree_dist_from_sep(sep, emb.max_dist, emb.num_levels,
                                          emb.dim),
        jtree.tree_dist_from_sep(sep, jemb.max_dist, jemb.num_levels,
                                 jemb.dim))
    np.testing.assert_array_equal(
        tree_embedding.multitree_dist_sq_points(emb, i[:, None], j[None, :50]),
        jtree.multitree_dist_sq_points(jemb, i[:, None], j[None, :50]))


# -- the contracts of tests/test_seeding.py, run against the port -----------

@pytest.mark.parametrize("algo", list(seeding.SEEDERS))
def test_seeder_basic_contract(algo):
    pts = _clustered()
    kw = {"device": "cpu"} if algo.endswith(("/device", "/sharded")) else {}
    res = seeding.SEEDERS[algo](pts, 30, np.random.default_rng(0), **kw)
    assert res.indices.shape == (30,)
    assert res.centers.shape == (30, pts.shape[1])
    assert np.isfinite(res.centers).all()
    if algo != "uniform":
        assert len(np.unique(res.indices)) == 30


def test_quality_ordering_uniform_worst():
    rng = np.random.default_rng(3)
    ctr = rng.normal(size=(25, 8)) * 40
    pts = ctr[rng.integers(25, size=4000)] + rng.normal(size=(4000, 8))
    costs = {}
    for algo in ("kmeans++", "fastkmeans++", "rejection", "uniform"):
        costs[algo] = np.mean([
            seeding.clustering_cost(pts, seeding.SEEDERS[algo](
                pts, 20, np.random.default_rng(s)).centers)
            for s in range(3)])
    assert costs["fastkmeans++"] < 0.6 * costs["uniform"]
    assert costs["rejection"] < 0.6 * costs["uniform"]
    assert costs["fastkmeans++"] < 1.35 * costs["kmeans++"]
    assert costs["rejection"] < 1.35 * costs["kmeans++"]


def test_rejection_distribution_c2_close():
    """Lemma 5.2: with exact-NN acceptance, accepted samples follow D^2
    within a factor of about c^2."""
    pts = _clustered(n=400, d=4, k_true=6, seed=5)
    rng = np.random.default_rng(0)
    opened = [3, 77, 200]
    _, d2 = assign(pts, pts[opened])
    p_exact = d2 / d2.sum()
    mt = MultiTreeSampler(pts, seed=1)
    for x in opened:
        mt.open(x)
    c2 = 1.2 ** 2
    counts = np.zeros(len(pts))
    draws = 0
    while draws < 4000:
        cand = mt.sample_batch(rng, 256)
        us = rng.uniform(size=256)
        _, cd2 = assign(pts[cand], pts[opened])
        acc = us < cd2 / np.maximum(c2 * mt.weights[cand], 1e-300)
        for x in cand[acc]:
            counts[x] += 1
            draws += 1
    p_emp = counts / counts.sum()
    mask = p_exact > 0.005
    ratio = p_emp[mask] / p_exact[mask]
    assert (ratio > 1 / (c2 * 2.0)).all() and (ratio < c2 * 2.0).all()


def test_rejection_trials_bounded_by_lemma():
    pts = _clustered(n=3000, d=6, seed=7)
    res = seeding.rejection_sampling(pts, 50, np.random.default_rng(1), c=1.2)
    assert res.extras["trials_per_center"] <= 48 * (1.2 ** 2) * 6 * 6


def test_rejection_fallback_counts_trials():
    """All points identical: every weight is 0 after the first open, so the
    safety net opens the rest, and each of its draws is a trial."""
    pts = np.zeros((10, 3))
    res = seeding.rejection_sampling(pts, 5, np.random.default_rng(0))
    assert res.indices.shape == (5,)
    assert (res.indices >= 0).all() and (res.indices < len(pts)).all()
    assert res.num_candidates >= 5
    assert res.extras["trials_per_center"] >= 1.0


def test_rejection_trials_at_least_k():
    pts = _clustered(n=500, d=4, seed=11)
    res = seeding.rejection_sampling(pts, 20, np.random.default_rng(2))
    assert res.num_candidates >= 20


def test_fit_facade_with_lloyd():
    pts = _clustered(seed=9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        km = fit(pts, KMeansConfig(k=25, seeder="rejection", backend="cpu",
                                   lloyd_iters=5))
        seeded = fit(pts, KMeansConfig(k=25, seeder="rejection",
                                       backend="cpu"))
    assert km.cost <= seeded.cost
    pred = km.predict(pts[:100])
    assert pred.shape == (100,) and (pred < 25).all()


# -- the contracts of tests/test_multitree.py, run against the port ---------

@settings(max_examples=12, deadline=None)
@given(st.integers(5, 120), st.integers(1, 8), st.integers(0, 10_000),
       st.integers(1, 25))
def test_invariant_weights_match_brute_force(n, d, seed, opens):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)) * rng.uniform(0.1, 30)
    mt = MultiTreeSampler(pts, seed=seed)
    opened = []
    r = np.random.default_rng(seed + 1)
    for i in range(min(opens, n)):
        x = int(r.integers(n)) if i == 0 else mt.sample(r)
        mt.open(x)
        opened.append(x)
    bf = mt.brute_force_weights(np.array(opened))
    assert np.allclose(mt.weights, bf, rtol=1e-9, atol=1e-9)
    assert np.isclose(mt.total_weight(), mt.weights.sum(), rtol=1e-6)


def test_opened_points_get_zero_weight():
    pts = np.random.default_rng(0).normal(size=(50, 4))
    mt = MultiTreeSampler(pts, seed=0)
    mt.open(7)
    assert mt.weights[7] == 0.0
    mt.open(12)
    assert mt.weights[12] == 0.0
    draws = mt.sample_batch(np.random.default_rng(1), 500)
    assert not np.isin(draws, [7, 12]).any()


def test_weights_monotone_decreasing():
    pts = np.random.default_rng(3).normal(size=(80, 6)) * 4
    mt = MultiTreeSampler(pts, seed=1)
    prev = mt.weights.copy()
    r = np.random.default_rng(2)
    for i in range(15):
        x = int(r.integers(80)) if i == 0 else mt.sample(r)
        mt.open(x)
        assert (mt.weights <= prev + 1e-12).all()
        prev = mt.weights.copy()


def test_duplicate_points_handled():
    base = np.random.default_rng(4).normal(size=(10, 3))
    mt = MultiTreeSampler(np.concatenate([base, base]), seed=2)
    mt.open(0)
    assert mt.weights[10] == 0.0
