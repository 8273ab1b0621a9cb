"""The port's sharded backend against the JAX package's, on the CPU.

The port drives D shards from one controller; here the shards are D CPU
devices (`make_seeding_mesh(D, device="cpu")`, D = 1, 2 and 4), where the
JAX package's CI forces four host devices.  The JAX package's sharded
backend runs on its 1-device CPU mesh: its law does not depend on D.

  * the registration and the facade of `tests/test_sharded_seeding.py`,
    with ``extras["devices"] == mesh.size``;
  * the shard-then-descend sampler draws each point with probability
    w / (sum over all shards) over 120,000 draws, and never a zero weight,
    a whole empty shard included;
  * the prepared artifacts, cut back together, and the NumPy rng state
    after prepare and after solve equal the JAX sharded prepare's and
    solve's, bit for bit, for the three seeders;
  * 8-seed mean costs of Algorithms 3 and 4 within 5% of the JAX sharded
    mean and of the port's device backend mean; the trials contract;
    k-means|| within 5% of the CPU loop, and its recluster of the sharded
    pool bit-identical to the JAX package's;
  * the plan: the legacy `fit` and `ClusterPlan.fit` open the same
    indices, a refit under `no_retrace()` prepares nothing, `fit_batch`
    lanes are the refits, the mesh resolves and checks its devices;
  * the chi-square and total-variation law of `tests/test_conformance.py`
    at D = 4 with ``tile=32``, on a static fit and on a mutated stream;
  * the streaming fallback: extend and retire go to the host stream, a
    warning is logged once, the next solve re-shards (``resharded``), its
    indices live; and the scratch equivalence of `tests/test_streaming.py`;
  * the engine: a transient fault on rejection/sharded is served by
    rejection/device, whose execution carries no mesh.
"""

import functools
import logging
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_conformance as conf
from repro.core import ClusterPlan as JaxClusterPlan
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import ExecutionSpec as JaxExecutionSpec
from repro.core import SEEDER_SPECS as JAX_SPECS
from repro.core import SEEDERS as JAX_SEEDERS
from repro.core import seeding as jseeding
from repro.core.resilience import fallback_chain as jax_fallback_chain
from repro_torch.core import (
    ClusterEngine,
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    FaultPlan,
    KMeansConfig,
    RetryPolicy,
    SEEDER_SPECS,
    SEEDERS,
    clustering_cost,
    fit,
    no_retrace,
    resolve_seeder,
)
from repro_torch.core import seeding
from repro_torch.core import sharded_seeding as shs
from repro_torch.core.resilience import fallback_chain
from repro_torch.core.sample_tree import TiledSampleTree
from repro_torch.launch.mesh import SeedingMesh, make_seeding_mesh

MESHES = [1, 2, 4]
ENGINE_LIMIT = 120


@pytest.fixture(autouse=True)
def _one_thread():
    """Every tensor here is small (at most 2,048 rows a shard), so the ops
    run on one thread: when the suite's workers share the cores, OpenMP
    teams spun up for each small op stall one another (a 13 s test took
    over 600 s so)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(d: int) -> SeedingMesh:
    return make_seeding_mesh(d, device="cpu")


def _mixture(n=1200, d=5, k_true=12, spread=40.0, seed=0):
    """The JAX suite's mixture (`tests/test_sharded_seeding.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * spread
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _plan(seeder, d, *, tile=512, **spec):
    return ClusterPlan(ClusterSpec(seeder=seeder, **spec), ExecutionSpec(
        backend="sharded", device="cpu", tile=tile, mesh=_mesh(d)))


def _legacy_fit(pts, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fit(pts, KMeansConfig(**kw))


# -- registration and the facade ----------------------------------------------

@pytest.mark.parametrize("d", MESHES)
def test_registration_and_facade(d):
    assert resolve_seeder("rejection", "sharded") \
        is SEEDERS["rejection/sharded"]
    assert resolve_seeder("fastkmeans++", "sharded") \
        is SEEDERS["fastkmeans++/sharded"]
    assert shs.SHARDED_SEEDERS["kmeans||"] is SEEDERS["kmeans||/sharded"]
    with pytest.raises(KeyError):
        resolve_seeder("kmeans++", "sharded")
    pts = _mixture(n=600, d=4, k_true=8, seed=1)
    km = _legacy_fit(pts, k=10, seeder="rejection", backend="sharded",
                     device="cpu", seeder_kwargs={"mesh": _mesh(d)})
    assert km.centers.shape == (10, 4)
    assert km.seeding.extras["backend"] == "sharded"
    assert km.seeding.extras["devices"] == d
    assert len(np.unique(km.seeding.indices)) == 10
    sharded = {n for n, spec in SEEDER_SPECS.items()
               if "sharded" in spec.impls}
    assert sharded == {n for n, spec in JAX_SPECS.items()
                       if "sharded" in spec.impls}
    for name in sharded:
        mine = SEEDER_SPECS[name].impl("sharded")
        theirs = JAX_SPECS[name].impl("sharded")
        assert mine.device_native == theirs.device_native, name
        assert mine.supports_stacked == theirs.supports_stacked, name
        assert getattr(mine.streaming, "native", None) == \
            getattr(theirs.streaming, "native", None), name


# -- the shard sampler's law --------------------------------------------------

@pytest.mark.parametrize("d,empty_shard", [(1, False), (2, False),
                                           (4, False), (2, True), (4, True)])
def test_shard_sampler_distribution(d, empty_shard):
    """Shard-then-descend draws each point with probability w_x / total
    across ALL shards, and never a zero-weight point (a whole shard at 0
    included), as `tests/test_sharded_seeding.py` holds the JAX one."""
    tile = 32
    n = d * tile * 4                          # 4 tiles a shard
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 2, size=n).astype(np.float32)
    w[rng.choice(n, n // 5, replace=False)] = 0.0
    if empty_shard:
        w[(d - 1) * n // d:] = 0.0            # the last shard holds nothing
    data = shs.ShardedData(mesh=_mesh(d), tile=tile, n_real=n,
                           n_loc=n // d)
    ts_loc = TiledSampleTree(n // d, tile=tile)
    weights = list(torch.from_numpy(w).chunk(d))
    heaps = [ts_loc.init(x) for x in weights]
    g = torch.Generator().manual_seed(0)
    m = 120_000
    x, owner, _, total = shs._shard_sampler(data, ts_loc)(heaps, weights,
                                                          g, m)
    draws = x.numpy()
    assert (owner.numpy() == draws // (n // d)).all()
    assert float(total) == pytest.approx(float(w.sum()), rel=1e-5)
    freq = np.bincount(draws, minlength=n) / m
    p = w / w.sum()
    assert (freq[w == 0.0] == 0.0).all()
    np.testing.assert_allclose(freq, p, atol=0.01)


# -- prepared artifacts and the rng contract ----------------------------------

_JAX_FIELDS = {"fastkmeans++": lambda a: dict(codes_lo=a[0], codes_hi=a[1]),
               "rejection": lambda a: {f: getattr(a[0], f) for f in (
                   "codes_lo", "codes_hi", "points", "keys_lo", "keys_hi")},
               "kmeans||": lambda a: dict(points=a[0])}


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("seeder", ["fastkmeans++", "rejection", "kmeans||"])
def test_prepared_artifacts_and_rng_match_jax(seeder, d):
    """The port's sharded prepare, its shards cut back together, equals the
    JAX sharded prepare bit for bit on every real row (zeros past them),
    and the NumPy rng state after prepare and after solve is the JAX
    package's."""
    pts = _mixture(n=700, d=4, k_true=8, seed=4)
    k = 9
    plan = _plan(seeder, d, tile=32, k=k, seed=3)
    jplan = JaxClusterPlan(JaxClusterSpec(k=k, seeder=seeder, seed=3),
                           JaxExecutionSpec(backend="sharded", tile=32 * d))
    prep, jprep = plan.prepare_data(pts), jplan.prepare_data(pts)
    assert prep.rng_state == jprep.rng_state
    np.testing.assert_array_equal(prep.seed_pts, jprep.seed_pts)
    mine, n = prep.artifacts, len(pts)
    assert (mine.mesh.size, mine.n_real) == (d, n)
    assert mine.n_loc * d % (32 * d) == 0 and mine.n_loc * d >= n
    for name, theirs in _JAX_FIELDS[seeder](jprep.artifacts).items():
        axis = shs._POINTS_AXIS[name]
        whole = torch.cat(getattr(mine, name), dim=axis).numpy()
        theirs = np.asarray(theirs)
        np.testing.assert_array_equal(np.take(whole, range(n), axis=axis),
                                      np.take(theirs, range(n), axis=axis))
        assert not np.take(whole, range(n, whole.shape[axis]),
                           axis=axis).any()
        assert not np.take(theirs, range(n, theirs.shape[axis]),
                           axis=axis).any()
    if seeder == "rejection":
        for f in ("scale", "num_levels", "m_init"):
            assert getattr(mine, f) == getattr(jprep.artifacts[0], f)
    rng = np.random.default_rng(3)
    rng.bit_generator.state = prep.rng_state
    jrng = np.random.default_rng(3)
    jrng.bit_generator.state = jprep.rng_state
    plan.impl.solve(mine, prep.seed_pts, k, rng, c=2.0, schedule=None,
                    options={}, execution=plan.execution)
    jplan.impl.solve(jprep.artifacts, jprep.seed_pts, k, jrng, c=2.0,
                     schedule=None, options={}, execution=jplan._ctx)
    assert rng.bit_generator.state == jrng.bit_generator.state


def test_sharded_data_from_arrays_splits_the_jax_artifacts():
    """`sharded_data_from_arrays` carries the JAX package's padded sharded
    artifacts onto the port's shards; the port's solve on them runs."""
    pts = _mixture(n=500, d=4, k_true=8, seed=5)
    jplan = JaxClusterPlan(JaxClusterSpec(k=6, seeder="rejection", seed=1),
                           JaxExecutionSpec(backend="sharded", tile=64))
    jdata, n = jplan.prepare_data(pts).artifacts
    data = shs.sharded_data_from_arrays(jdata, _mesh(4), n_real=n, tile=32)
    assert data.n_loc == 128 and len(data.codes_lo) == 4
    torch.testing.assert_close(torch.cat(data.keys_lo, dim=1)[:, :n],
                               torch.from_numpy(np.asarray(jdata.keys_lo)
                                                [:, :n]), rtol=0, atol=0)
    chosen, trials = shs.sharded_rejection_sampling(
        data, 6, torch.Generator().manual_seed(0))
    assert chosen.shape == (6,) and (chosen < n).all()
    assert len(set(chosen.tolist())) == 6 and (trials >= 1).all()


# -- cost against the JAX package and the device backend ----------------------

# Paired seeds of the mean-cost checks.  One seed's cost on this fixture
# spreads by about 800 (6.5%), so two unbiased 8-seed means differ by
# about 3.3% (one standard deviation) and a 5% gate on 8 seeds fails on
# noise; so do 32 (seeds 0 to 31 put the JAX sharded fastkmeans++ mean
# 2.9% below its 200-seed mean and the port's 2.0% above).  The 200-seed
# means of both packages' backends agree within 1%; 64 seeds take the
# spread of a difference to 1.1% and keep the gate at 5%.
COST_SEEDS = 64


@functools.lru_cache(maxsize=None)
def _costs(name: str, d: int = 0) -> float:
    """Mean cost over `COST_SEEDS` paired seeds on
    `tests/test_sharded_seeding.py`'s fixture (n = 2000, d = 5, k = 36):
    the JAX sharded seeder (d = 0) or the port's `name`, on a mesh of d
    shards where it is sharded."""
    pts = _mixture(n=2000, d=5, k_true=12, seed=6)
    k, out = 36, []
    for s in range(COST_SEEDS):
        rng = np.random.default_rng(s)
        if d == 0:
            res = JAX_SEEDERS[name](pts, k, rng)
        elif name.endswith("/sharded"):
            res = SEEDERS[name](pts, k, rng, device="cpu", mesh=_mesh(d))
            assert res.extras["devices"] == d
        else:
            res = SEEDERS[name](pts, k, rng, device="cpu")
        assert len(np.unique(res.indices)) == k
        out.append(clustering_cost(pts, pts[res.indices]))
    return float(np.mean(out))


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("algo", ["fastkmeans++", "rejection"])
def test_sharded_mean_cost_matches_jax_and_device(algo, d):
    mine = _costs(f"{algo}/sharded", d)
    theirs = _costs(f"{algo}/sharded")
    device = _costs(f"{algo}/device", 1)
    assert abs(mine / theirs - 1.0) < 0.05, (mine, theirs)
    assert abs(mine / device - 1.0) < 0.05, (mine, device)


def test_sharded_rejection_trials_contract():
    pts = _mixture(n=900, d=4, k_true=10, seed=9)
    res = shs.SHARDED_SEEDERS["rejection"](pts, 12, np.random.default_rng(3),
                                           device="cpu", mesh=_mesh(4))
    assert res.indices.shape == (12,)
    assert res.num_candidates >= 12
    assert res.extras["per_center_trials"].shape == (12,)
    assert res.extras["trials_per_center"] >= 1.0


@pytest.mark.parametrize("d", MESHES)
def test_kmeans_parallel_cost_matches_cpu_loop(d):
    """`tests/test_kmeans_parallel.py`'s check of kmeans||/sharded: mean
    costs over paired seeds within 5% of the CPU loop."""
    pts = _mixture(n=1600, d=5, k_true=12, seed=9)
    k = 36
    cpu_costs, sh_costs = [], []
    for s in range(8):
        cpu = seeding.kmeans_parallel(pts, k, np.random.default_rng(s))
        sh = SEEDERS["kmeans||/sharded"](pts, k, np.random.default_rng(s),
                                         device="cpu", mesh=_mesh(d))
        cpu_costs.append(clustering_cost(pts, pts[cpu.indices]))
        sh_costs.append(clustering_cost(pts, pts[sh.indices]))
    ratio = np.mean(sh_costs) / np.mean(cpu_costs)
    assert abs(ratio - 1.0) < 0.05, (np.mean(cpu_costs), np.mean(sh_costs))


def test_kmeans_parallel_pool_recluster_is_the_jax_packages():
    """The sharded rounds' pool, reclustered from the same rng state, gives
    the JAX package's indices bit for bit; every round launches the
    pairwise sweep once a shard over one compacted prefix of picks."""
    pts = _mixture(n=1500, d=5, k_true=12, seed=3)
    data = shs.shard_arrays(_mesh(4), 64, len(pts), points=torch.as_tensor(
        pts, dtype=torch.float32))
    sel = shs.sharded_kmeans_parallel_rounds(
        data, 2.0 * 20, torch.Generator().manual_seed(5), rounds=5,
        cap_loc=int(min(data.n_loc, 80)))
    assert not sel[len(pts):].any()              # padding is never picked
    cand = np.flatnonzero(sel[: len(pts)].numpy())
    assert len(cand) >= 20
    mine, my_pool = seeding._candidate_pool_to_centers(
        pts, cand, 20, np.random.default_rng(11))
    theirs, their_pool = jseeding._candidate_pool_to_centers(
        pts, cand, 20, np.random.default_rng(11))
    np.testing.assert_array_equal(mine, theirs)
    assert my_pool == their_pool


def test_kmeans_parallel_compacts_every_shards_picks():
    """Each round's slots hold every shard's picks as one prefix: the
    distances after the rounds equal a direct recomputation against the
    selected points (the picks a shard dropped past its cap lower
    nothing)."""
    pts = _mixture(n=900, d=3, k_true=6, seed=8)
    data = shs.shard_arrays(_mesh(4), 32, len(pts), points=torch.as_tensor(
        pts, dtype=torch.float32))
    sel = shs.sharded_kmeans_parallel_rounds(
        data, 30.0, torch.Generator().manual_seed(2), rounds=1,
        cap_loc=16)
    picked = np.flatnonzero(sel.numpy())
    per_shard = np.bincount(picked // data.n_loc, minlength=4)
    assert per_shard.max() <= 16 + 1           # cap_loc, plus the first
    assert per_shard.sum() > 16                # more than one shard picked


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("seeder", ["fastkmeans++", "rejection", "kmeans||"])
def test_shim_and_plan_identical_indices(seeder, d):
    """`tests/test_plan.py`'s sharded pairs: the legacy facade and the plan
    open the same indices on the same seed."""
    pts = _mixture(n=600, d=4, k_true=10, seed=3)
    old = _legacy_fit(pts, k=6, seeder=seeder, backend="sharded", seed=7,
                      device="cpu", seeder_kwargs={"mesh": _mesh(d)})
    new = _plan(seeder, d, k=6, seed=7).fit(pts)
    assert new.extras["devices"] == d
    np.testing.assert_array_equal(new.indices.numpy().astype(np.int64),
                                  old.seeding.indices)
    np.testing.assert_allclose(float(new.cost), old.cost, rtol=1e-5)
    spec, exe = KMeansConfig(k=6, seeder=seeder, backend="sharded",
                             device="cpu",
                             seeder_kwargs={"mesh": _mesh(d)}).to_specs()
    assert exe.mesh == _mesh(d) and "mesh" not in spec.options_dict()


@pytest.mark.parametrize("seeder", ["fastkmeans++", "rejection"])
def test_one_shard_opens_the_device_backends_indices(seeder):
    """On a one-shard mesh the sharded loop draws what the device backend
    draws, in its order: the same indices (and trials) bit for bit."""
    pts = _mixture(n=900, d=4, k_true=8, seed=2)
    sharded = _plan(seeder, 1, k=12, seed=5).fit(pts)
    device = ClusterPlan(ClusterSpec(k=12, seeder=seeder, seed=5),
                         ExecutionSpec(device="cpu")).fit(pts)
    assert torch.equal(sharded.indices, device.indices)
    assert torch.equal(sharded.cost, device.cost)
    if seeder == "rejection":
        assert torch.equal(sharded.extras["trials"], device.extras["trials"])
        assert sharded.extras["rounds_per_batch"] == \
            device.extras["rounds_per_batch"]


@pytest.mark.parametrize("seeder", ["fastkmeans++", "rejection", "kmeans||"])
def test_sharded_refit_prepares_nothing_and_fit_batch_is_the_refits(seeder):
    pts = _mixture(n=600, d=4, k_true=10, seed=6)
    plan = _plan(seeder, 4, k=5, seed=1)
    plan.fit(pts)
    with no_retrace():
        r9 = plan.refit(seed=9)
        b = plan.fit_batch([4, 9])
    assert plan.cache_info()["prepare_builds"] == 1
    assert b.indices.shape == (2, 5) and b.extras["vmapped"] is False
    assert torch.equal(b.indices[1], r9.indices)
    assert torch.equal(b.indices[0], plan.refit(seed=4).indices)
    assert torch.equal(b.cost[1], r9.cost)


def test_mesh_resolves_and_checks_its_devices(monkeypatch):
    plan = ClusterPlan(ClusterSpec(k=3), ExecutionSpec(backend="sharded",
                                                       device="cpu"))
    assert plan.execution.mesh == make_seeding_mesh(device="cpu")
    assert plan.execution.mesh.size == 1
    assert ClusterPlan(ClusterSpec(k=3), ExecutionSpec(
        device="cpu")).execution.mesh is None
    mesh = _mesh(4)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == 4
    assert hash(mesh) == hash(_mesh(4))
    assert SeedingMesh(("cuda",) * 2).devices == (torch.device("cuda", 0),) * 2
    with pytest.raises(ValueError, match="shards"):
        ClusterPlan(ClusterSpec(k=3), ExecutionSpec(
            backend="sharded", device="cpu",
            mesh=SeedingMesh(("cuda:0",) * 2)))
    with pytest.raises(ValueError):
        SeedingMesh(())
    with pytest.raises(ValueError):
        SeedingMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError):
        make_seeding_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_seeding_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterPlan(ClusterSpec(k=3), ExecutionSpec(backend="sharded"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _legacy_fit(_mixture(n=100), k=3, backend="sharded")


def test_mesh_on_cards_spreads_shards(monkeypatch):
    """Without a card present: the rule that places shard i on card
    i mod count, and an index that pins every shard to one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_seeding_mesh().devices == (torch.device("cuda", 0),
                                           torch.device("cuda", 1))
    assert [d.index for d in make_seeding_mesh(5).devices] == [0, 1, 0, 1, 0]
    assert make_seeding_mesh(3, device="cuda:1").devices == \
        (torch.device("cuda", 1),) * 3


# -- the conformance law at D = 4 ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _static_draws() -> np.ndarray:
    """`tests/test_conformance.py:_draws("sharded")` on the port: R seeded
    fits of k = 2 on the fixture, tile 32, four CPU shards (the fourth
    holds only padding)."""
    pts = conf._fixture()
    out = np.empty((conf.R, 2), dtype=np.int64)
    with no_retrace():
        for s in range(conf.R):
            res = SEEDERS["rejection/sharded"](
                pts, 2, np.random.default_rng(10_000 + s), **conf.SEEDER_KW,
                tile=32, device="cpu", mesh=_mesh(4))
            out[s] = res.indices
    return out


@functools.lru_cache(maxsize=None)
def _stream_draws() -> np.ndarray:
    """`tests/test_conformance.py:_stream_draws("sharded")` on the port."""
    pts = conf._fixture()
    kw = conf.SEEDER_KW
    plan = ClusterPlan(
        ClusterSpec(k=2, seeder="rejection", c=kw["c"], quantize=False,
                    seed=0, options={"lsh_r": kw["lsh_r"],
                                     "resolution": kw["resolution"]}),
        ExecutionSpec(backend="sharded", device="cpu", tile=32,
                      mesh=_mesh(4)))
    prep = plan.prepare_streaming(pts[:64])
    plan.extend(pts[64:], prepared=prep)
    dup = pts[np.random.default_rng(777).integers(0, conf.N, size=1024)]
    plan.extend(dup, prepared=prep)
    plan.retire(np.arange(conf.N, conf.N + 1024), prepared=prep)
    assert prep.streaming.live_count == conf.N
    np.testing.assert_array_equal(prep.streaming.live_ids(),
                                  np.arange(conf.N))
    out = np.empty((conf.R, 2), dtype=np.int64)
    out[0] = plan.fit_prepared(prep, seed=10_000).indices.numpy()
    with no_retrace():
        for s in range(1, conf.R):
            res = plan.fit_prepared(prep, seed=10_000 + s)
            assert res.extras["resharded"] is True
            out[s] = res.indices.numpy()
    assert (out >= 0).all() and (out < conf.N).all()
    return out


_DRAWS = {"static": _static_draws, "stream": _stream_draws}


@pytest.mark.parametrize("kind", sorted(_DRAWS))
def test_first_center_uniform(kind):
    uniform, _ = conf._exact_laws(conf._fixture())
    assignment = conf._mass_balanced_bins(uniform, conf.BINS)
    counts = conf._binned(np.bincount(_DRAWS[kind]()[:, 0],
                                      minlength=conf.N).astype(float),
                          assignment, conf.BINS)
    expected = conf._binned(uniform, assignment, conf.BINS) * conf.R
    stat = conf._chi2_stat(counts, expected)
    crit = conf._chi2_isf(conf.ALPHA / conf.N_TESTS, conf.BINS - 1)
    assert stat < crit, (kind, stat, crit)


@pytest.mark.parametrize("kind", sorted(_DRAWS))
def test_second_center_exact_d2(kind):
    _, marg2 = conf._exact_laws(conf._fixture())
    assignment = conf._mass_balanced_bins(marg2, conf.BINS)
    counts = conf._binned(np.bincount(_DRAWS[kind]()[:, 1],
                                      minlength=conf.N).astype(float),
                          assignment, conf.BINS)
    expected = conf._binned(marg2, assignment, conf.BINS) * conf.R
    assert expected.min() > 20.0
    stat = conf._chi2_stat(counts, expected)
    crit = conf._chi2_isf(conf.ALPHA / conf.N_TESTS, conf.BINS - 1)
    assert stat < crit, (kind, stat, crit)
    tv = 0.5 * np.abs(counts / conf.R - expected / conf.R).sum()
    assert tv < conf.TV_BOUND, (kind, tv)


# -- the streaming fallback ---------------------------------------------------

_STREAM_OPTIONS = {"lsh_r": 1e6, "resolution": 0.05}


def _stream_plan(seeder="rejection", k=2, d=4):
    """`tests/test_streaming.py`'s plan on the sharded backend, tile 32."""
    return ClusterPlan(
        ClusterSpec(k=k, seeder=seeder, c=1.2, quantize=False, seed=0,
                    options=_STREAM_OPTIONS),
        ExecutionSpec(backend="sharded", device="cpu", tile=32,
                      mesh=_mesh(d)))


def _points(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 3)) * 3.0


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_streaming_fallback_reshards_on_the_next_solve(seeder, caplog):
    plan = _stream_plan(seeder, k=5)
    prep = plan.prepare_streaming(_points(0, 200))
    state = prep.streaming
    assert (state.backend, state.dirty) == ("sharded", False)
    assert isinstance(state.artifacts, shs.ShardedData)
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.streaming"):
        plan.extend(_points(1, 60), prepared=prep)
        plan.extend(_points(2, 40), prepared=prep)
        plan.retire(np.arange(10, 70), prepared=prep)
    warned = [r for r in caplog.records
              if "no native streaming" in r.getMessage()]
    assert len(warned) == 1 and "extend" in warned[0].getMessage()
    assert state.dirty and state.n_rows == 300 and state.live_count == 240
    res = plan.fit_prepared(prep, seed=3)
    assert res.extras["resharded"] is True and not state.dirty
    assert res.extras["generation"] == state.generation == 3
    assert res.extras["devices"] == 4
    idx = res.indices.numpy()
    assert np.isin(idx, state.live_ids()).all() and len(set(idx)) == 5
    np.testing.assert_array_equal(state.live_snapshot, state.live_ids())
    again = plan.fit_prepared(prep, seed=3)
    assert torch.equal(again.indices, res.indices)
    live = state.live_points()
    d2 = ((live[:, None] - state.host_pts[idx][None]) ** 2).sum(-1)
    assert float(res.cost) == pytest.approx(d2.min(axis=1).sum(), rel=1e-5)
    ops = SEEDER_SPECS[seeder].impl("sharded").streaming
    assert ops.native is False


def test_streaming_reshard_rng_is_the_jax_packages():
    """The re-shard draws from ``default_rng((reseed_root, generation))``:
    after the same history the port's artifacts equal the JAX package's
    sharded stream's on every real row."""
    pts_a, pts_b = _points(5, 120), _points(6, 30)
    plan = _stream_plan()
    jplan = JaxClusterPlan(
        JaxClusterSpec(k=2, seeder="rejection", c=1.2, quantize=False,
                       seed=0, options=_STREAM_OPTIONS),
        JaxExecutionSpec(backend="sharded", tile=128))
    preps = [p.prepare_streaming(pts_a) for p in (plan, jplan)]
    for p, prep in zip((plan, jplan), preps):
        p.extend(pts_b, prepared=prep)
        p.retire(np.arange(3, 40), prepared=prep)
        p.fit_prepared(prep, seed=1)
    mine, theirs = (p.streaming for p in preps)
    assert mine.reseed_root == theirs.reseed_root
    assert mine.generation == theirs.generation == 2
    np.testing.assert_array_equal(mine.live_snapshot, theirs.live_snapshot)
    n = len(mine.live_snapshot)
    jdata, jn = theirs.artifacts
    assert jn == n == mine.artifacts.n_real
    for name in ("codes_lo", "keys_hi", "points"):
        axis = shs._POINTS_AXIS[name]
        whole = torch.cat(getattr(mine.artifacts, name), dim=axis).numpy()
        np.testing.assert_array_equal(
            np.take(whole, range(n), axis=axis),
            np.take(np.asarray(getattr(jdata, name)), range(n), axis=axis))


@settings(max_examples=5, deadline=None)
@given(st.integers(8, 32), st.integers(1, 12), st.integers(0, 10_000))
def test_extend_duplicates_matches_scratch(n_a, n_b, seed):
    """`tests/test_streaming.py`'s scratch equivalence on the sharded
    fallback: the same frozen host geometry; the re-shard after the extend
    draws its artifacts from a generation-keyed rng, so only the law (not
    the draws) matches a scratch prepare, and both draws are live."""
    pts_a = _points(seed, n_a)
    pts_b = pts_a[np.random.default_rng(seed + 1).integers(0, n_a, size=n_b)]
    plan = _stream_plan()
    inc = plan.prepare_streaming(pts_a)
    plan.extend(pts_b, prepared=inc)
    scratch = plan.prepare_streaming(np.concatenate([pts_a, pts_b]))
    si, ss = inc.streaming, scratch.streaming
    assert si.n_rows == ss.n_rows == n_a + n_b
    assert (si.scale, si.capacity, si.reseed_root) == \
        (ss.scale, ss.capacity, ss.reseed_root)
    np.testing.assert_array_equal(si.live, ss.live)
    np.testing.assert_array_equal(si.host_scaled, ss.host_scaled)
    ri = plan.fit_prepared(inc, seed=seed + 7)
    rs = plan.fit_prepared(scratch, seed=seed + 7)
    assert ri.extras["resharded"] is True
    live = si.live_ids()
    assert np.isin(ri.indices.numpy(), live).all()
    assert np.isin(rs.indices.numpy(), live).all()
    plan.forget(inc)
    plan.forget(scratch)


# -- resilience and the engine ------------------------------------------------

def test_fallback_chain_walks_the_sharded_rung():
    assert fallback_chain("rejection", "sharded") == \
        jax_fallback_chain("rejection", "sharded") == [
            ("rejection", "device"), ("rejection", "cpu"),
            ("kmeans||", "sharded"), ("kmeans||", "device"),
            ("kmeans||", "cpu"), ("kmeans++", "cpu")]


@pytest.mark.timeout(ENGINE_LIMIT)
def test_engine_sharded_fault_is_served_by_the_device_rung():
    pts = _mixture(n=300, d=4, k_true=6, seed=12)
    spec = ClusterSpec(k=4, seeder="rejection", seed=0)
    exe = ExecutionSpec(backend="sharded", device="cpu", mesh=_mesh(4))
    fp = FaultPlan(seed=0, solve_failure_rate=1.0, match="rejection/sharded")
    with ClusterEngine(spec, exe, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=2)) as engine:
        got = engine.submit(pts, seed=3).result(timeout=60)
        device_exe = engine._execution_for("device")
        sharded_exe = engine._execution_for("sharded")
        stats = engine.stats()
    assert got.extras["served_by"] == "rejection/device"
    assert got.extras["fallback_path"] == ("rejection/sharded",)
    assert stats["retries"] == 1 and stats["fallback_served"] == 1
    assert device_exe.mesh is None and device_exe.device == "cpu"
    assert sharded_exe is exe and sharded_exe.mesh == _mesh(4)
    direct = ClusterPlan(spec, device_exe)
    want = direct.fit_prepared(direct.prepare_data(pts), seed=3)
    assert torch.equal(got.indices, want.indices)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_engine_serves_the_sharded_plan():
    """With no fault the sharded primary serves, equal to a direct fit."""
    pts = _mixture(n=300, d=4, k_true=6, seed=13)
    spec = ClusterSpec(k=4, seeder="fastkmeans++", seed=0)
    exe = ExecutionSpec(backend="sharded", device="cpu", mesh=_mesh(2))
    with ClusterEngine(spec, exe) as engine:
        got = engine.submit(pts, seed=5).result(timeout=60)
    assert got.extras["served_by"] == "fastkmeans++/sharded"
    direct = ClusterPlan(spec, exe)
    want = direct.fit_prepared(direct.prepare_data(pts), seed=5)
    assert torch.equal(got.indices, want.indices)


def test_cluster_serve_takes_the_sharded_backend():
    from repro_torch.launch import cluster_serve

    args = cluster_serve.build_parser().parse_args(
        ["--backend", "sharded", "--shards", "4", "--device", "cpu"])
    assert (args.backend, args.shards) == ("sharded", 4)
    with pytest.raises(SystemExit):
        cluster_serve.build_parser().parse_args(["--backend", "tpu"])

