"""The port's plan, legacy facade, registry and tracing against the JAX
package's, on the CPU.

  * The legacy `fit` and `ClusterPlan.fit` open the same indices for the
    nine (seeder, backend) pairs of `tests/test_plan.py:PAIRS` that are
    not sharded, with ``device="cpu"`` (the sharded three are
    `tests/test_torch_sharded.py`'s).
  * The cpu backend's `ClusterPlan.fit` equals the JAX package's: indices
    exactly, cost to rtol 1e-5; so does `fit_batch(seeds)`.
  * `fit_batch(seeds)` lane i is bit-identical to `refit(seed=seeds[i])`
    on both backends, and on the device backend the device-native seeders
    run the lanes as one lane-batched solve (``vmapped`` True, with the
    JAX package's `extras`); for a seeder without stacked lanes
    (k-means||) `fit_batch(datasets=...)` is the solo loop (``stacked``
    False) and `prepare_stacked` raises.  The stacked lanes themselves are
    `tests/test_torch_stacked.py`'s.
  * `replace`, `forget`, `block_until_ready` (on tensors and on the NumPy
    arrays of `to_numpy`), the capability table cell by cell, `no_retrace`,
    and every name of `repro.core.__all__` exported by the port.
"""

import dataclasses
import inspect
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from repro.core import ClusterPlan as JaxClusterPlan
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import ExecutionSpec as JaxExecutionSpec
from repro_torch.core import (
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    KMeansConfig,
    RetraceError,
    TRACE_COUNTS,
    capability_table,
    fit,
    no_retrace,
    resolve_seeder,
)
from repro_torch.core import seeding
from repro_torch.core.tracing import count_trace
from repro_torch.launch.mesh import make_seeding_mesh

CPU_SEEDERS = ["kmeans++", "fastkmeans++", "rejection", "kmeans||", "afkmc2",
               "uniform"]
DEVICE_SEEDERS = ["fastkmeans++", "rejection", "kmeans||"]
PAIRS = ([(s, "cpu") for s in CPU_SEEDERS]
         + [(s, "device") for s in DEVICE_SEEDERS])

# The names of `repro.core.__all__` the port does not export yet, each with
# the ROADMAP Queue 1 item that ports it: none since item 7.
STILL_TO_COME: dict = {}


def _mixture(n=600, d=4, k_true=10, seed=0):
    """The JAX suite's mixture (`tests/test_plan.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _legacy_fit(pts, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fit(pts, KMeansConfig(**kw))


def _plan(backend="cpu", **spec):
    return ClusterPlan(ClusterSpec(**spec),
                       ExecutionSpec(backend=backend, device="cpu"))


# -- the legacy facade and the plan ----------------------------------------

@pytest.mark.parametrize("seeder,backend", PAIRS)
def test_shim_and_plan_identical_indices(seeder, backend):
    pts = _mixture(seed=3)
    old = _legacy_fit(pts, k=6, seeder=seeder, backend=backend, seed=7,
                      device="cpu")
    new = _plan(backend, k=6, seeder=seeder, seed=7).fit(pts)
    assert new.indices.device.type == "cpu"
    np.testing.assert_array_equal(new.indices.numpy().astype(np.int64),
                                  old.seeding.indices)
    np.testing.assert_allclose(float(new.cost), old.cost, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("seeder", CPU_SEEDERS)
def test_cpu_plan_matches_jax_package(seeder, seed):
    pts = _mixture(seed=5)
    res = _plan(k=8, seeder=seeder, seed=seed).fit(pts)
    jres = JaxClusterPlan(JaxClusterSpec(k=8, seeder=seeder, seed=seed),
                          JaxExecutionSpec(backend="cpu")).fit(pts)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=1e-5)
    assert res.extras["num_candidates"] == jres.extras["num_candidates"]


def test_shim_is_deprecated_but_works():
    pts = _mixture(n=200)
    with pytest.warns(DeprecationWarning, match="ClusterPlan"):
        km = fit(pts, KMeansConfig(k=4, seeder="kmeans++", backend="cpu"))
    assert km.centers.shape == (4, 4)


def test_legacy_config_defaults_to_the_card():
    cfg = KMeansConfig(k=3)
    assert (cfg.backend, cfg.device) == ("device", "cuda")
    spec, exe = cfg.to_specs()
    assert (exe.backend, exe.device) == ("device", "cuda")
    assert spec.k == 3 and spec.seeder == "rejection"
    assert inspect.signature(resolve_seeder).parameters[
        "backend"].default == "device"
    assert resolve_seeder("rejection") is seeding.SEEDERS["rejection/device"]
    assert resolve_seeder("rejection", "cpu") is seeding.rejection_sampling
    assert resolve_seeder("kmeans||/device", "cpu") \
        is seeding.SEEDERS["kmeans||/device"]
    with pytest.raises(KeyError):
        resolve_seeder("kmeans++", "sharded")


def test_lloyd_through_plan_matches_shim():
    pts = _mixture(seed=11)
    old = _legacy_fit(pts, k=5, seeder="rejection", backend="cpu",
                      lloyd_iters=3, seed=2)
    new = _plan(k=5, seeder="rejection", lloyd_iters=3, seed=2).fit(pts)
    assert new.extras["lloyd_iterations"] == old.refinement.iterations
    np.testing.assert_allclose(new.centers.numpy(), old.centers, rtol=1e-5,
                               atol=1e-4)


def test_predict_agrees_with_the_host_assignment():
    pts = _mixture(n=300, seed=4)
    km = _legacy_fit(pts, k=4, seeder="fastkmeans++", backend="device",
                     device="cpu")
    res = _plan("device", k=4, seeder="fastkmeans++").fit(pts)
    np.testing.assert_array_equal(km.centers, pts[res.indices.numpy()])
    pred = res.predict(pts).numpy()
    assert (pred == km.predict(pts)).mean() >= 0.99


# -- fit_batch --------------------------------------------------------------

@pytest.mark.parametrize("seeder,backend", [("kmeans++", "cpu"),
                                            ("rejection", "cpu"),
                                            ("rejection", "device"),
                                            ("fastkmeans++", "device"),
                                            ("kmeans||", "device")])
def test_fit_batch_lanes_equal_refits(seeder, backend):
    pts = _mixture(seed=8)
    plan = _plan(backend, k=4, seeder=seeder, seed=0)
    b = plan.fit_batch([1, 2, 3], pts)
    assert tuple(b.indices.shape) == (3, 4)
    assert tuple(b.centers.shape) == (3, 4, 4)
    assert tuple(b.cost.shape) == (3,)
    # The JAX package's extras: device-native seeders on the device backend
    # are one lane-batched solve, the rest a loop of refits.
    lanes = backend == "device" and seeder != "kmeans||"
    want = {"seeds": (1, 2, 3), "vmapped": lanes}
    if lanes and seeder == "rejection":
        assert tuple(b.extras["trials"].shape) == (3, 4)
        want["trials"] = b.extras["trials"]
    assert b.extras == want
    assert plan.cache_info()["prepare_builds"] == 1
    for i, s in enumerate([1, 2, 3]):
        lane = plan.refit(seed=s)
        assert torch.equal(b.indices[i], lane.indices)
        assert torch.equal(b.centers[i], lane.centers)
        assert torch.equal(b.cost[i], lane.cost)
        if "trials" in want:
            assert torch.equal(b.extras["trials"][i], lane.extras["trials"])
    host = b.to_numpy()
    assert host.indices.dtype == np.int64 and host.cost.shape == (3,)
    with pytest.raises(ValueError, match="single-problem"):
        b.predict(pts)


@pytest.mark.parametrize("seeder", ["kmeans++", "rejection", "afkmc2"])
def test_cpu_fit_batch_matches_jax_package(seeder):
    pts = _mixture(seed=8)
    b = _plan(k=4, seeder=seeder, seed=0).fit_batch([0, 1, 2], pts)
    jb = JaxClusterPlan(JaxClusterSpec(k=4, seeder=seeder, seed=0),
                        JaxExecutionSpec(backend="cpu")).fit_batch([0, 1, 2],
                                                                   pts)
    np.testing.assert_array_equal(b.indices.numpy(), np.asarray(jb.indices))
    np.testing.assert_allclose(b.cost.numpy(), np.asarray(jb.cost),
                               rtol=1e-5)


def test_fit_batch_over_datasets_is_the_solo_loop():
    # k-means|| has no stacked lanes (as in the JAX package), so its
    # datasets are prepared and fitted in turn.
    data = [_mixture(n=300, seed=s) for s in (1, 2)]
    plan = _plan("device", k=4, seeder="kmeans||", seed=0)
    b = plan.fit_batch([3, 4], datasets=data)
    assert b.extras["stacked"] is False and b.extras["seeds"] == (3, 4)
    for i, (pts, s) in enumerate(zip(data, (3, 4))):
        solo = plan.fit_prepared(plan.prepare_data(pts), seed=s)
        assert torch.equal(b.indices[i], solo.indices)
    assert plan.cache_info()["prepare_builds"] == 2
    with pytest.raises(ValueError, match="no stacked lanes"):
        plan.prepare_stacked(data[0])
    with pytest.raises(ValueError, match="not both"):
        plan.fit_batch(datasets=data, points=data[0])
    with pytest.raises(ValueError, match="2 datasets"):
        plan.fit_batch([1], datasets=data)
    with pytest.raises(ValueError, match="needs seeds"):
        plan.fit_batch()


# -- replace, forget, block_until_ready -------------------------------------

def test_specs_frozen_and_hashable():
    spec = ClusterSpec(k=3, options={"num_tables": 5})
    exe = ExecutionSpec(backend="device")
    cfg = KMeansConfig(k=3, seeder_kwargs={"m": 10})
    assert isinstance(spec.options, tuple)
    assert isinstance(cfg.seeder_kwargs, tuple)
    assert spec.replace(k=4) == ClusterSpec(k=4, options={"num_tables": 5})
    assert len({spec, spec.replace(k=4)}) == 2
    assert len({exe, ExecutionSpec(backend="cpu")}) == 2
    assert len({cfg, KMeansConfig(k=3)}) == 2
    for frozen in (spec, exe, cfg):
        with pytest.raises(dataclasses.FrozenInstanceError):
            frozen.k = 9


def test_forget_evicts_one_entry():
    a, b = _mixture(n=200, seed=1), _mixture(n=200, seed=2)
    plan = _plan(k=3, seeder="kmeans++")
    plan.fit(a)
    prep_a = plan._active
    prep_b = plan.prepare_data(b)
    assert plan.cache_info()["entries"] == 2
    assert plan.forget(prep_a) is True
    assert plan._active is None and plan.cache_info()["entries"] == 1
    assert plan.forget(prep_a) is False
    with pytest.raises(RuntimeError, match="refit"):
        plan.refit()
    assert plan.fit_prepared(prep_b).indices.shape == (3,)   # still valid


def test_block_until_ready_returns_self():
    res = _plan(k=3, seeder="uniform").fit(_mixture(n=100))
    assert res.block_until_ready() is res


def test_block_until_ready_on_numpy_arrays():
    """The JAX package's returns the result for host arrays too."""
    res = _plan(k=5, seeder="kmeans++").fit(_mixture(n=200)).to_numpy()
    assert isinstance(res.indices, np.ndarray)
    assert res.block_until_ready() is res


def test_cpu_refit_with_new_k_reuses_the_quantisation():
    plan = _plan(k=4, seeder="rejection", seed=0)
    plan.fit(_mixture(seed=9))
    prep = plan._active
    assert prep.artifacts is None and prep.resolution == 1.0
    assert plan.refit(k=6).indices.shape == (6,)
    assert plan.cache_info()["prepare_builds"] == 1


def test_plan_rejects_bad_pairs():
    with pytest.raises(KeyError):
        _plan("device", k=3, seeder="kmeans++")
    with pytest.raises(KeyError):
        _plan(k=3, seeder="nope")
    sharded = ClusterPlan(ClusterSpec(k=3), ExecutionSpec(backend="sharded",
                                                          device="cpu"))
    assert sharded.execution.mesh == make_seeding_mesh(device="cpu")
    with pytest.raises(ValueError):
        ExecutionSpec(backend="gpu-cluster")
    with pytest.raises(ValueError):
        ClusterSpec(k=0)
    with pytest.raises(TypeError):
        ClusterPlan(KMeansConfig(k=3))


# -- registry -----------------------------------------------------------------

def _table_cells(table: str) -> dict:
    """{seeder: [cell, ...]} of a capability table."""
    out = {}
    for line in table.replace("kmeans||", "kmeans-par").splitlines()[2:]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        out[cells[0]] = cells
    return out


def test_capability_table_matches_jax_package_cell_by_cell():
    table = capability_table()
    assert table.splitlines()[:2] == jcore.capability_table().splitlines()[:2]
    assert _table_cells(table) == _table_cells(jcore.capability_table())
    streaming = {name: cells[5] for name, cells in _table_cells(table).items()}
    fallback = "cpu, device, sharded (fallback)"
    assert streaming == {"`afkmc2`": "—", "`fastkmeans++`": fallback,
                         "`kmeans++`": "—", "`kmeans-par`": "—",
                         "`rejection`": fallback, "`uniform`": "—"}


def test_every_registered_seeder_has_cpu_impl_and_doc():
    for name, spec in core.SEEDER_SPECS.items():
        assert "cpu" in spec.impls, name
        assert spec.doc, name
        assert not spec.impls["cpu"].preparable
    assert core.BACKENDS == ("cpu", "device", "sharded") == jcore.BACKENDS
    for name in DEVICE_SEEDERS:
        for backend in ("device", "sharded"):
            impl = core.SEEDER_SPECS[name].impl(backend)
            assert impl.preparable
            assert seeding.SEEDERS[f"{name}/{backend}"] is impl.run


# -- tracing --------------------------------------------------------------------

def test_no_retrace_raises_on_a_counted_build():
    before = TRACE_COUNTS["build/test_source"]
    with no_retrace():
        pass
    with pytest.raises(RetraceError, match="build/test_source: \\+1") as err:
        with no_retrace():
            count_trace("build/test_source")
    assert err.value.deltas == {"build/test_source": 1}
    assert isinstance(err.value, AssertionError)
    with no_retrace(allow=("build/test",)):
        count_trace("build/test_source")
    with no_retrace(watch=("build/other",)):
        count_trace("build/test_source")
    assert TRACE_COUNTS["build/test_source"] == before + 3


def test_refits_on_the_cpu_count_nothing():
    plan = _plan("device", k=3, seeder="rejection")
    plan.fit(_mixture(n=200))
    with no_retrace():
        plan.refit(seed=1)
        plan.fit_batch([2, 3])


# -- the public names -----------------------------------------------------------

def test_core_all_is_the_jax_packages_minus_the_items_to_come():
    assert not STILL_TO_COME
    assert set(core.__all__) == set(jcore.__all__)
    assert len(core.__all__) == len(set(core.__all__))
    for name in jcore.__all__:
        assert hasattr(core, name), name
