"""The port's `ClusterEngine` against the JAX package's, and the contracts
of `tests/test_engine.py` (and the engine's streaming plumbing of
`tests/test_streaming.py`) on the port, on the CPU.

  * pipelined results are bit-identical to the serial
    `plan.prepare_data(points)` + `plan.fit_prepared(...)` loop, on the
    device backend (the kernels' plain versions) and the cpu backend;
  * on the cpu backend the port's engine gives the JAX engine's indices
    for the same datasets and seeds;
  * `submit_lane` equals `fit_batch_prepared` over `prepare_stacked`
    handles, lane by lane; `submit_extend` mutates the stream once;
  * the close and cancel races, eviction under injected faults, the
    `as_completed` timeout, and a concurrent submit/close stress test.

Every test that starts a thread has its own time limit.
"""

import concurrent.futures as cf
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch.core import (
    ClusterEngine,
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    FaultPlan,
    InvalidInputError,
    RetryPolicy,
)

DEV = ExecutionSpec(backend="device", device="cpu")
CPU = ExecutionSpec(backend="cpu", device="cpu")
LIMIT = 120


def _mixture(n, d=4, k_true=8, seed=0):
    """The JAX suite's mixture (`tests/test_engine.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _same(a, b) -> None:
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.centers, b.centers)
    assert torch.equal(a.cost, b.cost)


@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("seeder,exe", [("fastkmeans++", DEV),
                                        ("rejection", DEV),
                                        ("kmeans||", DEV),
                                        ("rejection", CPU)],
                         ids=["fast-device", "rejection-device",
                              "kmeans-device", "rejection-cpu"])
def test_engine_pipelined_results_bit_identical_to_serial(seeder, exe):
    datasets = [_mixture(300 + 17 * i, seed=10 + i) for i in range(4)]
    spec = ClusterSpec(k=4, seeder=seeder, seed=2)
    with ClusterEngine(spec, exe, prepare_workers=2) as engine:
        tickets = [engine.submit(ds, seed=s) for ds in datasets
                   for s in (None, 5)]
        results = [t.result(timeout=60) for t in tickets]
        stats = engine.stats()
    assert stats["submitted"] == stats["completed"] == 8
    assert stats["prepare_seconds"] > 0 and stats["solve_seconds"] > 0
    serial = ClusterPlan(spec, exe)
    for i, ds in enumerate(datasets):
        prep = serial.prepare_data(ds)
        for j, s in enumerate((None, 5)):
            _same(results[2 * i + j], serial.fit_prepared(prep, seed=s))
            assert results[2 * i + j].extras["served_by"] == \
                f"{seeder}/{exe.backend}"


@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("seeder", ["kmeans++", "rejection", "afkmc2"])
def test_cpu_engine_gives_the_jax_engines_indices(seeder):
    datasets = [_mixture(200 + 31 * i, seed=40 + i) for i in range(3)]
    seeds = [None, 3, 9]
    spec = dict(k=5, seeder=seeder, seed=1)
    with ClusterEngine(ClusterSpec(**spec), CPU) as engine:
        mine = [engine.submit(ds, seed=s) for ds, s in zip(datasets, seeds)]
        mine = [t.result(timeout=60) for t in mine]
    with jcore.ClusterEngine(jcore.ClusterSpec(**spec),
                             jcore.ExecutionSpec(backend="cpu")) as engine:
        theirs = [engine.submit(ds, seed=s)
                  for ds, s in zip(datasets, seeds)]
        theirs = [t.result(timeout=60) for t in theirs]
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(m.indices.numpy(),
                                      np.asarray(t.indices))
        np.testing.assert_allclose(float(m.cost), float(t.cost), rtol=1e-5)
        assert m.extras["served_by"] == t.extras["served_by"]


@pytest.mark.timeout(LIMIT)
def test_engine_as_completed_tags_and_seeds():
    datasets = [_mixture(260, seed=i) for i in range(3)]
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    with ClusterEngine(spec, DEV) as engine:
        tickets = [engine.submit(ds, seed=7 + i, tag=f"req{i}")
                   for i, ds in enumerate(datasets)]
        done = list(engine.as_completed(tickets))
        assert sorted(t.tag for t in done) == ["req0", "req1", "req2"]
        assert all(t.done() for t in tickets)
    plan = ClusterPlan(spec, DEV)
    plan.prepare(datasets[1])
    assert torch.equal(tickets[1].result().indices,
                       plan.refit(seed=8).indices)


@pytest.mark.timeout(LIMIT)
def test_engine_forwards_failures_and_rejects_after_close():
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    engine = ClusterEngine(spec, DEV, validate_inputs=False)
    bad = engine.submit(np.zeros(7))
    assert bad.exception(timeout=60) is not None
    engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(_mixture(50))
    with ClusterEngine(spec, DEV) as checked:
        with pytest.raises(InvalidInputError, match="2-D"):
            checked.submit(np.zeros(7))
        assert checked.stats()["quarantined"] == 1
        assert checked.stats()["submitted"] == 0


@pytest.mark.timeout(LIMIT)
def test_engine_retain_prepared_false_evicts_after_solve():
    datasets = [_mixture(240, seed=90 + i) for i in range(3)]
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=1)
    with ClusterEngine(spec, DEV, retain_prepared=False) as engine:
        results = engine.map_fit(datasets)
        assert engine.plan_for().cache_info()["entries"] == 0
    serial = ClusterPlan(spec, DEV)
    _same(results[2], serial.fit(datasets[2]))
    prep = serial.prepare_data(datasets[0])
    assert serial.forget(prep) is True
    assert serial.forget(prep) is False
    assert serial.cache_info()["entries"] == 1


@pytest.mark.timeout(LIMIT)
def test_engine_exit_on_exception_cancels_backlog():
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    tickets = []
    with pytest.raises(RuntimeError, match="boom"):
        with ClusterEngine(spec, DEV) as engine:
            tickets = [engine.submit(_mixture(220, seed=i), tag=i)
                       for i in range(6)]
            raise RuntimeError("boom")
    outcomes = {"done": 0, "cancelled": 0}
    for t in tickets:
        exc = t.exception(timeout=60)
        if exc is None:
            outcomes["done"] += 1
        else:
            assert isinstance(exc, cf.CancelledError)
            outcomes["cancelled"] += 1
    assert outcomes["done"] + outcomes["cancelled"] == 6
    assert outcomes["cancelled"] >= 1
    stats = engine.stats()
    assert stats["cancelled"] + stats["completed"] + stats["failed"] == 6


@pytest.mark.timeout(LIMIT)
def test_engine_close_cancels_in_flight_prepare():
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    fp = FaultPlan(seed=0, prepare_latency_s=0.5)
    engine = ClusterEngine(spec, DEV, fault_plan=fp)
    tickets = [engine.submit(_mixture(200, seed=i)) for i in range(3)]
    engine.close(cancel_pending=True)
    for t in tickets:
        assert isinstance(t.exception(timeout=60), cf.CancelledError)
    stats = engine.stats()
    assert stats["cancelled"] == stats["submitted"] == 3


@pytest.mark.timeout(LIMIT)
def test_engine_concurrent_submit_close_race():
    """More submitting threads than cores, a short switch interval, and
    close(cancel_pending=True) landing among them: every returned ticket
    is terminal, every refused submit raised, and the books balance (a
    lost counter update would break them)."""
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    data = _mixture(200, seed=5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        engine = ClusterEngine(spec, DEV, prepare_workers=3)
        tickets, refused = [], []
        lock = threading.Lock()

        def hammer():
            for _ in range(8):
                try:
                    t = engine.submit(data)
                except RuntimeError:
                    with lock:
                        refused.append(1)
                else:
                    with lock:
                        tickets.append(t)

        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for th in threads:
            th.start()
        time.sleep(0.01)
        engine.close(cancel_pending=True)
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    for t in tickets:
        t.exception(timeout=60)
        assert t.done()
    stats = engine.stats()
    assert len(tickets) + len(refused) == 16 * 8
    assert stats["submitted"] == len(tickets)
    assert stats["cancelled"] + stats["completed"] + stats["failed"] \
        == stats["submitted"]
    assert stats["pending"] == 0


@pytest.mark.timeout(LIMIT)
def test_engine_as_completed_timeout_leaves_pipeline_consistent():
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    fp = FaultPlan(seed=0, solve_latency_s=0.4)
    with ClusterEngine(spec, DEV, fault_plan=fp) as engine:
        tickets = [engine.submit(_mixture(200, seed=40 + i))
                   for i in range(2)]
        with pytest.raises((TimeoutError, cf.TimeoutError)):
            list(engine.as_completed(tickets, timeout=0.05))
        results = [t.result(timeout=60) for t in tickets]
        assert all(r.k == 3 for r in results)
        stats = engine.stats()
    assert stats["completed"] == 2 and stats["failed"] == 0


@pytest.mark.timeout(LIMIT)
def test_engine_eviction_survives_injected_prepare_failures():
    spec = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
    fp = FaultPlan(seed=1, prepare_failure_rate=1.0, max_failures=1)
    with ClusterEngine(spec, DEV, retain_prepared=False, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=3)) as engine:
        res = engine.submit(_mixture(220, seed=7)).result(timeout=60)
        assert res.extras["attempts"] == 2
        engine.close()
        assert engine.plan_for().cache_info()["entries"] == 0
        stats = engine.stats()
    assert stats["completed"] == 1 and stats["retries"] == 1
    assert fp.stats()["injected"] == 1


@pytest.mark.timeout(LIMIT)
def test_engine_requires_a_spec_somewhere():
    with ClusterEngine(execution=DEV) as engine:
        with pytest.raises(ValueError, match="ClusterSpec"):
            engine.submit(_mixture(50))


def test_engine_defaults_to_the_card():
    """The engine's default placement is the plan's: the device backend on
    CUDA (a plan there raises without a card)."""
    engine = ClusterEngine(ClusterSpec(k=3))
    try:
        assert engine.execution == ExecutionSpec()
        assert engine.execution.device == "cuda"
    finally:
        engine.close()


@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_submit_lane_equals_fit_batch_prepared(seeder):
    datasets = [_mixture(300 + 11 * i, seed=30 + i) for i in range(3)]
    seeds = [None, 4, 6]
    spec = ClusterSpec(k=4, seeder=seeder, seed=3)
    with ClusterEngine(spec, DEV) as engine:
        lane = engine.submit_lane(datasets, seeds=seeds).result(timeout=60)
        with pytest.raises(ValueError, match="seeds"):
            engine.submit_lane(datasets, seeds=[1])
        with pytest.raises(ValueError, match=">= 1"):
            engine.submit_lane([])
    plan = ClusterPlan(spec, DEV)
    want = plan.fit_batch_prepared([plan.prepare_stacked(d)
                                    for d in datasets], seeds=[3, 4, 6])
    assert lane.extras["stacked"] and lane.extras["served_by"] == \
        f"{seeder}/device"
    _same(lane, want)


@pytest.mark.timeout(LIMIT)
def test_submit_lane_without_stacked_lanes_loops():
    datasets = [_mixture(150, seed=70 + i) for i in range(3)]
    spec = ClusterSpec(k=3, seeder="kmeans++", seed=1)
    with ClusterEngine(spec, CPU) as engine:
        lane = engine.submit_lane(datasets, seeds=[1, 2, 3]).result(
            timeout=60)
    assert lane.extras["stacked"] is False
    plan = ClusterPlan(spec, CPU)
    want = plan.fit_prepared(plan.prepare_data(datasets[1]), seed=2)
    assert torch.equal(lane.indices[1], want.indices)


def _stream_spec(seeder="rejection"):
    """The streaming suite's spec (`tests/test_streaming.py`)."""
    return ClusterSpec(k=2, seeder=seeder, c=1.2, quantize=False, seed=0,
                       options={"lsh_r": 1e6, "resolution": 0.05})


def _points(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 3)) * 3.0


@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("exe", [CPU, DEV], ids=["cpu", "device"])
def test_engine_submit_extend_refit_only_requires_handle(exe):
    eng = ClusterEngine(_stream_spec(), exe)
    try:
        with pytest.raises(ValueError):
            eng.submit_extend(None)
        plan = eng.plan_for()
        prep = plan.prepare_streaming(_points(0, 24))
        r1 = eng.submit_extend(_points(1, 8), prepared=prep).result(
            timeout=60)
        assert r1.extras["generation"] == 1
        r2 = eng.submit_extend(None, prepared=prep).result(timeout=60)
        assert r2.extras["generation"] == 1
        assert eng.stats()["extends"] == 1
        assert prep.streaming.n_rows == 32
    finally:
        eng.close()


@pytest.mark.timeout(LIMIT)
def test_submit_extend_retries_refit_without_reappending():
    """A transient fault on the refit retries the refit only: the batch is
    appended once, and the stream's faults are never degraded to another
    target."""
    fp = FaultPlan(seed=0, solve_failure_rate=1.0, max_failures_per_key=1)
    eng = ClusterEngine(_stream_spec(), DEV, fault_plan=fp,
                        retry=RetryPolicy(max_attempts=3))
    try:
        prep = eng.plan_for().prepare_streaming(_points(0, 24))
        res = eng.submit_extend(_points(1, 8), prepared=prep).result(
            timeout=60)
    finally:
        eng.close()
    assert res.extras["attempts"] == 2
    assert res.extras["served_by"] == "rejection/device"
    assert prep.streaming.n_rows == 32 and prep.streaming.generation == 1
