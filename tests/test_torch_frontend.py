"""The port's `ClusterFrontend` against the JAX package's, and the contracts
of `tests/test_frontend.py` on the port, on the CPU.

  * every member of a coalesced lane equals its one-lane stacked fit bit
    for bit across three shape buckets (device backend, the kernels'
    plain versions), and the member's tensors stay on the plan's device;
  * on the cpu backend the port's frontend gives the JAX frontend's
    indices for the same datasets and seeds;
  * the deadline-at-risk flush, priority dispatch under a full hold
    queue, the ledger under a seeded `FaultPlan` and under
    ``close(cancel_pending=True)``, queue-wait percentiles by priority and
    tenant, and `submit_extend`'s ledger.

Every test that starts a thread has its own time limit.
"""

import time

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.serving.frontend import ClusterFrontend as JaxClusterFrontend
from repro_torch.core import (
    CircuitBreakerPolicy,
    ClusterEngine,
    ClusterPlan,
    ClusterSpec,
    ExecutionSpec,
    FaultPlan,
    InvalidInputError,
    QueueFullError,
    RetryPolicy,
)
from repro_torch.serving.frontend import ClusterFrontend

SPEC = ClusterSpec(k=4, seeder="fastkmeans++", seed=3)
DEV = ExecutionSpec(backend="device", device="cpu")
CPU = ExecutionSpec(backend="cpu", device="cpu")
DEV_DEVICE = torch.device("cpu")
LIMIT = 120


def _mixture(n, d=4, k_true=6, seed=0):
    """The JAX suite's mixture (`tests/test_frontend.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("seeder", ["fastkmeans++", "rejection"])
def test_coalesced_lanes_bit_identical_to_solo_fit(seeder):
    spec = SPEC.replace(seeder=seeder)
    sizes = (300, 420, 350, 600, 1500, 1600, 3000)
    datasets = [_mixture(n, seed=10 + i) for i, n in enumerate(sizes)]
    plan = ClusterPlan(spec, DEV)
    refs = [plan.fit_batch(datasets=[d]) for d in datasets]
    with ClusterFrontend(spec, DEV, max_batch=4,
                         max_wait_ms=10_000.0) as fe:
        tickets = [fe.submit(d) for d in datasets]
        t0 = time.monotonic()
        while fe.stats()["lanes"] < 1:
            assert time.monotonic() - t0 < 30, "full bucket never flushed"
            time.sleep(0.005)
        fe.flush()
        results = [t.result(timeout=60) for t in tickets]
        st = fe.stats()
    for ref, got in zip(refs, results):
        assert torch.equal(ref.indices[0], got.indices)
        assert torch.equal(ref.centers[0], got.centers)
        assert torch.equal(ref.cost[0], got.cost)
        assert got.indices.shape == (4,) and got.cost.dim() == 0
        assert got.indices.device == got.centers.device == DEV_DEVICE
        assert got.extras["bucket"] >= 1024
        assert got.extras["queue_wait"] >= 0.0
    assert st["completed"] == len(datasets)
    assert st["lanes"] < len(datasets)
    full = [r for r in results if r.extras["flush_reason"] == "full"]
    assert len(full) == 4 and all(r.extras["bucket"] == 1024 for r in full)
    assert st["coalesce_rate"] > 0 and st["mean_lane_occupancy"] > 1.0


@pytest.mark.timeout(LIMIT)
@pytest.mark.parametrize("seeder", ["kmeans++", "fastkmeans++"])
def test_cpu_frontend_gives_the_jax_frontends_indices(seeder):
    datasets = [_mixture(n, seed=60 + i)
                for i, n in enumerate((300, 330, 1500, 310))]
    seeds = [None, 7, 8, 9]
    kw = dict(max_batch=4, max_wait_ms=60_000.0)
    spec = dict(k=4, seeder=seeder, seed=3)
    with ClusterFrontend(ClusterSpec(**spec), CPU, **kw) as fe:
        mine = [fe.submit(d, seed=s) for d, s in zip(datasets, seeds)]
        fe.flush()
        mine = [t.result(timeout=60) for t in mine]
    with JaxClusterFrontend(jcore.ClusterSpec(**spec),
                            jcore.ExecutionSpec(backend="cpu"), **kw) as fe:
        theirs = [fe.submit(d, seed=s) for d, s in zip(datasets, seeds)]
        fe.flush()
        theirs = [t.result(timeout=60) for t in theirs]
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(m.indices.numpy(),
                                      np.asarray(t.indices))
        np.testing.assert_allclose(float(m.cost), float(t.cost), rtol=1e-5)
        for key in ("lane_size", "lane_index", "bucket", "flush_reason"):
            assert m.extras[key] == t.extras[key], key


@pytest.mark.timeout(LIMIT)
def test_deadline_at_risk_flushes_early():
    ds = _mixture(300, seed=1)
    with ClusterFrontend(SPEC, CPU, max_batch=8, max_wait_ms=60_000.0,
                         deadline_margin_ms=400.0) as fe:
        t0 = time.monotonic()
        res = fe.submit(ds, deadline=1.0).result(timeout=30)
        elapsed = time.monotonic() - t0
    assert res.extras["flush_reason"] == "deadline"
    assert elapsed < 5.0
    assert 0.2 <= res.extras["queue_wait"] <= 1.0


@pytest.mark.timeout(LIMIT)
def test_priority_dispatch_order_and_admission_control():
    sizes = (300, 1500, 3000, 6000)
    prios = (0, 5, 1, 9)
    datasets = [_mixture(n, seed=20 + i) for i, n in enumerate(sizes)]
    done = []
    with ClusterFrontend(SPEC, CPU, max_batch=8, max_wait_ms=60_000.0,
                         max_pending=4, backpressure="reject") as fe:
        tickets = []
        for ds, p in zip(datasets, prios):
            t = fe.submit(ds, priority=p, tag=p)
            t.add_done_callback(lambda tk: done.append(tk.tag))
            tickets.append(t)
        with pytest.raises(QueueFullError, match="reject"):
            fe.submit(_mixture(300, seed=99))
        with pytest.raises(InvalidInputError):
            fe.submit(np.full((64, 4), np.nan))
        fe.flush()
        for t in tickets:
            t.result(timeout=60)
        st = fe.stats()
    assert done == [9, 5, 1, 0], f"dispatch order was {done}"
    assert st["rejected"] == 1 and st["quarantined"] == 1
    assert st["submitted"] == st["completed"] == 4


@pytest.mark.timeout(LIMIT)
def test_ledger_conservation_under_chaos():
    fp = FaultPlan(seed=11, solve_failure_rate=0.15,
                   prepare_failure_rate=0.1, max_failures_per_key=1)
    b = 40
    datasets = [_mixture(260 + 7 * i, seed=i) for i in range(b)]
    engine = ClusterEngine(
        SPEC, CPU, validate_inputs=False, retain_prepared=False,
        fault_plan=fp, retry=RetryPolicy(max_attempts=6, backoff=0.0),
        breaker=CircuitBreakerPolicy(failure_threshold=1000))
    with engine:
        fe = ClusterFrontend(engine=engine, max_batch=4, max_wait_ms=5.0)
        with fe:
            tickets = [fe.submit(ds, deadline=None if i % 5 else 60.0)
                       for i, ds in enumerate(datasets)]
        assert all(t.done() for t in tickets), "a ticket was stranded"
        st = fe.stats()
    assert st["submitted"] == b
    assert st["completed"] + st["failed"] + st["cancelled"] \
        == st["submitted"]
    assert st["held"] == 0 and st["inflight"] == 0
    assert fp.stats()["injected"] > 0
    assert st["completed"] >= 0.8 * b


@pytest.mark.timeout(LIMIT)
def test_stats_queue_wait_percentiles_by_priority():
    sizes = (300, 1500, 3000)
    datasets = [_mixture(n, seed=40 + i) for i, n in enumerate(sizes)]
    with ClusterFrontend(SPEC, CPU, max_batch=8, max_wait_ms=50.0) as fe:
        tickets = [fe.submit(ds, priority=p, tenant="acme")
                   for ds, p in zip(datasets, (0, 0, 7))]
        fe.flush()
        for t in tickets:
            t.result(timeout=60)
        st = fe.stats()
    qw = st["queue_wait_by_priority"]
    assert sorted(qw) == [0, 7]
    assert qw[0]["count"] == 2 and qw[7]["count"] == 1
    for rec in qw.values():
        assert 0.0 <= rec["p50"] <= rec["p90"] <= rec["p99"] < 30.0
    acme = st["tenants"]["acme"]
    assert acme["submitted"] == acme["completed"] == 3
    assert acme["queue_wait"]["count"] == 3


@pytest.mark.timeout(LIMIT)
def test_cancel_pending_close_balances_ledger():
    fe = ClusterFrontend(SPEC, CPU, max_batch=64, max_wait_ms=60_000.0)
    tickets = [fe.submit(_mixture(300, seed=i)) for i in range(6)]
    fe.close(cancel_pending=True)
    assert all(t.done() for t in tickets)
    st = fe.stats()
    assert st["completed"] + st["failed"] + st["cancelled"] \
        == st["submitted"] == 6
    assert st["cancelled"] >= 1


@pytest.mark.timeout(LIMIT)
def test_frontend_submit_extend_settles_ledger():
    spec = ClusterSpec(k=2, seeder="rejection", c=1.2, quantize=False,
                       seed=0, options={"lsh_r": 1e6, "resolution": 0.05})
    fe = ClusterFrontend(spec, DEV)
    try:
        plan = fe.engine.plan_for()
        rng = np.random.default_rng(0)
        prep = plan.prepare_streaming(rng.normal(size=(24, 3)) * 3.0)
        res = fe.submit_extend(rng.normal(size=(8, 3)) * 3.0,
                               prepared=prep).result(timeout=60)
        assert res.extras["streaming"] is True
        fe.flush()
        stats = fe.stats()
        assert stats["extends"] == stats["completed"] == 1
        assert stats["inflight"] == 0
    finally:
        fe.close()
