"""The port's resilience primitives against the JAX package's, and the
engine's fault-tolerance contracts of `tests/test_resilience.py` on the
port, on the CPU.

  * `FaultPlan` makes the same decisions (and raises the same messages)
    as `repro.core.FaultPlan` for the same (seed, stage, key, call)
    sequence; `RetryPolicy.delay`, `attempt_seed`, the circuit breaker's
    state machine on a fake clock, `validate_points` and the wire codes
    equal the JAX package's; `fallback_chain` equals the JAX package's for
    every registered (seeder, backend) pair, the ``sharded`` rung
    included;
  * `classify_failure` gives the JAX package's answer on every case of the
    JAX suite that is not an XLA error, plus the port's own: a CUDA
    out-of-memory and ``cudaError_t 2`` transient, 700 and 719 permanent;
  * the engine under faults: backpressure, quarantine, deadlines, retries
    on fresh streams, the breaker's open/short-circuit/probe/re-close,
    a fallback equal to a direct fit on its target, the chaos run's typed
    terminal states and a close that strands nothing.

Every test that starts a thread has its own time limit.
"""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import resilience as jres
from repro_torch.core import (
    CircuitBreaker,
    CircuitBreakerPolicy,
    ClusterEngine,
    ClusterPlan,
    ClusterSpec,
    DeadlineExceededError,
    ExecutionSpec,
    FaultPlan,
    InjectedFault,
    InvalidInputError,
    QueueFullError,
    RemoteError,
    RetryPolicy,
    SEEDER_SPECS,
    attempt_seed,
    classify_failure,
    data_fingerprint,
    exception_from_wire,
    exception_to_wire,
    fallback_chain,
    validate_points,
)
from repro_torch.core import plan as plan_module
from repro_torch.core import resilience as res
from repro_torch.core.registry import BACKENDS
from repro_torch.kernels._check import CudaLaunchError, raise_on_error

SPEC = ClusterSpec(k=3, seeder="fastkmeans++", seed=0)
CPU = ExecutionSpec(backend="cpu", device="cpu")
PRIMARY = "fastkmeans++/cpu"
ENGINE_LIMIT = 120


def _mixture(n, d=4, k_true=6, seed=0):
    """The JAX suite's mixture (`tests/test_resilience.py`)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 25
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


def _wait_pending(engine, depth, deadline_s=10.0):
    """Poll until the undispatched queue reaches `depth` (solver races)."""
    t0 = time.monotonic()
    while engine.stats()["pending"] != depth:
        if time.monotonic() - t0 > deadline_s:
            raise AssertionError(
                f"queue never reached depth {depth}: {engine.stats()}")
        time.sleep(0.005)


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


# -- the primitives against the JAX package -----------------------------------

def _decisions(plan, calls):
    """The outcome of each inject call: None, or (transient, message)."""
    out = []
    for stage, key in calls:
        try:
            plan.inject(stage, key)
            out.append(None)
        except Exception as e:  # noqa: BLE001 — both packages' InjectedFault
            out.append((e.transient, e.stage, e.key, str(e)))
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=5, solve_failure_rate=0.25),
    dict(seed=7, prepare_failure_rate=0.4, solve_failure_rate=0.6,
         permanent_rate=0.3),
    dict(seed=3, solve_failure_rate=1.0, match="rejection/",
         max_failures_per_key=2),
    dict(seed=11, prepare_failure_rate=0.5, solve_failure_rate=0.5,
         max_failures=9),
])
def test_fault_plan_decisions_match_jax_package(kw):
    rng = np.random.default_rng(kw["seed"])
    keys = [f"{s}/{b}/solve/key{i}" for s in ("rejection", "kmeans||")
            for b in ("cpu", "device") for i in range(3)]
    calls = [(("prepare", "solve")[int(rng.integers(2))],
              keys[int(rng.integers(len(keys)))]) for _ in range(300)]
    mine, theirs = FaultPlan(**kw), jcore.FaultPlan(**kw)
    got = _decisions(mine, calls)
    assert got == _decisions(theirs, calls)
    assert any(d is not None for d in got) and None in got
    assert mine.stats() == theirs.stats()


def test_fault_plan_validation_matches_jax_package():
    for kw in (dict(solve_failure_rate=1.5), dict(permanent_rate=-0.1)):
        for cls in (FaultPlan, jcore.FaultPlan):
            with pytest.raises(ValueError, match="must be in"):
                cls(**kw)
    with pytest.raises(ValueError, match="stage"):
        FaultPlan(solve_failure_rate=1.0).inject("upload", "k")


@pytest.mark.parametrize("kw", [
    dict(), dict(max_attempts=4, backoff=0.1, multiplier=2.0),
    dict(backoff=0.1, jitter=0.5), dict(backoff=0.02, multiplier=3.0,
                                        jitter=0.01)])
def test_retry_policy_delay_matches_jax_package(kw):
    mine, theirs = RetryPolicy(**kw), jcore.RetryPolicy(**kw)
    for attempt in range(1, 6):
        for seed in (0, 7, 8, 12345):
            assert mine.delay(attempt, seed=seed) == \
                theirs.delay(attempt, seed=seed)
    for bad in (dict(max_attempts=0), dict(backoff=-1.0),
                dict(multiplier=0.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


def test_attempt_seed_matches_jax_package():
    for base in (None, 0, 1, 42, 2**31 - 1, 2**40 + 3):
        for attempt in range(6):
            assert attempt_seed(base, attempt) == \
                jcore.attempt_seed(base, attempt)
    assert attempt_seed(None, 0) is None and attempt_seed(42, 0) == 42
    derived = [attempt_seed(42, a) for a in range(1, 6)]
    assert len(set(derived)) == 5 and 42 not in derived


def test_circuit_breaker_state_machine_matches_jax_package():
    """The same operations on both breakers, on the same fake clock,
    through every transition: the same states and admissions."""
    ops = ["failure", "failure", "allow", "tick29", "allow", "tick2",
           "allow", "failure", "allow", "tick31", "allow", "success",
           "allow", "failure", "success", "failure", "failure", "allow"]
    pol = dict(failure_threshold=2, cooldown_s=30.0)
    trail = []
    for brk, pol_cls in ((CircuitBreaker, CircuitBreakerPolicy),
                         (jcore.CircuitBreaker, jcore.CircuitBreakerPolicy)):
        clock = _FakeClock()
        br = brk(pol_cls(**pol), clock=clock)
        seen = [br.state]
        for op in ops:
            if op == "failure":
                br.record_failure()
            elif op == "success":
                br.record_success()
            elif op == "allow":
                seen.append(br.allow())
            else:
                clock.advance(float(op[4:]))
            seen.append(br.state)
        trail.append(seen)
    assert trail[0] == trail[1]
    assert {"OK", "OPEN", "DEGRADED"} <= set(trail[0])
    with pytest.raises(ValueError, match="failure_threshold"):
        CircuitBreakerPolicy(failure_threshold=0)
    with pytest.raises(ValueError, match="cooldown_s"):
        CircuitBreakerPolicy(cooldown_s=-1.0)


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    (_mixture(64), 3), (np.zeros(7), None), (np.zeros((0, 4)), None),
    (np.zeros((4, 0)), None), (np.array([["a", "b"]]), None),
    (np.array([[1.0, np.nan]]), None), (np.array([[1.0, np.inf]]), None),
    (_mixture(64)[:2], 3), (np.arange(12).reshape(6, 2), 4),
    (np.array([[1.0, np.nan], [np.inf, 2.0]], np.float32), None),
    ([[1.0, 2.0], [3.0, 4.0]], 2), ("not an array", None)],
    ids=["good", "rank", "empty", "no-features", "strings", "nan", "inf",
         "degenerate", "ints", "f32", "list", "str"])
def test_validate_points_matches_jax_package(case):
    points, k = case
    got = _outcome(validate_points, points, k=k)
    assert got == _outcome(jcore.validate_points, points, k=k)
    if got is not None:
        assert got[0] == "InvalidInputError"


def test_wire_codes_match_jax_package():
    names = [n for n in dir(jres) if n.startswith("WIRE_")]
    assert len(names) == 8
    for name in names:
        assert getattr(res, name) == getattr(jres, name), name
    mine = {code: t.__name__ for code, t in res._WIRE_BY_CODE.items()}
    theirs = {code: t.__name__ for code, t in jres._WIRE_BY_CODE.items()}
    # Codes 6 and 8 are bound where their errors live (each package's
    # serving.net), so compare the codes both have bound at this point.
    shared = set(mine) & set(theirs)
    assert {1, 2, 3, 4, 5} <= shared
    assert {c: mine[c] for c in shared} == {c: theirs[c] for c in shared}
    for exc in (InvalidInputError("x"), QueueFullError("q"),
                DeadlineExceededError("late"), KeyError("k"),
                RuntimeError("boom")):
        code, msg = exception_to_wire(exc)
        jexc = getattr(jcore, type(exc).__name__, type(exc))(*exc.args)
        assert (code, msg) == jcore.exception_to_wire(jexc)
        back = exception_from_wire(code, msg)
        assert type(back).__name__ == type(
            jcore.exception_from_wire(code, msg)).__name__
    unknown = exception_from_wire(99, "from the future")
    assert isinstance(unknown, RemoteError) and unknown.code == 99
    with pytest.raises(ValueError, match="already bound"):
        res.register_wire_error(res.WIRE_INVALID_INPUT, QueueFullError)


def test_fallback_chain_matches_jax_package_on_every_registered_pair():
    pairs = [(s, b) for s, spec in SEEDER_SPECS.items() for b in BACKENDS
             if b in spec.impls]
    assert len(pairs) == 12
    for seeder, backend in pairs:
        chain = fallback_chain(seeder, backend)
        assert chain == jcore.fallback_chain(seeder, backend)
        assert all(p[1] in BACKENDS for p in chain)
    assert fallback_chain("rejection", "device") == [
        ("rejection", "cpu"), ("kmeans||", "device"), ("kmeans||", "cpu"),
        ("kmeans++", "cpu")]
    assert fallback_chain("kmeans++", "cpu") == []
    with pytest.raises(KeyError, match="backend"):
        fallback_chain("rejection", "gpu-cluster")


class XlaRuntimeError(Exception):      # shaped like jaxlib's
    pass


@pytest.mark.parametrize("make", [
    lambda m: m.InjectedFault("x", transient=True),
    lambda m: m.InjectedFault("x", transient=False),
    lambda m: ValueError("bad"), lambda m: m.InvalidInputError("bad"),
    lambda m: MemoryError(), lambda m: ConnectionResetError(),
    lambda m: TimeoutError(), lambda m: m.DeadlineExceededError("late"),
    lambda m: KeyError("k"), lambda m: RuntimeError("mystery"),
    lambda m: m.QueueFullError("full")])
def test_classify_failure_matches_jax_package(make):
    assert classify_failure(make(res)) == jcore.classify_failure(make(jres))


def test_classify_failure_port_cuda_cases():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert isinstance(oom, RuntimeError)
    assert classify_failure(oom) == "transient"
    for err, want in ((2, "transient"), (700, "permanent"),
                      (719, "permanent"), (1, "permanent")):
        exc = CudaLaunchError("tree_sep_update", err)
        assert isinstance(exc, RuntimeError) and exc.code == err
        assert classify_failure(exc) == want, err
        assert classify_failure(pickle.loads(pickle.dumps(exc))) == want
    # The binding's type carries the code, not its message's wording.
    assert classify_failure(RuntimeError(
        "tree_sep_update: CUDA launch failed with cudaError_t 2")) \
        == "permanent"
    with pytest.raises(CudaLaunchError) as info:
        raise_on_error("pairwise_argmin", 2)
    assert info.value.code == 2 and info.value.kernel == "pairwise_argmin"
    # The XLA errors the JAX package keys on never arise in the port: an
    # unknown exception type stays permanent.
    assert classify_failure(XlaRuntimeError(
        "RESOURCE_EXHAUSTED: out of memory")) == "permanent"
    assert jcore.classify_failure(XlaRuntimeError(
        "RESOURCE_EXHAUSTED: out of memory")) == "transient"


# -- the engine under faults (the contracts of tests/test_resilience.py) ------

@pytest.mark.timeout(ENGINE_LIMIT)
def test_backpressure_reject_raises_typed_error():
    fp = FaultPlan(seed=0, solve_latency_s=0.5)
    with ClusterEngine(SPEC, CPU, fault_plan=fp, max_pending=1,
                       backpressure="reject") as engine:
        first = engine.submit(_mixture(96, seed=1))
        _wait_pending(engine, 0)
        queued = engine.submit(_mixture(96, seed=2))
        with pytest.raises(QueueFullError, match="reject"):
            engine.submit(_mixture(96, seed=3))
        assert engine.stats()["rejected"] == 1
        assert first.result(timeout=60).k == 3
        assert queued.result(timeout=60).k == 3
        stats = engine.stats()
    assert stats["submitted"] == stats["completed"] == 2


@pytest.mark.timeout(ENGINE_LIMIT)
def test_backpressure_shed_oldest_fails_the_oldest_ticket():
    fp = FaultPlan(seed=0, solve_latency_s=0.5)
    with ClusterEngine(SPEC, CPU, fault_plan=fp, max_pending=1,
                       backpressure="shed-oldest") as engine:
        first = engine.submit(_mixture(96, seed=1))
        _wait_pending(engine, 0)
        victim = engine.submit(_mixture(96, seed=2))
        newest = engine.submit(_mixture(96, seed=3))
        assert isinstance(victim.exception(timeout=60), QueueFullError)
        assert first.result(timeout=60).k == 3
        assert newest.result(timeout=60).k == 3
        stats = engine.stats()
    assert stats["shed"] == 1 and stats["cancelled"] == 1
    assert stats["cancelled"] + stats["completed"] + stats["failed"] \
        == stats["submitted"] == 3


@pytest.mark.timeout(ENGINE_LIMIT)
def test_backpressure_block_waits_for_capacity():
    fp = FaultPlan(seed=0, solve_latency_s=0.4)
    with ClusterEngine(SPEC, CPU, fault_plan=fp, max_pending=1,
                       backpressure="block") as engine:
        engine.submit(_mixture(96, seed=1))
        _wait_pending(engine, 0)
        engine.submit(_mixture(96, seed=2))
        tickets = []
        th = threading.Thread(
            target=lambda: tickets.append(engine.submit(_mixture(96,
                                                                 seed=3))))
        th.start()
        time.sleep(0.05)
        assert th.is_alive(), "third submit should be blocked on capacity"
        th.join(timeout=60)
        assert not th.is_alive() and len(tickets) == 1
        assert tickets[0].result(timeout=60).k == 3
        stats = engine.stats()
    assert stats["submitted"] == stats["completed"] == 3


@pytest.mark.timeout(ENGINE_LIMIT)
def test_quarantine_rejects_before_any_worker():
    with ClusterEngine(SPEC, CPU) as engine:
        with pytest.raises(InvalidInputError, match="non-finite"):
            engine.submit(np.full((16, 3), np.nan))
        with pytest.raises(InvalidInputError, match="degenerate"):
            engine.submit(_mixture(2))
        stats = engine.stats()
    assert stats["quarantined"] == 2 and stats["submitted"] == 0


@pytest.mark.timeout(ENGINE_LIMIT)
def test_deadline_expires_in_queue_and_on_the_solve():
    fp = FaultPlan(seed=0, solve_latency_s=0.5)
    with ClusterEngine(SPEC, CPU, fault_plan=fp) as engine:
        blocker = engine.submit(_mixture(96, seed=1))
        queued = engine.submit(_mixture(96, seed=2), deadline=0.15)
        assert isinstance(queued.exception(timeout=60),
                          DeadlineExceededError)
        assert blocker.result(timeout=60).k == 3
        late = engine.submit(_mixture(96, seed=3), deadline=0.2)
        assert isinstance(late.exception(timeout=60), DeadlineExceededError)
        assert engine.submit(_mixture(96, seed=4)).result(timeout=60).k == 3
        stats = engine.stats()
    assert stats["deadline_expired"] == 2
    assert stats["failed"] == 2 and stats["completed"] == 2
    with ClusterEngine(SPEC, CPU) as engine:
        with pytest.raises(ValueError, match="deadline"):
            engine.submit(_mixture(96), deadline=0.0)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_transient_failure_retries_on_fresh_stream():
    pts = _mixture(128, seed=5)
    fp = FaultPlan(seed=3, solve_failure_rate=1.0, match=PRIMARY,
                   max_failures_per_key=1)
    with ClusterEngine(SPEC, CPU, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=3)) as engine:
        got = engine.submit(pts, seed=4).result(timeout=60)
        stats = engine.stats()
    assert got.extras["served_by"] == PRIMARY
    assert got.extras["attempts"] == 2 and got.extras["fallback_path"] == ()
    assert stats["retries"] == 1 and stats["fallback_served"] == 0
    plan = ClusterPlan(SPEC, CPU)
    want = plan.fit_prepared(plan.prepare_data(pts), seed=attempt_seed(4, 1))
    assert torch.equal(got.indices, want.indices)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_permanent_failure_surfaces_without_retry_or_fallback():
    fp = FaultPlan(seed=3, solve_failure_rate=1.0, permanent_rate=1.0,
                   match=PRIMARY)
    with ClusterEngine(SPEC, CPU, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=3)) as engine:
        exc = engine.submit(_mixture(128, seed=5)).exception(timeout=60)
        assert isinstance(exc, InjectedFault) and not exc.transient
        stats = engine.stats()
    assert stats["retries"] == 0 and stats["fallback_served"] == 0
    assert stats["failed"] == 1


@pytest.mark.timeout(ENGINE_LIMIT)
def test_fallback_serves_bit_identical_to_direct_solo_fit():
    pts = _mixture(128, seed=9)
    fp = FaultPlan(seed=3, solve_failure_rate=1.0, match=PRIMARY)
    with ClusterEngine(SPEC, CPU, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=2)) as engine:
        got = engine.submit(pts).result(timeout=60)
        stats = engine.stats()
    assert got.extras["served_by"] == "kmeans++/cpu"
    assert got.extras["fallback_path"] == (PRIMARY,)
    assert stats["retries"] == 1 and stats["fallback_served"] == 1
    direct = ClusterPlan(SPEC.replace(seeder="kmeans++"), CPU).fit(pts)
    assert torch.equal(got.indices, direct.indices)
    assert torch.equal(got.centers, direct.centers)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_device_fallback_keeps_the_device_and_equals_a_direct_fit():
    """rejection/device failing down the chain lands on kmeans||/device,
    on the primary's device, equal to a direct fit on that target (the
    card phase's fallback, at a small size on the CPU)."""
    pts = _mixture(200, seed=12)
    spec = ClusterSpec(k=4, seeder="rejection", seed=0)
    exe = ExecutionSpec(backend="device", device="cpu")
    fp = FaultPlan(seed=0, solve_failure_rate=1.0, match="rejection/")
    with ClusterEngine(spec, exe, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=2)) as engine:
        got = engine.submit(pts, seed=3).result(timeout=60)
        fallback_plan = engine.plan_for(spec.replace(seeder="kmeans||"))
        stats = engine.stats()
    assert got.extras["served_by"] == "kmeans||/device"
    assert got.extras["fallback_path"] == ("rejection/device",
                                           "rejection/cpu")
    assert stats["retries"] == 2 and fp.stats()["injected"] == 4
    assert fallback_plan.execution == exe
    direct = ClusterPlan(spec.replace(seeder="kmeans||"), exe)
    want = direct.fit_prepared(direct.prepare_data(pts), seed=3)
    assert got.indices.device.type == "cpu"
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.cost, want.cost)


@pytest.mark.timeout(ENGINE_LIMIT)
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_engine_on_the_card_never_builds_a_cpu_backend_plan(device,
                                                            monkeypatch):
    """An engine on a CUDA device walks only the device rungs of the
    fallback chain (rejection/device, then kmeans||/device), then fails
    typed: no "cpu"-backend plan is built.  On the CPU the chain is the
    JAX package's.  Every prepare faults before it touches the device,
    and plans resolve their device to the CPU, so the cuda engine runs
    here."""
    monkeypatch.setattr(plan_module, "resolve_device",
                        lambda name: torch.device("cpu"))
    fp = FaultPlan(seed=0, prepare_failure_rate=1.0)
    spec = ClusterSpec(k=4, seeder="rejection", seed=0)
    exe = ExecutionSpec(backend="device", device=device)
    with ClusterEngine(spec, exe, fault_plan=fp) as engine:
        exc = engine.submit(_mixture(64, seed=13)).exception(timeout=60)
        built = {(p.cluster.seeder, p.execution.backend)
                 for p in engine._plans.values()}
        health = engine.stats()["health"]
    assert isinstance(exc, InjectedFault) and exc.transient
    chain = [("rejection", "device")] + fallback_chain("rejection", "device")
    want = {t for t in chain if device == "cpu" or t[1] != "cpu"}
    if device == "cuda":
        assert want == {("rejection", "device"), ("kmeans||", "device")}
    else:
        assert ("rejection", "cpu") in want
    assert built == want
    assert set(health) == {f"{s}/{b}" for s, b in want}
    assert fp.stats()["injected"] == len(want)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_exhausted_chain_surfaces_the_transient_error():
    spec = ClusterSpec(k=3, seeder="kmeans++", seed=0)
    fp = FaultPlan(seed=3, solve_failure_rate=1.0)
    with ClusterEngine(spec, CPU, fault_plan=fp) as engine:
        exc = engine.submit(_mixture(96, seed=2)).exception(timeout=60)
        assert isinstance(exc, InjectedFault) and exc.transient
        stats = engine.stats()
    assert stats["failed"] == 1 and stats["completed"] == 0


@pytest.mark.timeout(ENGINE_LIMIT)
def test_breaker_opens_short_circuits_probes_and_recloses():
    clock = _FakeClock()
    pts = _mixture(128, seed=4)
    fp = FaultPlan(seed=2, solve_failure_rate=1.0, match=PRIMARY,
                   max_failures=2)
    with ClusterEngine(
            SPEC, CPU, fault_plan=fp, clock=clock,
            breaker=CircuitBreakerPolicy(failure_threshold=2,
                                         cooldown_s=30.0)) as engine:
        r1 = engine.submit(pts).result(timeout=60)
        assert r1.extras["served_by"] == "kmeans++/cpu"
        assert engine.stats()["health"][PRIMARY] == "OK"
        r2 = engine.submit(pts).result(timeout=60)
        assert r2.extras["served_by"] == "kmeans++/cpu"
        assert engine.stats()["health"][PRIMARY] == "OPEN"
        r3 = engine.submit(pts).result(timeout=60)
        assert r3.extras["fallback_path"] == (PRIMARY + ":open",)
        assert engine.stats()["short_circuited"] == 1
        clock.advance(31.0)
        r4 = engine.submit(pts).result(timeout=60)
        assert r4.extras["served_by"] == PRIMARY
        assert engine.stats()["health"][PRIMARY] == "OK"
        stats = engine.stats()
    assert stats["completed"] == 4 and stats["fallback_served"] == 3


@pytest.mark.timeout(ENGINE_LIMIT)
def test_map_fit_drains_all_tickets_then_reraises():
    datasets = [_mixture(96, seed=20 + i) for i in range(4)]
    fp = FaultPlan(seed=0, solve_failure_rate=1.0, permanent_rate=1.0,
                   match=data_fingerprint(datasets[1]))
    with ClusterEngine(SPEC, CPU, fault_plan=fp) as engine:
        with pytest.raises(InjectedFault):
            engine.map_fit(datasets)
        stats = engine.stats()
    assert stats["completed"] == 3 and stats["failed"] == 1
    assert stats["cancelled"] == 0


@pytest.mark.timeout(ENGINE_LIMIT)
def test_map_fit_return_exceptions_keeps_positions():
    datasets = [_mixture(96, seed=30 + i) for i in range(3)]
    fp = FaultPlan(seed=0, solve_failure_rate=1.0, permanent_rate=1.0,
                   match=data_fingerprint(datasets[2]))
    with ClusterEngine(SPEC, CPU, fault_plan=fp) as engine:
        out = engine.map_fit(datasets, return_exceptions=True)
    assert out[0].k == 3 and out[1].k == 3
    assert isinstance(out[2], InjectedFault)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_chaos_every_request_reaches_a_typed_terminal_state():
    """>= 20% injected transient solve failures + 5% permanent: every
    ticket completes (possibly through a recorded fallback equal to a
    direct fit), fails typed, or expires at its deadline, and the books
    balance.  The fault decisions are the JAX package's (seed 3, the JAX
    suite's profile), since the keys are the same fingerprints."""
    b = 24
    datasets = [_mixture(120 + 4 * i, seed=100 + i) for i in range(b)]
    fp = FaultPlan(seed=3, solve_failure_rate=0.35, permanent_rate=0.05,
                   match=PRIMARY)
    with ClusterEngine(SPEC, CPU, fault_plan=fp,
                       retry=RetryPolicy(max_attempts=3),
                       breaker=CircuitBreakerPolicy(failure_threshold=5)
                       ) as engine:
        tickets = [engine.submit(ds, deadline=120.0) for ds in datasets]
        outcomes = {"completed": 0, "permanent": 0, "deadline": 0}
        fallback_served = []
        for t in engine.as_completed(tickets, timeout=100):
            exc = t.exception()
            if exc is None:
                outcomes["completed"] += 1
                if t.result().extras["served_by"] != PRIMARY:
                    fallback_served.append(t)
            elif isinstance(exc, DeadlineExceededError):
                outcomes["deadline"] += 1
            else:
                assert classify_failure(exc) == "permanent", repr(exc)
                outcomes["permanent"] += 1
        stats = engine.stats()
    assert sum(outcomes.values()) == b
    assert stats["completed"] + stats["failed"] + stats["cancelled"] \
        == stats["submitted"] == b
    assert stats["pending"] == 0
    assert fp.stats()["injected"] >= 0.2 * b
    assert outcomes["completed"] / b > 0.95
    assert stats["retries"] >= 1
    assert stats["fallback_served"] >= 1 and fallback_served
    by_ticket = dict(zip(tickets, datasets))
    for t in fallback_served[:3]:
        seeder, backend = t.result().extras["served_by"].split("/")
        direct = ClusterPlan(SPEC.replace(seeder=seeder),
                             ExecutionSpec(backend=backend, device="cpu")
                             ).fit(by_ticket[t])
        assert torch.equal(t.result().indices, direct.indices)


@pytest.mark.timeout(ENGINE_LIMIT)
def test_no_ticket_is_ever_stranded_by_close():
    fp = FaultPlan(seed=7, solve_failure_rate=0.5, solve_latency_s=0.1,
                   match=PRIMARY)
    engine = ClusterEngine(SPEC, CPU, fault_plan=fp,
                           retry=RetryPolicy(max_attempts=2))
    tickets = [engine.submit(_mixture(96, seed=200 + i)) for i in range(8)]
    time.sleep(0.25)
    engine.close(cancel_pending=True)
    for t in tickets:
        t.exception(timeout=60)
        assert t.done()
    stats = engine.stats()
    assert stats["cancelled"] + stats["completed"] + stats["failed"] \
        == stats["submitted"] == 8
    assert stats["pending"] == 0


@pytest.mark.timeout(ENGINE_LIMIT)
def test_transient_failure_frames_are_released():
    """The failed attempt's frames (and what they hold) are cleared before
    the retry and before the ticket keeps the exception: a stand-in for
    the card's out-of-memory, whose tensors must not outlive the attempt."""
    import weakref

    held = []

    class Held:
        pass

    class Leaky:
        """Fails each solve once, with a large local alive in its frame."""

        def __init__(self):
            self.calls = 0

        def inject(self, stage, key):
            if stage != "solve":
                return
            self.calls += 1
            big = Held()
            held.append(weakref.ref(big))
            if self.calls <= 2:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            del big

    with ClusterEngine(SPEC, CPU, fault_plan=Leaky(), degrade=False,
                       retry=RetryPolicy(max_attempts=2)) as engine:
        ticket = engine.submit(_mixture(96, seed=1))
        exc = ticket.exception(timeout=60)
    assert isinstance(exc, torch.cuda.OutOfMemoryError)
    assert classify_failure(exc) == "transient"
    # The ticket still holds the last attempt's exception: without the
    # clearing its frame would keep `big` alive.
    assert len(held) == 2 and all(r() is None for r in held)
