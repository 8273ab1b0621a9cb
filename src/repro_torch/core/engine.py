"""Async pipelined execution engine: overlap host prepare with device solve
(the JAX package's `core/engine.py`, on the port's plan).

The plan/execute split (`core.plan`) made the expensive O(nd log Δ) host
work — quantisation, multi-tree embedding codes, LSH bucket keys, device
upload — a cacheable stage, but a serial caller still runs it back-to-back
with the device solve:

    serial:     [prep 0][solve 0][prep 1][solve 1][prep 2][solve 2] ...
    pipelined:  [prep 0][prep 1 ][prep 2 ] ...          (prepare pool)
                        [solve 0][solve 1][solve 2] ...  (solve worker)

`ClusterEngine` is that pipeline.  `submit(points)` enqueues a fit request
and returns a `FitTicket` future immediately: the host prepare of request
i+1 runs on a thread pool (NumPy/hashing release the GIL; the artifact
upload is a copy to the card) while a single dedicated solve worker
drains requests **in submission order** — which is what makes the
pipeline deterministic: every request's solve consumes only its own
`PreparedData` and rng stream, so results are bit-for-bit identical to
the serial `plan.prepare(points); plan.fit()` loop
(tests/test_torch_engine.py asserts exactly that).  Both the pool's
uploads and the worker's kernels go to the device's default stream, so
no tensor crosses streams: an upload is ordered before every kernel
enqueued after it.

Throughput model: with per-request host cost P and device cost S, the
serial loop takes ``B (P + S)`` while the pipeline takes
``~ P + B max(P / W, S)`` for W prepare workers — an overlapped speedup
approaching ``(P + S) / max(P / W, S)``.

The engine is also the repo's fault-tolerant serving core
(`core.resilience`, docs/resilience.md): a bounded submit queue with
block / reject / shed-oldest backpressure, input quarantine at
`submit()`, per-request monotonic deadlines, transient-failure retries
on attempt-derived rng streams, and a circuit breaker per
(seeder, backend) that degrades an unhealthy target down the
registry-declared fallback chain (``sharded → device → cpu``,
``rejection → kmeans|| → kmeans++``) — correctness-preserving, since
every chained seeder carries the same O(log k) guarantee.  An engine on
the card skips the chain's ``"cpu"`` rungs: nothing it serves falls
back to the host while the card is there.  `stats()`
surfaces the counters and per-target health; a `resilience.FaultPlan`
makes the whole machine deterministically chaos-testable.  A transient
failure has its traceback's frames cleared before the retry or the
fallback, and again before its ticket keeps it: after a CUDA
out-of-memory the failed attempt's tensors are freed, not held by the
exception.

Plans are cached per `ClusterSpec` — requests sharing a spec share one
`ClusterPlan` (so repeated datasets are fingerprint cache hits).  The
engine is a context manager; `close()` drains the queue and joins the
workers.  The JAX package's buffer donation (``ExecutionSpec(donate=
True)``) has no counterpart here: the caching allocator reuses a
finished request's memory.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import torch

from repro_torch.core.plan import (ClusterPlan, ClusterSpec, ExecutionSpec,
                                   FitResult)
from repro_torch.core.resilience import (
    CircuitBreaker,
    CircuitBreakerPolicy,
    DeadlineExceededError,
    FaultPlan,
    InvalidInputError,
    NO_RETRY,
    QueueFullError,
    RetryPolicy,
    ServiceUnavailableError,
    attempt_seed,
    classify_failure,
    fallback_chain,
    validate_points,
)

__all__ = ["ClusterEngine", "FitTicket"]

_BACKPRESSURE_POLICIES = ("block", "reject", "shed-oldest")


def _release_frames(exc: BaseException) -> None:
    """Clear the locals of the finished frames behind a transient failure.

    The traceback of a failed attempt holds its frames, and they hold the
    attempt's tensors: after a CUDA out-of-memory those tensors would make
    the retry fail the same way, and they would stay alive for as long as
    a ticket keeps the exception.  Frames still running (the engine's
    own) are left as they are.
    """
    seen: set = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__

#: Counter keys `stats()` always reports (zero-seeded), so accounting
#: invariants like ``cancelled + completed + failed == submitted`` hold
#: without key-existence checks.  completed/failed/cancelled are the
#: disjoint terminal states; deadline_expired ⊆ failed and shed ⊆
#: cancelled are sub-category counters; quarantined/rejected requests
#: never became tickets and are outside ``submitted``.
_COUNTERS = (
    "submitted", "completed", "failed", "cancelled",
    "quarantined", "rejected", "shed", "deadline_expired",
    "retries", "fallback_served", "short_circuited", "extends",
)


@dataclasses.dataclass(eq=False)
class FitTicket:
    """A submitted fit request: a future over a device-resident `FitResult`.

    `result()` blocks until the pipelined solve finished (the tensors it
    returns are on the plan's device — use them there without a host
    copy, or `.to_numpy()` them).  Tickets compare
    (and hash) by identity — two requests are two tickets — and remember
    their submission `index` (the engine solves in index order).

    `deadline` is the request's expiry on the engine's monotonic clock
    (absolute, set from the relative ``submit(deadline=)``); `retry` the
    per-request `RetryPolicy` override.  A served result's
    ``extras["served_by"]`` / ``extras["fallback_path"]`` /
    ``extras["attempts"]`` record which (seeder, backend) actually
    solved it and the degradation path taken.
    """

    index: int
    cluster: ClusterSpec
    seed: Optional[int]
    tag: Any = None
    deadline: Optional[float] = None
    retry: Optional[RetryPolicy] = None
    _future: cf.Future = dataclasses.field(default_factory=cf.Future,
                                           repr=False, compare=False)

    def result(self, timeout: Optional[float] = None) -> FitResult:
        """The `FitResult` (blocks up to `timeout` seconds)."""
        return self._future.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        """The solve/prepare exception, if the request failed."""
        return self._future.exception(timeout)

    def done(self) -> bool:
        """True once the result (or an exception) is available."""
        return self._future.done()

    def add_done_callback(self, fn) -> None:
        """Call ``fn(ticket)`` when the request completes."""
        self._future.add_done_callback(lambda _f: fn(self))


@dataclasses.dataclass(eq=False)
class _Item:
    """One queued request: the ticket plus what its solve needs.

    `points` is retained so a retry or a fallback target can re-prepare
    the dataset after a failed (or foreign-plan) primary prepare.  A
    coalesced *lane* (`submit_lane`) sets `lane_seeds`: `points` is then
    the list of member datasets, the prepare future resolves to a list of
    stacked `PreparedData` handles, and the solve runs
    `fit_batch_prepared` — one ticket, one stacked `FitResult`.
    """

    ticket: FitTicket
    plan: ClusterPlan
    points: Any
    prep_future: cf.Future
    lane_seeds: Optional[list] = None       # None => solo request
    # Streaming extend (`submit_extend`): the mutation is one-shot — the
    # solve worker applies it exactly once (clearing `points`) and stores
    # the mutated handle in `prep`, so retries only refit and a replayed
    # attempt can never double-append the batch.
    stream: bool = False
    prep: Any = None


class ClusterEngine:
    """Pipelined, fault-tolerant fit executor over one placement.

    ::

        engine = ClusterEngine(ClusterSpec(k=64, seeder="rejection"),
                               ExecutionSpec(backend="device"))
        with engine:
            tickets = [engine.submit(ds) for ds in datasets]   # returns now
            for t in engine.as_completed(tickets):
                serve(t.result())                # completion order
        # or, in submission order, one call:
        results = engine.map_fit(datasets)

    `prepare_workers` bounds the host-side look-ahead (2 is usually enough
    to hide prepare behind solve; more helps only while prepare is the
    bottleneck).  All submissions against one engine share its plan cache:
    a request for already-seen data skips prepare entirely.

    `retain_prepared` controls cache *memory*, not concurrency: the
    default True keeps every dataset's `PreparedData` for the engine's
    lifetime (right for a bounded working set that re-submits data);
    False evicts each request's entry once its solve completes, so a
    serving loop over a stream of fresh datasets holds O(pipeline depth)
    prepared artifacts instead of O(requests ever).

    Resilience knobs (semantics in docs/resilience.md): `max_pending`
    bounds the not-yet-dispatched queue with `backpressure` policy
    ``"block"`` (wait for space), ``"reject"`` (raise `QueueFullError`),
    or ``"shed-oldest"`` (fail the oldest queued ticket to admit the
    new one); `validate_inputs` quarantines NaN/Inf/empty/degenerate
    datasets at submit; `retry` is the engine-wide default
    `RetryPolicy` (no retries unless set — per-ticket override via
    ``submit(retry=)``); `breaker` configures the per-(seeder, backend)
    `CircuitBreakerPolicy`; `degrade=False` turns the fallback chain
    off (failures surface instead; on a CUDA device the chain keeps its
    device rungs only); `fault_plan` forwards a
    `resilience.FaultPlan` to every plan the engine builds; `clock` is
    the monotonic clock used for deadlines and breaker cooldowns
    (injectable for tests).
    """

    def __init__(self, cluster: Optional[ClusterSpec] = None,
                 execution: Optional[ExecutionSpec] = None, *,
                 prepare_workers: int = 2, retain_prepared: bool = True,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 validate_inputs: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreakerPolicy] = None,
                 degrade: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 clock: Callable[[], float] = time.monotonic):
        if prepare_workers < 1:
            raise ValueError(
                f"prepare_workers must be >= 1, got {prepare_workers}")
        if backpressure not in _BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {backpressure!r}; "
                f"expected one of {_BACKPRESSURE_POLICIES}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.cluster = cluster
        self.execution = execution if execution is not None \
            else ExecutionSpec()
        self.retain_prepared = retain_prepared
        self.max_pending = max_pending
        self.backpressure = backpressure
        self.validate_inputs = validate_inputs
        self.retry = retry if retry is not None else NO_RETRY
        self.breaker_policy = breaker if breaker is not None \
            else CircuitBreakerPolicy()
        self.degrade = degrade
        self.fault_plan = fault_plan
        self._clock = clock
        self._plans: dict = {}
        self._breakers: dict = {}
        self._pool = cf.ThreadPoolExecutor(
            max_workers=prepare_workers,
            thread_name_prefix="cluster-engine-prepare")
        # A Condition (not a bare Lock): submit blocks on it under the
        # "block" backpressure policy and the solve worker sleeps on it
        # while the queue is empty.
        self._lock = threading.Condition(threading.Lock())
        self._pending: collections.deque = collections.deque()
        self._closed = False
        self._cancel = False
        self._next_index = 0
        self._stats = collections.Counter()
        self._times = {"prepare_seconds": 0.0, "solve_seconds": 0.0}
        self._solver = threading.Thread(
            target=self._solve_loop, name="cluster-engine-solve",
            daemon=True)
        self._solver.start()

    # -- submission ---------------------------------------------------------

    def plan_for(self, cluster: Optional[ClusterSpec] = None) -> ClusterPlan:
        """The engine's shared `ClusterPlan` for a spec (built on first use).

        Requests with equal (hashable) specs share one plan — and with it
        the prepare fingerprint cache.
        """
        spec = cluster if cluster is not None else self.cluster
        if spec is None:
            raise ValueError(
                "no ClusterSpec: pass one to submit()/map_fit() or to the "
                "engine constructor")
        return self._plan_cached(spec, self.execution)

    def _plan_cached(self, spec: ClusterSpec,
                     execution: ExecutionSpec) -> ClusterPlan:
        with self._lock:
            plan = self._plans.get((spec, execution))
            if plan is None:
                plan = ClusterPlan(spec, execution,
                                   fault_plan=self.fault_plan)
                self._plans[(spec, execution)] = plan
            return plan

    def submit(self, points, *, cluster: Optional[ClusterSpec] = None,
               seed: Optional[int] = None, tag: Any = None,
               deadline: Optional[float] = None,
               retry: Optional[RetryPolicy] = None) -> FitTicket:
        """Enqueue one fit request; returns its `FitTicket` immediately.

        The host prepare starts on the pool right away; the device solve
        runs on the solve worker once every earlier request's solve has
        been dispatched.  `seed=None` uses the spec's seed (the serial
        `plan.fit()` stream); `tag` is an opaque caller label carried on
        the ticket.

        `deadline` (seconds from now, engine monotonic clock) bounds the
        request end to end: expiry at dispatch, during the prepare wait,
        between retries, or on a too-late solve fails the ticket with
        `DeadlineExceededError`.  `retry` overrides the engine's default
        `RetryPolicy` for this request.  Invalid datasets
        (NaN/Inf/empty/degenerate) are quarantined here — a typed
        `InvalidInputError` raises synchronously and no ticket is
        created; a full bounded queue raises `QueueFullError` under the
        ``"reject"`` policy (under ``"shed-oldest"`` the oldest queued
        ticket fails with it instead).
        """
        plan = self.plan_for(cluster)
        if self.validate_inputs:
            try:
                validate_points(points, k=plan.cluster.k)
            except InvalidInputError:
                with self._lock:
                    self._stats["quarantined"] += 1
                raise
        return self._admit(plan, points, seed=seed, tag=tag,
                           deadline=deadline, retry=retry,
                           prepare=lambda: self._timed_prepare(plan, points))

    def submit_lane(self, datasets: Sequence[Any], *,
                    cluster: Optional[ClusterSpec] = None,
                    seeds: Optional[Sequence[Optional[int]]] = None,
                    tag: Any = None, deadline: Optional[float] = None,
                    retry: Optional[RetryPolicy] = None) -> FitTicket:
        """Enqueue B datasets as ONE coalesced stacked `fit_batch` lane.

        The continuous-batching dispatch primitive (`repro_torch.serving.
        frontend.ClusterFrontend` coalesces concurrent `submit` calls
        into these): the whole lane is one ticket whose result is the
        stacked `FitResult` (leading batch axis over the members, lane i
        bit-identical to a solo stacked fit of ``datasets[i]`` in the
        same shape bucket).  The lane members' stacked prepares run on
        the prepare pool (each fingerprint-cached, so a member re-coalesced
        into a later lane is a cache hit) and the solve dispatches as one
        lane-batched solve per shape bucket via `ClusterPlan.
        fit_batch_prepared`; on impls without the stacked capability the
        lane degrades to the solo `fit_batch` loop.  Admission control,
        deadlines, retries (per-member seeds move to fresh
        `attempt_seed` streams together) and the circuit-breaker fallback
        chain behave exactly as for `submit` — a lane is one queue slot.
        `seeds` gives one solve seed per member (None entries use the
        spec seed, i.e. the solo `refit` stream).
        """
        datasets = list(datasets)
        if not datasets:
            raise ValueError("submit_lane() needs >= 1 dataset")
        if seeds is None:
            seeds = [None] * len(datasets)
        else:
            seeds = [None if s is None else int(s) for s in seeds]
        if len(seeds) != len(datasets):
            raise ValueError(
                f"got {len(seeds)} seeds for {len(datasets)} datasets")
        plan = self.plan_for(cluster)
        if self.validate_inputs:
            for pts in datasets:
                try:
                    validate_points(pts, k=plan.cluster.k)
                except InvalidInputError:
                    with self._lock:
                        self._stats["quarantined"] += 1
                    raise
        return self._admit(plan, datasets, seed=None, tag=tag,
                           deadline=deadline, retry=retry,
                           prepare=lambda: self._lane_prepare(plan, datasets),
                           lane_seeds=seeds)

    def submit_extend(self, points, *, prepared=None,
                      cluster: Optional[ClusterSpec] = None,
                      seed: Optional[int] = None, tag: Any = None,
                      deadline: Optional[float] = None,
                      retry: Optional[RetryPolicy] = None) -> FitTicket:
        """Enqueue a streaming extend-then-refit; returns its `FitTicket`.

        The streaming dispatch primitive (the wire `EXTEND` frame lands
        here): `points` are appended *in place* to the stream behind
        `prepared` (default: the plan's active handle, converted to a
        stream if needed) via `ClusterPlan.extend` — frozen-scale
        quantisation, incremental code/key encode, leaf-weight patching,
        no re-prepare — and the refit solves over the grown live set.
        The mutation runs exactly once on the solve worker, in submission
        order (so interleaved `submit`/`submit_extend` traffic sees a
        deterministic stream history); retries refit the already-mutated
        stream on attempt-derived seeds without re-appending, and the
        circuit-breaker fallback chain is bypassed — a foreign
        (seeder, backend) target has no access to this stream's
        artifacts, so degrading would silently drop the mutation.
        Streaming handles are never auto-evicted
        (``retain_prepared=False`` only governs per-request datasets);
        release them explicitly with ``plan.forget(prepared)``.
        `deadline`/`retry`/`tag` behave as for `submit`; the extend batch
        is quarantined on NaN/Inf/non-2D input (it may be smaller than
        k — only the refit needs k live rows).  ``points=None`` skips
        the mutation and just refits the stream as-is (the
        drift-triggered reseed path) — that form requires an explicit
        ``prepared`` handle.
        """
        plan = self.plan_for(cluster)
        if points is None:
            if prepared is None:
                raise ValueError(
                    "refit-only submit_extend (points=None) needs an "
                    "explicit prepared stream handle")
        elif self.validate_inputs:
            try:
                validate_points(points)
            except InvalidInputError:
                with self._lock:
                    self._stats["quarantined"] += 1
                raise
        with self._lock:
            if points is not None:
                self._stats["extends"] += 1
        return self._admit(plan, points, seed=seed, tag=tag,
                           deadline=deadline, retry=retry,
                           prepare=lambda: prepared, stream=True)

    def _admit(self, plan: ClusterPlan, points, *, seed, tag, deadline,
               retry, prepare: Callable[[], Any],
               lane_seeds: Optional[list] = None,
               stream: bool = False) -> FitTicket:
        """Shared admission control: one queue slot per request OR lane."""
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        shed: Optional[_Item] = None
        # The closed-check, admission control, ticket numbering and
        # enqueue happen under one lock acquisition so a concurrent
        # close() can never strand a ticket.
        with self._lock:
            if self.max_pending is not None:
                if self.backpressure == "block":
                    while len(self._pending) >= self.max_pending \
                            and not self._closed:
                        self._lock.wait()
                elif len(self._pending) >= self.max_pending:
                    if self.backpressure == "reject":
                        self._stats["rejected"] += 1
                        raise QueueFullError(
                            f"submit queue full "
                            f"({self.max_pending} pending); "
                            "request rejected (backpressure='reject')")
                    shed = self._pending.popleft()
                    self._stats["shed"] += 1
                    self._stats["cancelled"] += 1
            if self._closed:
                raise RuntimeError("engine is closed")
            index = self._next_index
            self._next_index += 1
            self._stats["submitted"] += 1
            ticket = FitTicket(
                index=index, cluster=plan.cluster, seed=seed, tag=tag,
                deadline=None if deadline is None
                else self._clock() + deadline,
                retry=retry)
            prep_future = self._pool.submit(prepare)
            self._pending.append(_Item(ticket, plan, points, prep_future,
                                       lane_seeds=lane_seeds, stream=stream))
            self._lock.notify_all()
        if shed is not None:
            # Outside the lock: failing the future runs done-callbacks.
            shed.prep_future.cancel()
            shed.ticket._future.set_exception(QueueFullError(
                "request shed: newer submission displaced it "
                "(backpressure='shed-oldest')"))
        return ticket

    def map_fit(self, datasets: Sequence[Any], *,
                cluster: Optional[ClusterSpec] = None,
                seeds: Optional[Sequence[int]] = None,
                return_exceptions: bool = False) -> list:
        """Pipelined fit of every dataset; results in submission order.

        The synchronous convenience over `submit`: all prepares are in
        flight while earlier solves run, and the call blocks until the
        last result.  `seeds` (optional) gives one solve seed per dataset.

        One failed dataset does not abandon the rest: every ticket is
        drained either way.  With `return_exceptions=True` the failure
        objects appear in the result list at their dataset's position;
        by default the first failure re-raises after the drain.
        """
        if seeds is not None and len(seeds) != len(datasets):
            raise ValueError(
                f"got {len(seeds)} seeds for {len(datasets)} datasets")
        tickets = [
            self.submit(ds, cluster=cluster,
                        seed=None if seeds is None else int(seeds[i]))
            for i, ds in enumerate(datasets)
        ]
        outcomes: list = []
        first_exc: Optional[BaseException] = None
        for t in tickets:
            try:
                outcomes.append(t.result())
            except BaseException as e:  # noqa: BLE001 — collected per ticket
                outcomes.append(e)
                if first_exc is None:
                    first_exc = e
        if not return_exceptions and first_exc is not None:
            raise first_exc
        return outcomes

    # -- completion ---------------------------------------------------------

    def as_completed(self, tickets: Iterable[FitTicket],
                     timeout: Optional[float] = None
                     ) -> Iterator[FitTicket]:
        """Yield tickets as their results become available.

        Completion order can only run ahead of submission order by what the
        pipeline reorders (solves are sequential; result readiness is not),
        so this is how a serving loop consumes results at device speed.
        A `timeout` expiry raises `TimeoutError` from the iterator; the
        pipeline itself is unaffected (undrained tickets keep solving and
        can be awaited again).
        """
        tickets = list(tickets)
        by_future = {t._future: t for t in tickets}
        for fut in cf.as_completed(by_future, timeout=timeout):
            yield by_future[fut]

    # -- pipeline internals -------------------------------------------------

    def _timed_prepare(self, plan: ClusterPlan, points):
        t0 = time.perf_counter()
        prep = plan.prepare_data(points)
        with self._lock:
            self._times["prepare_seconds"] += time.perf_counter() - t0
        return prep

    @staticmethod
    def _lane_stacked(plan: ClusterPlan) -> bool:
        return plan.impl.supports_stacked and plan.cluster.lloyd_iters == 0

    def _lane_prepare(self, plan: ClusterPlan, datasets: list) -> list:
        """Prepare every lane member (stacked handles where supported).

        Runs as ONE prepare-pool task — members build sequentially inside
        it, so a lane never deadlocks the bounded pool waiting on its own
        sub-tasks, and each member is fingerprint-cached (a request
        re-coalesced into a later lane, or a retry, is a cache hit).
        """
        prep_fn = (plan.prepare_stacked if self._lane_stacked(plan)
                   else plan.prepare_data)
        t0 = time.perf_counter()
        preps = [prep_fn(pts) for pts in datasets]
        with self._lock:
            self._times["prepare_seconds"] += time.perf_counter() - t0
        return preps

    def _lane_solve(self, item: _Item, plan: ClusterPlan, preps: list,
                    attempt: int) -> FitResult:
        """Solve one coalesced lane (stacked where the impl supports it).

        Attempt 0 keeps every member on its submitted seed — `None`
        entries resolve to the spec seed, whose prepare-time rng snapshot
        is replayed, so each lane stays bit-identical to a solo stacked
        fit.  Retries fold the attempt index into every member's seed so
        no attempt shares an rng stream with the primary.
        """
        eff = [attempt_seed(s, attempt) for s in item.lane_seeds]
        if all(s is None for s in eff):
            eff = None
        else:
            eff = [plan.cluster.seed if s is None else s for s in eff]
        if self._lane_stacked(plan):
            return plan.fit_batch_prepared(preps, seeds=eff)
        # Fallback target without the stacked capability: solo loop (each
        # member already fingerprint-cached by _lane_prepare).
        return plan.fit_batch(datasets=item.points, seeds=eff)

    def _solve_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if not self._pending:
                    return                 # closed and fully drained
                item = self._pending.popleft()
                cancelled = self._cancel
                self._lock.notify_all()    # wake blocked submitters
            if cancelled:
                # close(cancel_pending=True): fail queued tickets fast
                # instead of solving the backlog.
                item.prep_future.cancel()
                with self._lock:
                    self._stats["cancelled"] += 1
                item.ticket._future.set_exception(
                    cf.CancelledError("engine closed with cancel_pending"))
                continue
            self._dispatch(item)

    def _dispatch(self, item: _Item) -> None:
        """Drive one request to a terminal state (exactly one counter)."""
        used: list = []                    # (plan, prep) pairs to evict
        try:
            try:
                self._check_deadline(item.ticket)
                res = self._solve_resilient(item, used)
                with self._lock:
                    self._stats["completed"] += 1
                item.ticket._future.set_result(res)
            except BaseException as e:  # noqa: BLE001 — forwarded to ticket
                with self._lock:
                    if isinstance(e, cf.CancelledError):
                        self._stats["cancelled"] += 1
                    else:
                        self._stats["failed"] += 1
                        if isinstance(e, DeadlineExceededError):
                            self._stats["deadline_expired"] += 1
                if classify_failure(e) == "transient":
                    _release_frames(e)
                item.ticket._future.set_exception(e)
        finally:
            # Eviction must also cover failed solves, or streaming mode
            # (retain_prepared=False) leaks an entry per bad request.
            for plan, prep in used:
                plan.forget(prep)

    def _solve_resilient(self, item: _Item, used: list) -> FitResult:
        """Solve through the primary target, then the fallback chain.

        Transient failures (after the per-target retry budget) and open
        circuits move to the next (seeder, backend) in the
        registry-declared chain; permanent failures, deadline expiry and
        cancellation surface immediately.
        """
        plan = item.plan
        primary = (plan.cluster.seeder, plan.execution.backend)
        targets = [primary]
        # Streaming extends pin the primary: a fallback (seeder, backend)
        # has no access to this stream's mutable artifacts, so degrading
        # would silently drop the mutation instead of serving it.
        if self.degrade and not item.stream:
            targets += self._fallback_targets(primary)
        path: list = []
        last_exc: Optional[BaseException] = None
        for target in targets:
            breaker = self._breaker(target)
            if not breaker.allow():
                with self._lock:
                    self._stats["short_circuited"] += 1
                path.append(f"{target[0]}/{target[1]}:open")
                continue
            if target == primary:
                t_plan, prep_future = plan, item.prep_future
            else:
                t_plan = self._plan_cached(
                    plan.cluster.replace(seeder=target[0]),
                    self._execution_for(target[1]))
                prep_future = None
            try:
                res = self._attempt_target(item, t_plan, target,
                                           prep_future, breaker, path, used)
            except (DeadlineExceededError, cf.CancelledError):
                raise
            except BaseException as e:  # noqa: BLE001 — classified below
                if classify_failure(e) == "permanent":
                    raise
                last_exc = e
                continue
            if target != primary:
                with self._lock:
                    self._stats["fallback_served"] += 1
            return res
        if last_exc is not None:
            raise last_exc
        raise ServiceUnavailableError(
            f"no target available for {primary[0]}/{primary[1]}: every "
            f"circuit in the fallback chain is open ({path})")

    def _attempt_target(self, item: _Item, plan: ClusterPlan,
                        target: tuple, prep_future: Optional[cf.Future],
                        breaker: CircuitBreaker, path: list,
                        used: list) -> FitResult:
        """Run the retry loop against one (seeder, backend) target."""
        ticket = item.ticket
        policy = ticket.retry if ticket.retry is not None else self.retry
        label = f"{target[0]}/{target[1]}"
        attempt = 0
        while True:
            self._check_cancelled()
            self._check_deadline(ticket)
            try:
                if item.stream:
                    # One-shot mutation: apply the extend on the first
                    # attempt only, then retries refit the mutated stream.
                    if item.prep is None:
                        item.prep = prep_future.result()
                    if item.points is not None:
                        item.prep = plan.extend(
                            item.points, prepared=item.prep)
                        item.points = None
                    prep = item.prep
                elif prep_future is not None and attempt == 0:
                    try:
                        prep = prep_future.result(
                            timeout=self._remaining(ticket))
                    except (cf.TimeoutError, TimeoutError):
                        if ticket.deadline is None:
                            raise      # a real timeout from inside prepare
                        raise DeadlineExceededError(
                            f"deadline expired while waiting for the "
                            f"prepare of request {ticket.index}") from None
                else:
                    # Retry / fallback: (re-)prepare on the solve worker.
                    # A healed transient prepare fault is a fresh build;
                    # an earlier successful build is a fingerprint hit.
                    prep = (self._lane_prepare(plan, item.points)
                            if item.lane_seeds is not None
                            else self._timed_prepare(plan, item.points))
                if not self.retain_prepared and not item.stream:
                    if item.lane_seeds is not None:
                        used.extend((plan, p) for p in prep)
                    else:
                        used.append((plan, prep))
                self._check_cancelled()
                self._check_deadline(ticket)
                t0 = time.perf_counter()
                if item.lane_seeds is not None:
                    res = self._lane_solve(item, plan, prep, attempt)
                else:
                    res = plan.fit_prepared(
                        prep, seed=attempt_seed(ticket.seed, attempt))
                with self._lock:
                    self._times["solve_seconds"] += time.perf_counter() - t0
                # A result after expiry is still an SLO miss: the caller
                # asked for an answer *by the deadline*.
                self._check_deadline(ticket)
                breaker.record_success()
                res.extras["served_by"] = label
                res.extras["attempts"] = attempt + 1
                res.extras["fallback_path"] = tuple(path)
                return res
            except (DeadlineExceededError, cf.CancelledError):
                raise
            except BaseException as e:  # noqa: BLE001 — classified below
                if classify_failure(e) == "permanent":
                    raise
                _release_frames(e)
                breaker.record_failure()
                attempt += 1
                if attempt >= policy.max_attempts \
                        or breaker.state == "OPEN":
                    path.append(label)
                    raise
                with self._lock:
                    self._stats["retries"] += 1
                delay = policy.delay(attempt, seed=ticket.index)
                if delay > 0:
                    remaining = self._remaining(ticket)
                    if remaining is not None:
                        delay = min(delay, max(remaining, 0.0))
                    time.sleep(delay)

    # -- resilience helpers -------------------------------------------------

    def _fallback_targets(self, primary: tuple) -> list:
        # On the card the "cpu" rungs are dropped: they would move the
        # solve to the host's NumPy seeders while the data stays on the
        # card, whose gather and cost fail as the device rung did.  A
        # failed device target degrades to the next device target only.
        chain = fallback_chain(*primary)
        if torch.device(self.execution.device).type == "cuda":
            chain = [t for t in chain if t[1] != "cpu"]
        return chain

    def _execution_for(self, backend: str) -> ExecutionSpec:
        # The fallback keeps the device (and dtype, tile): the backend
        # changes, and the mesh stays only on a sharded target.
        if backend == self.execution.backend:
            return self.execution
        return dataclasses.replace(
            self.execution, backend=backend,
            mesh=self.execution.mesh if backend == "sharded" else None)

    def _breaker(self, target: tuple) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(target)
            if br is None:
                br = CircuitBreaker(self.breaker_policy, clock=self._clock)
                self._breakers[target] = br
            return br

    def _remaining(self, ticket: FitTicket) -> Optional[float]:
        if ticket.deadline is None:
            return None
        return ticket.deadline - self._clock()

    def _check_deadline(self, ticket: FitTicket) -> None:
        remaining = self._remaining(ticket)
        if remaining is not None and remaining <= 0:
            raise DeadlineExceededError(
                f"request {ticket.index} missed its deadline by "
                f"{-remaining:.3f}s")

    def _check_cancelled(self) -> None:
        # close(cancel_pending=True) raced an in-flight dispatch: the
        # prepare may have finished, but the ticket must still be failed
        # as cancelled instead of solved after shutdown.
        with self._lock:
            cancelled = self._cancel
        if cancelled:
            raise cf.CancelledError("engine closed with cancel_pending")

    # -- lifecycle / stats --------------------------------------------------

    def stats(self) -> dict:
        """Pipeline counters, stage seconds, and per-target health.

        Counters in `_COUNTERS` are always present (zero-seeded);
        ``completed + failed + cancelled == submitted`` once the engine
        is closed (no stranded tickets).  ``pending`` is the
        not-yet-dispatched queue depth, ``health`` maps each
        ``"<seeder>/<backend>"`` target the engine has touched to its
        circuit state (``OK`` / ``DEGRADED`` / ``OPEN``), and the summed
        host-prepare / device-solve stage seconds quantify the
        pipelining win (serial wall-clock would be their sum).
        """
        out = {k: 0 for k in _COUNTERS}
        with self._lock:
            out.update(self._stats)
            out.update(self._times)
            out["plans"] = len(self._plans)
            out["pending"] = len(self._pending)
            out["health"] = {f"{s}/{b}": br.state
                             for (s, b), br in self._breakers.items()}
        return out

    def close(self, wait: bool = True, *,
              cancel_pending: bool = False) -> None:
        """Stop accepting work; drain the queue and join the workers.

        `cancel_pending=True` fails every not-yet-dispatched ticket with
        `concurrent.futures.CancelledError` instead of solving the backlog
        — the escape hatch `__exit__` takes when the with-block raised, so
        an exception (or Ctrl-C) does not block on hundreds of queued
        solves.  A request whose prepare is already running is cancelled
        too (its ticket fails; the prepare result is discarded).  After
        close, ``stats()`` satisfies
        ``completed + failed + cancelled == submitted``.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cancel = cancel_pending
            self._lock.notify_all()
        if wait:
            self._solver.join()
        self._pool.shutdown(wait=wait, cancel_futures=cancel_pending)

    def __enter__(self) -> "ClusterEngine":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.close(cancel_pending=exc_type is not None)
