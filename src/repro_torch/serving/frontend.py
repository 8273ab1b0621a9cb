"""Continuous-batching front-end: coalesce concurrent fits into stacked lanes
(the JAX package's `serving/frontend.py`, on the port's engine).

`ClusterEngine` (core.engine) pipelines requests but still runs ONE solve
per request; the stacked `fit_batch` path (core.plan / core.device_seeding)
solves B compatible datasets as one lane-batched solve but needs the caller
to assemble the batch.  `ClusterFrontend` closes that gap the way continuous
batching closes it for LLM decode engines: concurrent `submit()` calls are
held briefly in per-bucket queues and compatible requests — same
`ClusterSpec`, same feature dimension d, same `batch_schedule.shape_bucket`
rung — are coalesced into a single `ClusterEngine.submit_lane` dispatch.

The hold-and-batch window is governed by three rules, checked by a
dedicated batcher thread:

* **full** — a bucket reaches `max_batch` members: flush immediately.
* **timer** — the oldest member has waited `max_wait_ms`: flush what's
  there (latency floor for sparse traffic).
* **deadline** — a member's deadline minus a safety margin (the larger of
  `deadline_margin_ms` and 2x the observed lane service EMA) is about to
  pass: flush early rather than risk the SLO.

Ready lanes dispatch priority-first (then deadline-soonest, then arrival
order); since the engine solves lanes in submission order, dispatch order
is completion order.  Each member gets its own `FitTicket` whose result is
sliced out of the stacked lane `FitResult` (the slices stay on the
device) — bit-identical to a solo stacked fit of the same dataset (the
stacked-lane contract; asserted in tests/test_torch_frontend.py) — with
``extras["lane_size"/"bucket"/
"queue_wait"]`` recording how it was served.  Admission reuses the
core.resilience machinery: `validate_points` quarantine, `QueueFullError`
backpressure on the held queue, per-request deadlines on an injectable
monotonic clock; retries/fallbacks happen per *lane* inside the engine.

Tuning and lifecycle live in docs/serving.md (the JAX package's; the
knobs are the same).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from repro_torch.core import (
    ClusterEngine,
    ClusterSpec,
    ExecutionSpec,
    FitResult,
    FitTicket,
    QueueFullError,
    DeadlineExceededError,
    InvalidInputError,
    FaultPlan,
    RetryPolicy,
    shape_bucket,
    validate_points,
)

__all__ = ["ClusterFrontend"]

#: Backpressure policies for the *held* (not-yet-coalesced) queue.
_BACKPRESSURE_POLICIES = ("block", "reject")

#: Recent-window size for the queue-wait percentile reservoirs (per
#: priority and per tenant) surfaced by `stats()` / the wire STATS frame.
_QW_WINDOW = 4096

#: Percentiles `stats()` reports for each queue-wait reservoir.
_QW_PERCENTILES = (50, 90, 99)


@dataclasses.dataclass(eq=False)
class _Held:
    """One admitted request waiting in its coalescing bucket."""

    ticket: FitTicket
    points: Any
    priority: int
    arrival: float
    tenant: Optional[str] = None

    def sort_key(self) -> tuple:
        dl = self.ticket.deadline
        return (-self.priority, float("inf") if dl is None else dl,
                self.arrival)


def _qw_summary(samples) -> dict:
    """p50/p90/p99/count of one queue-wait reservoir (seconds)."""
    if not samples:
        return {"count": 0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
    arr = np.asarray(samples, dtype=np.float64)
    out = {"count": int(arr.size)}
    for p in _QW_PERCENTILES:
        out[f"p{p}"] = float(np.percentile(arr, p))
    return out


def _flush_reason(q: list, max_batch: int, max_wait: float, margin: float,
                  drain: bool, now: float) -> tuple:
    """Why bucket ``q`` flushes now — or when it next might.

    Returns ``(reason, next_due)``: ``reason`` is ``"drain"`` (close or
    explicit flush), ``"full"`` (bucket reached `max_batch`),
    ``"timer"`` (oldest member waited `max_wait`) or ``"deadline"`` (a
    member's deadline minus the safety ``margin`` has passed) — or None
    with the earliest future instant any of those becomes true.
    """
    if drain:
        return "drain", None
    if len(q) >= max_batch:
        return "full", None
    timer_due = min(m.arrival for m in q) + max_wait
    risk_due = min((m.ticket.deadline - margin for m in q
                    if m.ticket.deadline is not None),
                   default=float("inf"))
    due = min(timer_due, risk_due)
    if due <= now:
        return ("deadline" if risk_due < timer_due else "timer"), None
    return None, due


class ClusterFrontend:
    """Serving front door: admit, coalesce, dispatch, fan out.

    ::

        with ClusterFrontend(ClusterSpec(k=16, seeder="fastkmeans++"),
                             ExecutionSpec(backend="device"),
                             max_batch=8, max_wait_ms=5.0) as fe:
            tickets = [fe.submit(ds, deadline=0.5) for ds in stream]
            for t in fe.as_completed(tickets):
                serve(t.result())

    By default the frontend owns a private `ClusterEngine` built with
    ``validate_inputs=False`` (the frontend already quarantines at
    `submit`, so points are not re-scanned) and
    ``retain_prepared=False`` (a serving stream of fresh datasets must
    not accumulate prepared artifacts).  Pass ``engine=`` to share an
    existing engine instead — the frontend then never closes it.

    `max_pending` bounds the *held* queue (requests admitted but not yet
    coalesced) with ``backpressure`` either ``"block"`` (wait for space)
    or ``"reject"`` (raise `QueueFullError`); dispatched lanes queue in
    the engine beyond that.  All timing — deadlines, the hold window,
    the service EMA — runs on the injectable monotonic ``clock``.

    ``admission`` is the multi-tenant hook (duck-typed so the wire layer
    stays optional; `repro_torch.serving.net.tenancy.TenantScheduler` is the
    stdlib implementation): an object with ``admit(tenant)`` (raise a
    typed error to reject the request before it takes a hold-queue
    slot), ``virtual_time(tenant)`` (weighted-fair dequeue key — ready
    lanes drain smallest-first, so tenant fairness dominates request
    ``priority`` *across* tenants while priority still orders work
    within one) and ``on_dispatch(tenant, n)`` (charge dispatched
    members).  `submit(tenant=)` names the paying tenant (defaults to
    ``"default"`` whenever an admission hook is installed).
    """

    def __init__(self, cluster: Optional[ClusterSpec] = None,
                 execution: Optional[ExecutionSpec] = None, *,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 deadline_margin_ms: float = 50.0,
                 max_pending: Optional[int] = None,
                 backpressure: str = "block",
                 validate_inputs: bool = True,
                 engine: Optional[ClusterEngine] = None,
                 retry: Optional[RetryPolicy] = None,
                 degrade: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 admission: Optional[Any] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if backpressure not in _BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {backpressure!r}; "
                f"expected one of {_BACKPRESSURE_POLICIES}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if engine is not None:
            self._engine, self._own_engine = engine, False
            cluster = cluster if cluster is not None else engine.cluster
            execution = execution if execution is not None \
                else engine.execution
        else:
            self._engine = ClusterEngine(
                cluster, execution, validate_inputs=False,
                retain_prepared=False, retry=retry, degrade=degrade,
                fault_plan=fault_plan, clock=clock)
            self._own_engine = True
            execution = self._engine.execution
        if cluster is None:
            raise ValueError(
                "no ClusterSpec: pass one to the frontend (or share an "
                "engine constructed with one)")
        self.cluster = cluster
        self.execution = execution
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.backpressure = backpressure
        self.validate_inputs = validate_inputs
        self.admission = admission
        self._max_wait = max_wait_ms / 1e3
        self._margin_floor = deadline_margin_ms / 1e3
        self._clock = clock
        self._min_bucket = max(1024, execution.tile)
        self._lock = threading.Condition(threading.Lock())
        self._held: dict = collections.OrderedDict()   # key -> [_Held]
        self._held_count = 0
        self._inflight = 0
        self._closed = False
        self._force_flush = False
        self._dispatching = False
        self._next_index = 0
        self._service_ema = 0.0
        self._stats: collections.Counter = collections.Counter()
        self._queue_wait_total = 0.0
        # Bounded recent-window queue-wait samples (completed requests),
        # keyed by priority / tenant: the percentile source for stats()
        # and, through it, the wire STATS frame.
        self._qw_by_prio: dict = {}
        self._tenant_stats: dict = {}       # tenant -> Counter + samples
        self._batcher = threading.Thread(
            target=self._batch_loop, name="cluster-frontend-batch",
            daemon=True)
        self._batcher.start()

    # -- admission ----------------------------------------------------------

    def submit(self, points, *, k: Optional[int] = None,
               seed: Optional[int] = None, tag: Any = None,
               deadline: Optional[float] = None,
               priority: int = 0,
               tenant: Optional[str] = None) -> FitTicket:
        """Admit one fit request; returns its `FitTicket` immediately.

        The request is held (at most `max_wait_ms`) for coalescing with
        compatible traffic — same spec (`k` overrides the frontend
        spec's), same d, same `shape_bucket` rung — then dispatched as
        part of a stacked lane.  ``deadline`` is seconds from now on the
        frontend clock; a request whose deadline nears flushes its lane
        early, and a result produced after expiry fails the ticket with
        `DeadlineExceededError` (an SLO miss is a miss).  Higher
        ``priority`` lanes dispatch first; ties go deadline-soonest.
        ``seed=None`` uses the spec seed — the solo `refit` stream, so
        the coalesced result is bit-identical to an uncoalesced one.

        ``tenant`` names the paying tenant for multi-tenant serving:
        with an ``admission`` hook installed the request is charged
        against the tenant's quota (a typed rejection — e.g.
        `QuotaExceededError` — raises here, before the request takes a
        hold-queue slot) and dispatched under weighted-fair ordering;
        without one, the label still flows into per-tenant `stats()`
        counters and ``extras["tenant"]``.
        """
        spec = self.cluster if k is None \
            else dataclasses.replace(self.cluster, k=int(k))
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        if tenant is None and self.admission is not None:
            tenant = "default"
        if self.validate_inputs:
            try:
                validate_points(points, k=spec.k)
            except InvalidInputError:
                with self._lock:
                    self._stats["quarantined"] += 1
                    self._bump_tenant(tenant, "quarantined")
                raise
        if self.admission is not None:
            try:
                self.admission.admit(tenant)
            except BaseException:
                with self._lock:
                    self._stats["throttled"] += 1
                    self._bump_tenant(tenant, "throttled")
                raise
        n, d = np.shape(points)
        key = (spec, int(d),
               shape_bucket(int(n), min_bucket=self._min_bucket))
        with self._lock:
            if self.max_pending is not None:
                if self.backpressure == "block":
                    while self._held_count >= self.max_pending \
                            and not self._closed:
                        self._lock.wait()
                elif self._held_count >= self.max_pending:
                    self._stats["rejected"] += 1
                    self._bump_tenant(tenant, "rejected")
                    raise QueueFullError(
                        f"frontend hold queue full ({self.max_pending} "
                        "held); request rejected (backpressure='reject')")
            if self._closed:
                raise RuntimeError("frontend is closed")
            now = self._clock()
            ticket = FitTicket(
                index=self._next_index, cluster=spec, seed=seed, tag=tag,
                deadline=None if deadline is None else now + deadline)
            self._next_index += 1
            self._stats["submitted"] += 1
            self._bump_tenant(tenant, "submitted")
            self._held.setdefault(key, []).append(
                _Held(ticket, points, int(priority), now, tenant=tenant))
            self._held_count += 1
            self._lock.notify_all()
        return ticket

    def submit_extend(self, points, *, prepared: Any = None,
                      seed: Optional[int] = None, tag: Any = None,
                      deadline: Optional[float] = None,
                      tenant: Optional[str] = None) -> FitTicket:
        """Admit one streaming extend-then-refit request (no coalescing).

        Streaming mutations are one-shot and ordered, so they bypass
        the hold-and-batch window entirely: the request goes straight
        to `ClusterEngine.submit_extend`, which applies the extend to
        the streaming `PreparedData` on the solve worker (in submission
        order) and refits.  Admission bookkeeping matches `submit` —
        quarantine via `validate_points` (no ``k`` floor: an extend
        batch may be smaller than k), tenant quota/accounting when an
        ``admission`` hook is installed — and the settled ticket lands
        in the frontend ledger (``extends`` counts these separately).
        ``points=None`` refits the stream without mutating it (requires
        an explicit ``prepared`` handle; the drift-reseed path).
        """
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        if tenant is None and self.admission is not None:
            tenant = "default"
        if points is not None and self.validate_inputs:
            try:
                validate_points(points)
            except InvalidInputError:
                with self._lock:
                    self._stats["quarantined"] += 1
                    self._bump_tenant(tenant, "quarantined")
                raise
        if self.admission is not None:
            try:
                self.admission.admit(tenant)
            except BaseException:
                with self._lock:
                    self._stats["throttled"] += 1
                    self._bump_tenant(tenant, "throttled")
                raise
        with self._lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            self._stats["submitted"] += 1
            self._stats["extends"] += 1
            self._bump_tenant(tenant, "submitted")
            self._inflight += 1
        ticket = None
        try:
            ticket = self._engine.submit_extend(
                points, prepared=prepared, seed=seed, tag=tag,
                deadline=deadline)
        finally:
            if ticket is None:
                with self._lock:
                    self._stats["failed"] += 1
                    self._bump_tenant(tenant, "failed")
                    self._inflight -= 1
                    self._lock.notify_all()
        if self.admission is not None:
            self.admission.on_dispatch(tenant, 1)
        ticket.add_done_callback(
            lambda t, tenant=tenant: self._settle_extend(t, tenant))
        return ticket

    def _settle_extend(self, ticket: FitTicket,
                       tenant: Optional[str]) -> None:
        """Ledger a finished extend ticket (done-callback; no fan-out)."""
        exc = ticket.exception()
        with self._lock:
            if exc is None:
                self._stats["completed"] += 1
                self._bump_tenant(tenant, "completed")
            elif isinstance(exc, cf.CancelledError):
                self._stats["cancelled"] += 1
                self._bump_tenant(tenant, "cancelled")
            else:
                self._stats["failed"] += 1
                self._bump_tenant(tenant, "failed")
                if isinstance(exc, DeadlineExceededError):
                    self._stats["deadline_expired"] += 1
            self._inflight -= 1
            self._lock.notify_all()

    def _bump_tenant(self, tenant: Optional[str], counter: str,
                     queue_wait: Optional[float] = None) -> None:
        """Per-tenant ledger bump (lock held by the caller)."""
        if tenant is None:
            return
        rec = self._tenant_stats.get(tenant)
        if rec is None:
            rec = self._tenant_stats[tenant] = {
                "counters": collections.Counter(),
                "queue_wait": collections.deque(maxlen=_QW_WINDOW),
            }
        rec["counters"][counter] += 1
        if queue_wait is not None:
            rec["queue_wait"].append(queue_wait)

    def flush(self) -> None:
        """Dispatch everything currently held, without waiting for results.

        Returns once every request held at call time has been handed to
        the engine (their lanes are in the solve queue, in priority
        order).  Useful to drain a traffic lull or to make dispatch
        order deterministic in tests.
        """
        with self._lock:
            if self._held_count == 0 and not self._dispatching:
                return
            self._force_flush = True
            self._lock.notify_all()
            while self._held_count or self._dispatching:
                self._lock.wait()

    def as_completed(self, tickets: Iterable[FitTicket]
                     ) -> Iterator[FitTicket]:
        """Yield tickets as their results land (completion order)."""
        return self._engine.as_completed(tickets)

    @property
    def engine(self) -> ClusterEngine:
        """The backing `ClusterEngine` (owned or shared).

        The wire server uses this to reach the shared `ClusterPlan`
        (stream creation needs `plan.prepare_streaming`); a shared
        engine is still never closed by the frontend.
        """
        return self._engine

    # -- batcher ------------------------------------------------------------

    def _batch_loop(self) -> None:
        while True:
            ready: list = []
            with self._lock:
                now = self._clock()
                next_due: Optional[float] = None
                drain = self._force_flush or self._closed
                # How close to a deadline we dare hold a request: the
                # configured floor, or twice the observed lane service
                # time if that is worse.
                margin = max(self._margin_floor, 2.0 * self._service_ema)
                for key in list(self._held):
                    q = self._held[key]
                    reason, due = _flush_reason(
                        q, self.max_batch, self._max_wait, margin, drain,
                        now)
                    if reason is None:
                        if due is not None:
                            next_due = due if next_due is None \
                                else min(next_due, due)
                        continue
                    # Most-urgent members first, so an over-full bucket
                    # sends its priority/deadline traffic in the first
                    # lane out.
                    q.sort(key=_Held.sort_key)
                    while len(q) >= self.max_batch \
                            or (q and reason != "full"):
                        members, q[:] = q[:self.max_batch], \
                            q[self.max_batch:]
                        ready.append((key, members, reason))
                        self._held_count -= len(members)
                    if not q:
                        del self._held[key]
                if not ready:
                    self._force_flush = False
                    self._lock.notify_all()
                    if self._closed and self._held_count == 0:
                        return
                    if next_due is None:
                        self._lock.wait()
                    else:
                        self._lock.wait(timeout=max(next_due - now, 0.0))
                    continue
                self._dispatching = True
                self._lock.notify_all()    # blocked submitters: space freed
            # The engine solves in submission order, so dispatch order
            # here IS completion order.  Without an admission scheduler:
            # priority-first (ties deadline-soonest, then arrival).  With
            # one: weighted-fair virtual time across tenants dominates,
            # so a hot tenant's flood cannot starve a cold tenant's lane;
            # priority still orders lanes within one tenant (equal vt).
            if self.admission is None:
                ready.sort(key=lambda lane: min(
                    m.sort_key() for m in lane[1]))
            else:
                ready.sort(key=lambda lane: min(
                    (self.admission.virtual_time(m.tenant),)
                    + m.sort_key() for m in lane[1]))
            for key, members, reason in ready:
                self._dispatch(key, members, reason)
            with self._lock:
                self._dispatching = False
                self._lock.notify_all()

    def _dispatch(self, key: tuple, members: list, reason: str) -> None:
        """Hand one coalesced lane to the engine and arrange the fan-out."""
        spec = key[0]
        now = self._clock()
        live = []
        for m in members:
            if m.ticket.deadline is not None and m.ticket.deadline <= now:
                # Expired while held: fail it here rather than poison the
                # whole lane's engine deadline.
                self._resolve(m, error=DeadlineExceededError(
                    f"request {m.ticket.index} expired in the coalescing "
                    f"window by {now - m.ticket.deadline:.3f}s"))
                continue
            live.append(m)
        if not live:
            return
        deadlines = [m.ticket.deadline for m in live]
        lane_deadline = None if any(d is None for d in deadlines) \
            else max(d for d in deadlines) - now
        try:
            eng_ticket = self._engine.submit_lane(
                [m.points for m in live], cluster=spec,
                seeds=[m.ticket.seed for m in live],
                deadline=lane_deadline, tag=("lane",) + key[1:])
        except BaseException as e:  # noqa: BLE001 — forwarded per member
            for m in live:
                self._resolve(m, error=e)
            return
        if self.admission is not None:
            for m in live:
                self.admission.on_dispatch(m.tenant, 1)
        with self._lock:
            self._inflight += 1
            self._stats["lanes"] += 1
            self._stats["lane_members"] += len(live)
            if len(live) > 1:
                self._stats["coalesced"] += len(live)
            self._stats[f"flush_{reason}"] += 1
        eng_ticket.add_done_callback(
            lambda t, key=key, live=live, reason=reason, t0=now:
                self._fanout(t, key, live, reason, t0))

    def _fanout(self, eng_ticket: FitTicket, key: tuple, members: list,
                reason: str, t0: float) -> None:
        """Slice one finished lane back into per-request results."""
        now = self._clock()
        try:
            exc = eng_ticket.exception()
            if exc is not None:
                for m in members:
                    self._resolve(m, error=exc)
                return
            res = eng_ticket.result()
            for i, m in enumerate(members):
                try:
                    if m.ticket.deadline is not None \
                            and m.ticket.deadline <= now:
                        raise DeadlineExceededError(
                            f"request {m.ticket.index} missed its deadline "
                            f"by {now - m.ticket.deadline:.3f}s")
                    extras = dict(res.extras)
                    extras.update(
                        lane_size=len(members), lane_index=i, bucket=key[2],
                        queue_wait=t0 - m.arrival, flush_reason=reason)
                    if m.tenant is not None:
                        extras["tenant"] = m.tenant
                    out = FitResult(
                        indices=res.indices[i], centers=res.centers[i],
                        cost=res.cost[i], k=m.ticket.cluster.k,
                        prepare_seconds=res.prepare_seconds,
                        solve_seconds=res.solve_seconds, extras=extras)
                except BaseException as e:  # noqa: BLE001 — per-member fail
                    self._resolve(m, error=e)
                    continue
                self._resolve(m, result=out, queue_wait=t0 - m.arrival)
        finally:
            with self._lock:
                dur = now - t0
                self._service_ema = dur if self._service_ema == 0.0 \
                    else 0.8 * self._service_ema + 0.2 * dur
                self._inflight -= 1
                self._lock.notify_all()

    def _resolve(self, held: _Held, *, result: Optional[FitResult]
                 = None, error: Optional[BaseException] = None,
                 queue_wait: float = 0.0) -> None:
        """Settle one held request and bump exactly one ledger counter."""
        ticket = held.ticket
        if error is not None:
            with self._lock:
                if isinstance(error, cf.CancelledError):
                    self._stats["cancelled"] += 1
                    self._bump_tenant(held.tenant, "cancelled")
                else:
                    self._stats["failed"] += 1
                    self._bump_tenant(held.tenant, "failed")
                    if isinstance(error, DeadlineExceededError):
                        self._stats["deadline_expired"] += 1
            ticket._future.set_exception(error)
            return
        try:
            with self._lock:
                self._stats["completed"] += 1
                self._queue_wait_total += queue_wait
                q = self._qw_by_prio.get(held.priority)
                if q is None:
                    q = self._qw_by_prio[held.priority] = \
                        collections.deque(maxlen=_QW_WINDOW)
                q.append(queue_wait)
                self._bump_tenant(held.tenant, "completed",
                                  queue_wait=queue_wait)
            ticket._future.set_result(result)
        except BaseException as e:  # noqa: BLE001 — never strand a waiter
            ticket._future.set_exception(e)

    # -- introspection / lifecycle ------------------------------------------

    def stats(self) -> dict:
        """Serving ledger + coalescing metrics (and the engine's stats).

        Counters: ``submitted`` / ``completed`` / ``failed`` /
        ``cancelled`` always satisfy ``completed + failed + cancelled ==
        submitted`` once drained (``quarantined`` and ``rejected``
        requests raise at `submit` and never enter the ledger), plus
        ``lanes``, ``lane_members``, ``coalesced`` (members that shared
        a lane), per-reason ``flush_*`` counts, and ``deadline_expired``.
        Derived: ``mean_lane_occupancy``, ``coalesce_rate`` (fraction of
        dispatched members in lanes of size >= 2) and
        ``mean_queue_wait`` over completed requests.
        ``queue_wait_by_priority`` maps each priority class to
        p50/p90/p99/count over a bounded recent window of completed
        queue waits, and ``tenants`` maps each tenant label to its own
        counters plus the same percentile breakdown — both feed the wire
        STATS frame.  ``engine`` nests the owned/shared
        `ClusterEngine.stats()`.
        """
        with self._lock:
            s: dict = dict(self._stats)
            for key in ("submitted", "completed", "failed", "cancelled",
                        "rejected", "quarantined", "deadline_expired",
                        "lanes", "lane_members", "coalesced", "extends"):
                s.setdefault(key, 0)
            s["held"] = self._held_count
            s["inflight"] = self._inflight
            lanes = s.get("lanes", 0)
            members = s.get("lane_members", 0)
            s["mean_lane_occupancy"] = members / lanes if lanes else 0.0
            s["coalesce_rate"] = (s.get("coalesced", 0) / members
                                  if members else 0.0)
            s["mean_queue_wait"] = (self._queue_wait_total / s["completed"]
                                    if s["completed"] else 0.0)
            s["queue_wait_by_priority"] = {
                prio: _qw_summary(samples)
                for prio, samples in sorted(self._qw_by_prio.items())}
            s["tenants"] = {
                tenant: {**dict(rec["counters"]),
                         "queue_wait": _qw_summary(rec["queue_wait"])}
                for tenant, rec in sorted(self._tenant_stats.items())}
        s["engine"] = self._engine.stats()
        return s

    def close(self, cancel_pending: bool = False) -> None:
        """Stop admitting, drain (or cancel) held work, settle every ticket.

        Default: held requests are flushed as final lanes and their
        results fan out before `close` returns.  With
        ``cancel_pending=True`` held requests fail fast as cancelled
        (and, on an owned engine, queued lanes are cancelled too).  A
        shared engine is never closed — only this frontend's tickets
        are settled.  Idempotent.
        """
        with self._lock:
            if self._closed and not self._batcher.is_alive() \
                    and self._inflight == 0:
                return
            self._closed = True
            dropped: list = []
            if cancel_pending:
                for q in self._held.values():
                    dropped.extend(q)
                self._held.clear()
                self._held_count = 0
            self._lock.notify_all()
        for m in dropped:
            self._resolve(m, error=cf.CancelledError(
                "frontend closed with cancel_pending"))
        self._batcher.join()
        if self._own_engine:
            self._engine.close(cancel_pending=cancel_pending)
        with self._lock:
            while self._inflight:
                self._lock.wait()

    def __enter__(self) -> "ClusterFrontend":
        """Context manager entry: the frontend itself."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Drain and close on exit (cancel pending work on error)."""
        self.close(cancel_pending=exc_type is not None)
