"""Multi-tenant admission: token-bucket quotas + weighted-fair dequeue.

The wire layer (`repro_torch.serving.net.server`) exposes one `ClusterFrontend`
to many clients; without isolation, one hot tenant can (a) fill the
frontend's bounded hold queue so everyone else sees `QueueFullError`
backpressure, and (b) monopolise dispatch order so a cold tenant's
requests age out their SLOs behind the flood.  `TenantScheduler` closes
both holes, layered *on top of* the frontend's own `max_pending`
backpressure:

* **Admission quotas** — each tenant gets a token bucket
  (`TenantPolicy.rate_hz` sustained requests/sec, `burst` headroom).  A
  tenant over its rate is rejected at `submit()` with the typed
  `QuotaExceededError` (wire code ``WIRE_QUOTA_EXCEEDED``) before it can
  occupy a hold-queue slot — the hot tenant is capped, the global queue
  stays available to everyone else.
* **Weighted-fair dequeue** — among *admitted* work, ready lanes are
  ordered by stride-scheduling virtual time: each dispatch advances the
  tenant's virtual clock by ``1 / weight``, and the frontend drains the
  tenant with the smallest virtual time first (within a priority class).
  A tenant with weight 2 gets twice the dispatch share of a weight-1
  tenant under contention, and an idle tenant's first request never waits
  behind a backlog it did not create (its virtual clock is floored to the
  current minimum, not to zero credit accrued while idle).

The scheduler is clock-injectable and thread-safe; the frontend calls
`admit` on the submit path and `on_dispatch`/`virtual_time` from its
batcher thread (the duck-typed admission hook documented on
`ClusterFrontend`).  `parse_tenants` parses the launcher's ``--tenants``
CLI spec.  Semantics and worked examples: docs/net.md.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, Optional

from repro_torch.core import QueueFullError, register_wire_error
from repro_torch.core.resilience import WIRE_QUOTA_EXCEEDED

__all__ = [
    "QuotaExceededError",
    "TenantPolicy",
    "TenantScheduler",
    "parse_tenants",
]


class QuotaExceededError(QueueFullError):
    """A tenant exceeded its token-bucket admission quota (typed, wire-safe).

    Subclasses `QueueFullError` so existing backpressure handling (retry
    with backoff, shed load upstream) applies unchanged, but carries its
    own wire code so a client can distinguish "the service is full" from
    "slow *yourself* down".
    """

    def __init__(self, message: str, *, tenant: str = ""):
        super().__init__(message)
        self.tenant = tenant


register_wire_error(WIRE_QUOTA_EXCEEDED, QuotaExceededError)


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant admission contract: sustained rate, burst, fair share.

    ``rate_hz`` is the sustained admission rate (token refill; ``inf``
    disables metering), ``burst`` the bucket capacity (how far above the
    sustained rate a tenant may spike), ``weight`` the dispatch share
    under contention (stride scheduling: share is proportional to
    weight).
    """

    rate_hz: float = math.inf
    burst: float = 16.0
    weight: float = 1.0

    def __post_init__(self):
        if self.rate_hz <= 0:
            raise ValueError(f"rate_hz must be > 0, got {self.rate_hz}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


@dataclasses.dataclass
class _TenantState:
    """Mutable per-tenant book-keeping (guarded by the scheduler lock)."""

    policy: TenantPolicy
    tokens: float
    refilled_at: float
    vtime: float = 0.0
    admitted: int = 0
    throttled: int = 0
    dispatched: int = 0


class TenantScheduler:
    """Token-bucket admission + stride-scheduled fair dequeue, per tenant.

    ``policies`` maps tenant name to `TenantPolicy`; unknown tenants get
    ``default`` (pass ``default=None`` to *reject* unknown tenants with
    `QuotaExceededError` instead — a closed tenant roster).  All timing
    runs on the injectable monotonic ``clock``.

    This object implements the `ClusterFrontend` admission-hook protocol:
    ``admit(tenant)`` (raise to reject), ``virtual_time(tenant)`` (fair
    dequeue key — smaller drains first) and ``on_dispatch(tenant, n)``
    (charge a dispatched request).
    """

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 *, default: Optional[TenantPolicy] = TenantPolicy(),
                 clock: Callable[[], float] = time.monotonic):
        self.default = default
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {
            name: _TenantState(policy=policy, tokens=policy.burst,
                               refilled_at=clock())
            for name, policy in (policies or {}).items()
        }

    def _state(self, tenant: str) -> _TenantState:
        """The tenant's state, creating it under ``default`` (lock held)."""
        st = self._tenants.get(tenant)
        if st is None:
            if self.default is None:
                raise QuotaExceededError(
                    f"unknown tenant {tenant!r} (closed roster: no default "
                    f"policy)", tenant=tenant)
            # A newly-active tenant starts at the current minimum virtual
            # time: no banked credit from its idle past, no debt either.
            floor = min((s.vtime for s in self._tenants.values()),
                        default=0.0)
            st = _TenantState(policy=self.default, tokens=self.default.burst,
                              refilled_at=self._clock(), vtime=floor)
            self._tenants[tenant] = st
        return st

    def admit(self, tenant: str) -> None:
        """Charge one token; raise `QuotaExceededError` when the bucket is dry.

        The bucket refills continuously at ``rate_hz`` up to ``burst``;
        admission is O(1) and never blocks — over-rate traffic is
        rejected typed and immediately so the client's retry policy (not
        a server queue) absorbs the excess.
        """
        with self._lock:
            st = self._state(tenant)
            rate = st.policy.rate_hz
            if not math.isinf(rate):
                now = self._clock()
                st.tokens = min(st.policy.burst,
                                st.tokens + (now - st.refilled_at) * rate)
                st.refilled_at = now
                if st.tokens < 1.0:
                    st.throttled += 1
                    raise QuotaExceededError(
                        f"tenant {tenant!r} over admission quota "
                        f"({rate:g} req/s sustained, burst "
                        f"{st.policy.burst:g})", tenant=tenant)
                st.tokens -= 1.0
            st.admitted += 1

    def virtual_time(self, tenant: str) -> float:
        """The tenant's stride-scheduling clock (smaller = drains first)."""
        with self._lock:
            return self._state(tenant).vtime

    def on_dispatch(self, tenant: str, n: int = 1) -> None:
        """Charge ``n`` dispatched requests: advance vtime by ``n/weight``."""
        with self._lock:
            st = self._state(tenant)
            st.vtime += n / st.policy.weight
            st.dispatched += n

    def stats(self) -> dict:
        """Per-tenant admission/dispatch counters (feeds the STATS frame)."""
        with self._lock:
            return {
                name: {
                    "admitted": st.admitted,
                    "throttled": st.throttled,
                    "dispatched": st.dispatched,
                    "virtual_time": st.vtime,
                    "weight": st.policy.weight,
                    "rate_hz": (None if math.isinf(st.policy.rate_hz)
                                else st.policy.rate_hz),
                }
                for name, st in self._tenants.items()
            }


def parse_tenants(spec: str) -> Dict[str, TenantPolicy]:
    """Parse the launcher's ``--tenants`` spec into policy objects.

    Format: comma-separated ``name[:rate_hz[:burst[:weight]]]`` entries,
    e.g. ``"bulk:50:100:1,interactive:200:40:4"``.  Omitted fields take
    the `TenantPolicy` defaults; ``rate_hz`` of ``inf`` disables metering
    for that tenant.
    """
    policies: Dict[str, TenantPolicy] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        parts = entry.split(":")
        name = parts[0]
        if not name or len(parts) > 4:
            raise ValueError(f"bad --tenants entry {entry!r} "
                             "(want name[:rate_hz[:burst[:weight]]])")
        kwargs: dict = {}
        for key, raw in zip(("rate_hz", "burst", "weight"), parts[1:]):
            kwargs[key] = float(raw)
        policies[name] = TenantPolicy(**kwargs)
    return policies
