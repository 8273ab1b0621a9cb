"""Fault-tolerance primitives for the serving pipeline, as in the JAX
package's `core/resilience.py` (the same names, wire codes and fault
decisions).

The async `ClusterEngine` (core/engine.py) turns the plan/execute split
into a request pipeline; this module is what keeps that pipeline alive
under real traffic:

* **Admission control** — `validate_points` quarantines NaN/Inf/empty/
  degenerate datasets at `submit()` with a typed `InvalidInputError`
  before they can poison a worker; `QueueFullError` is the typed
  backpressure rejection for a bounded submit queue.
* **Deadlines & retries** — `RetryPolicy` (max attempts, exponential
  backoff, deterministic jitter) plus `attempt_seed`, which folds the
  attempt index into the solve seed so a re-solve never replays an rng
  stream; `DeadlineExceededError` is the typed per-request SLO expiry.
* **Failure classification** — `classify_failure` splits exceptions into
  ``"transient"`` (worth a retry / a fallback: a CUDA out-of-memory,
  connection resets, injected transient faults) and ``"permanent"``
  (caller bugs: ValueError, TypeError, quarantine rejections; a CUDA
  context that a fault has poisoned).
* **Graceful degradation** — `CircuitBreaker` per (seeder, backend)
  target with `OK / DEGRADED / OPEN` health states, and `fallback_chain`,
  which walks the registry-declared degradation ladder (backends
  ``device → cpu``, seeders along `SeederSpec.fallback`, e.g.
  ``rejection → kmeans|| → kmeans++``).  Degrading is *correctness
  preserving*: the paper's rejection sampler and the k-means|| / plain
  k-means++ baselines all carry the same O(log k) approximation
  guarantee, so a fallback serves a slower-but-certain answer from the
  same law rather than an error.
* **Deterministic chaos** — `FaultPlan` injects seeded per-stage
  failures and latency into `prepare_data` / `fit_prepared`.  Decisions
  are a pure hash of (seed, stage, key, per-key call count), so a chaos
  run is reproducible regardless of thread interleaving; the chaos tests
  (tests/test_torch_resilience.py) and `chip_smoke.py`'s engine phase are
  driven by it.

See docs/resilience.md for the end-to-end semantics (the JAX package's,
the ``sharded → device → cpu`` ladder included).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.registry import BACKENDS, SEEDER_SPECS
from repro_torch.kernels._check import CudaLaunchError

__all__ = [
    "BACKEND_FALLBACKS",
    "CircuitBreaker",
    "CircuitBreakerPolicy",
    "DeadlineExceededError",
    "FaultPlan",
    "InjectedFault",
    "InvalidInputError",
    "QueueFullError",
    "RemoteError",
    "RetryPolicy",
    "ServiceUnavailableError",
    "attempt_seed",
    "classify_failure",
    "exception_from_wire",
    "exception_to_wire",
    "fallback_chain",
    "register_wire_error",
    "validate_points",
]


# ---------------------------------------------------------------------------
# Typed errors.
# ---------------------------------------------------------------------------

class InvalidInputError(ValueError):
    """Quarantined at admission: the dataset can never solve (permanent).

    Raised synchronously by `ClusterEngine.submit` (no ticket is created,
    no worker ever sees the data) for NaN/Inf values, empty or
    wrongly-shaped arrays, non-numeric dtypes, and degenerate requests
    (fewer points than centers).
    """


class QueueFullError(RuntimeError):
    """The bounded submit queue is full (typed backpressure signal).

    Raised synchronously under the ``"reject"`` policy; set as the
    exception of the *oldest pending* ticket under ``"shed-oldest"``.
    """


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before a result was served."""


class ServiceUnavailableError(RuntimeError):
    """Every target in the fallback chain has an open circuit breaker."""


class InjectedFault(RuntimeError):
    """A failure injected by a `FaultPlan` (chaos testing only).

    ``transient`` controls how `classify_failure` buckets it, so one
    fault plan exercises both the retry/fallback path and the typed
    permanent-error path.
    """

    def __init__(self, message: str, *, transient: bool = True,
                 stage: str = "", key: str = ""):
        super().__init__(message)
        self.transient = transient
        self.stage = stage
        self.key = key


# ---------------------------------------------------------------------------
# Wire-safe error serialization.
# ---------------------------------------------------------------------------

class RemoteError(RuntimeError):
    """A failure that crossed the wire without a registered typed twin.

    `exception_from_wire` reconstructs registered codes as their typed
    exception (so a client catches `DeadlineExceededError` exactly as an
    in-process caller would); anything else — internal server errors,
    codes from a newer protocol revision — lands here with the original
    ``code`` preserved for logging/metrics.
    """

    def __init__(self, message: str, *, code: int = 0):
        super().__init__(message)
        self.code = code


#: Stable wire codes for the serving error taxonomy.  Codes are part of
#: the protocol contract (docs/net.md): never renumber, only append.
WIRE_INVALID_INPUT = 1
WIRE_QUEUE_FULL = 2
WIRE_DEADLINE_EXCEEDED = 3
WIRE_SERVICE_UNAVAILABLE = 4
WIRE_CANCELLED = 5
WIRE_PROTOCOL_ERROR = 6         # malformed/unsupported frame (protocol.py)
WIRE_INTERNAL = 7               # unregistered exception type
WIRE_QUOTA_EXCEEDED = 8         # registered by repro_torch.serving.net.tenancy

_WIRE_BY_TYPE: dict = {}        # exc type -> code (most-derived wins)
_WIRE_BY_CODE: dict = {}        # code -> exc type


def register_wire_error(code: int, exc_type: type) -> None:
    """Bind an exception type to a stable wire code (both directions).

    Later layers (e.g. `repro_torch.serving.net.tenancy`'s quota error) extend
    the taxonomy without core importing them.  Re-registering a code with
    a different type is an error — wire codes are a published contract.
    """
    if not (isinstance(exc_type, type)
            and issubclass(exc_type, BaseException)):
        raise TypeError(f"not an exception type: {exc_type!r}")
    bound = _WIRE_BY_CODE.get(code)
    if bound is not None and bound is not exc_type:
        raise ValueError(
            f"wire code {code} already bound to {bound.__name__}")
    _WIRE_BY_CODE[code] = exc_type
    _WIRE_BY_TYPE[exc_type] = code


register_wire_error(WIRE_INVALID_INPUT, InvalidInputError)
register_wire_error(WIRE_QUEUE_FULL, QueueFullError)
register_wire_error(WIRE_DEADLINE_EXCEEDED, DeadlineExceededError)
register_wire_error(WIRE_SERVICE_UNAVAILABLE, ServiceUnavailableError)
register_wire_error(WIRE_CANCELLED, cf.CancelledError)


def exception_to_wire(exc: BaseException) -> tuple:
    """``(code, message)`` for an exception, walking its MRO.

    A subclass of a registered type serializes as its nearest registered
    ancestor (the *taxonomy* crosses the wire, not the class hierarchy);
    unregistered types become `WIRE_INTERNAL` — the message still crosses,
    typed retry/backpressure semantics do not.
    """
    for klass in type(exc).__mro__:
        code = _WIRE_BY_TYPE.get(klass)
        if code is not None:
            return code, str(exc)
    return WIRE_INTERNAL, f"{type(exc).__name__}: {exc}"


def exception_from_wire(code: int, message: str) -> BaseException:
    """Reconstruct the typed exception for a wire ``(code, message)``.

    Registered codes come back as their exact type — `classify_failure`,
    retry policies and caller except-clauses treat a remote failure
    exactly like a local one.  Unregistered codes come back as
    `RemoteError` with the code attached.
    """
    exc_type = _WIRE_BY_CODE.get(code)
    if exc_type is None:
        return RemoteError(message, code=code)
    return exc_type(message)


# ---------------------------------------------------------------------------
# Failure classification.
# ---------------------------------------------------------------------------

_TRANSIENT_TYPES = (MemoryError, ConnectionError, TimeoutError, OSError)
_PERMANENT_TYPES = (ValueError, TypeError, KeyError, AssertionError,
                    NotImplementedError)

#: ``cudaErrorMemoryAllocation``: the launch could not get its memory, and
#: the context is intact.
_CUDA_ERROR_MEMORY_ALLOCATION = 2


def _cuda_failure(exc: BaseException) -> Optional[str]:
    """``"transient"``/``"permanent"`` for a CUDA failure, else None."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "transient"
    if isinstance(exc, CudaLaunchError):
        return ("transient" if exc.code == _CUDA_ERROR_MEMORY_ALLOCATION
                else "permanent")
    return None


def classify_failure(exc: BaseException) -> str:
    """Bucket an exception as ``"transient"`` or ``"permanent"``.

    Transient failures are worth retrying or serving from a fallback
    target: injected faults flagged transient, CUDA failures that leave
    the context usable (below), and host-level MemoryError / OSError /
    ConnectionError / TimeoutError.  Permanent failures are request or
    caller bugs (ValueError, TypeError, quarantine rejections) — retrying
    cannot help and MUST NOT feed the circuit breaker, or a single bad
    request could open the circuit for healthy traffic.  Unknown
    exception types default to permanent (no retry storms on logic
    bugs).

    The port's CUDA failures (the JAX package keys on XLA's runtime
    errors instead):

    * ``torch.cuda.OutOfMemoryError`` (a `RuntimeError`) is transient:
      an allocation failed, the context did not, and a retry or another
      target can succeed once memory is released.
    * A kernel binding's `CudaLaunchError` (a `RuntimeError` that
      carries the launch's ``cudaError_t`` as `code`) is transient for
      code 2 (``cudaErrorMemoryAllocation``) and permanent for every
      other code.  The other launch errors are sticky context errors
      (700, an illegal address; 719, a launch failure) or programming
      errors: after a sticky one every later launch in the process
      fails, so neither a retry nor another target on the same card can
      help.
    """
    flagged = getattr(exc, "transient", None)
    if flagged is not None:
        return "transient" if flagged else "permanent"
    if isinstance(exc, InvalidInputError):
        return "permanent"
    cuda = _cuda_failure(exc)
    if cuda is not None:
        return cuda
    if isinstance(exc, _PERMANENT_TYPES):
        return "permanent"
    if isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    return "permanent"


# ---------------------------------------------------------------------------
# Input quarantine.
# ---------------------------------------------------------------------------

def validate_points(points, *, k: Optional[int] = None) -> None:
    """Admission-control check: raise `InvalidInputError` for bad data.

    Rejects non-arrays, wrong rank (must be ``(n, d)``), empty axes,
    non-numeric dtypes, NaN/Inf values, and — when ``k`` is given —
    degenerate requests with fewer points than centers.  Runs on the
    caller's thread at `submit()` so a poisoned dataset fails fast and
    typed instead of asynchronously killing a pipeline worker.
    """
    try:
        arr = np.asarray(points)
    except Exception as e:
        raise InvalidInputError(f"points not array-like: {e!r}") from e
    if arr.ndim != 2:
        raise InvalidInputError(
            f"points must be 2-D (n, d), got shape {arr.shape}")
    n, d = arr.shape
    if n == 0 or d == 0:
        raise InvalidInputError(f"points must be non-empty, got {arr.shape}")
    if arr.dtype.kind not in "fiu":
        raise InvalidInputError(
            f"points must be numeric, got dtype {arr.dtype}")
    if arr.dtype.kind == "f" and not bool(np.isfinite(arr).all()):
        bad = int(arr.size - np.isfinite(arr).sum())
        raise InvalidInputError(
            f"points contain {bad} non-finite value(s) (NaN/Inf)")
    if k is not None and n < k:
        raise InvalidInputError(
            f"degenerate request: {n} point(s) for k={k} centers")


# ---------------------------------------------------------------------------
# Retries.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-request retry budget with exponential backoff and jitter.

    ``max_attempts`` counts *total* attempts (1 = no retries).  The delay
    before attempt ``a`` (1-based retry index) is
    ``backoff * multiplier**(a-1) + jitter * u`` where ``u`` is a
    deterministic uniform derived from the request seed — reproducible
    chaos runs need reproducible sleeps.  Only failures classified
    transient are retried; permanent errors surface immediately.
    """

    max_attempts: int = 3
    backoff: float = 0.0
    multiplier: float = 2.0
    jitter: float = 0.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff < 0 or self.jitter < 0 or self.multiplier <= 0:
            raise ValueError("backoff/jitter must be >= 0, multiplier > 0")

    def delay(self, attempt: int, *, seed: int = 0) -> float:
        """Seconds to sleep before retry ``attempt`` (1-based)."""
        base = self.backoff * self.multiplier ** (attempt - 1)
        if self.jitter:
            u = _uniform(f"retry-jitter/{seed}/{attempt}")
            base += self.jitter * u
        return base


NO_RETRY = RetryPolicy(max_attempts=1)


def attempt_seed(base: Optional[int], attempt: int) -> Optional[int]:
    """The solve seed for retry ``attempt`` (0 = first try).

    Attempt 0 keeps ``base`` untouched (``None`` preserves the plan's
    replay-the-prepare-snapshot semantics, so the happy path stays
    bit-identical to a serial fit).  Every later attempt folds the
    attempt index into a `numpy.random.SeedSequence`, so no two attempts
    — and no attempt and its primary — ever share an rng stream.
    """
    if attempt == 0:
        return base
    entropy = [0 if base is None else int(base) & 0xFFFFFFFF, int(attempt)]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


# ---------------------------------------------------------------------------
# Circuit breaker.
# ---------------------------------------------------------------------------

#: Health states a breaker (and `engine.stats()["health"]`) reports.
OK, DEGRADED, OPEN = "OK", "DEGRADED", "OPEN"


@dataclasses.dataclass(frozen=True)
class CircuitBreakerPolicy:
    """When to open a (seeder, backend) circuit and when to re-probe.

    ``failure_threshold`` consecutive transient failures open the
    circuit; after ``cooldown_s`` seconds the next request is let through
    as a probe (state `DEGRADED`): success re-closes the circuit,
    failure re-opens it for another cooldown.
    """

    failure_threshold: int = 3
    cooldown_s: float = 30.0

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, "
                f"got {self.failure_threshold}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")


class CircuitBreaker:
    """Consecutive-transient-failure breaker for one (seeder, backend).

    States map onto the health the engine surfaces: `OK` (closed —
    serving normally), `OPEN` (failing — requests short-circuit to the
    fallback chain until the cooldown elapses), `DEGRADED` (half-open —
    a probe request is in flight; its outcome decides OK vs. OPEN).
    ``clock`` is injectable so tests drive the cooldown deterministically.
    """

    def __init__(self, policy: Optional[CircuitBreakerPolicy] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy if policy is not None else CircuitBreakerPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        with self._lock:
            self._state = OK
            self._failures = 0
            self._opened_at = 0.0

    @property
    def state(self) -> str:
        """Current health state (`OK` / `DEGRADED` / `OPEN`)."""
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request be sent to this target right now?

        `OPEN` returns False until the cooldown elapses, then flips to
        `DEGRADED` and admits the caller as the recovery probe.
        """
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.policy.cooldown_s:
                    self._state = DEGRADED
                    return True
                return False
            return True

    def record_success(self) -> None:
        """A solve succeeded: reset the failure run, re-close the circuit."""
        with self._lock:
            self._state = OK
            self._failures = 0

    def record_failure(self) -> None:
        """A *transient* solve failure: count it, maybe open the circuit."""
        with self._lock:
            self._failures += 1
            probe_failed = self._state == DEGRADED
            if probe_failed or \
                    self._failures >= self.policy.failure_threshold:
                self._state = OPEN
                self._opened_at = self._clock()


# ---------------------------------------------------------------------------
# Registry-declared degradation ladder.
# ---------------------------------------------------------------------------

#: Backend degradation ladder: mesh -> single device -> faithful CPU.
BACKEND_FALLBACKS = {"sharded": "device", "device": "cpu"}


def _backend_ladder(backend: str) -> list[str]:
    ladder = [backend]
    while ladder[-1] in BACKEND_FALLBACKS:
        ladder.append(BACKEND_FALLBACKS[ladder[-1]])
    return ladder


def fallback_chain(seeder: str, backend: str) -> list[tuple[str, str]]:
    """Degradation targets for a failing (seeder, backend), in order.

    Walks the backend ladder (``sharded → device → cpu``) for the current
    seeder first, then moves down the registry-declared seeder chain
    (`SeederSpec.fallback`, e.g. ``rejection → kmeans|| → kmeans++``)
    re-trying each seeder's ladder.  Only registered (seeder, backend)
    pairs are returned and the primary pair itself is excluded, so the
    engine can iterate the result directly.  All chained seeders share
    the O(log k) guarantee, which is what makes this degradation
    correctness-preserving rather than best-effort.
    """
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; expected {BACKENDS}")
    seeders, seen_seeders = [], set()
    name: Optional[str] = seeder
    while name is not None and name in SEEDER_SPECS \
            and name not in seen_seeders:
        seeders.append(name)
        seen_seeders.add(name)
        name = getattr(SEEDER_SPECS[name], "fallback", None)
    chain = []
    for s in seeders:
        for b in _backend_ladder(backend):
            if (s, b) == (seeder, backend):
                continue
            if b in SEEDER_SPECS[s].impls:
                chain.append((s, b))
    return chain


# ---------------------------------------------------------------------------
# Deterministic fault injection.
# ---------------------------------------------------------------------------

def _uniform(material: str) -> float:
    """A deterministic uniform in [0, 1) from a string (blake2b hash)."""
    digest = hashlib.blake2b(material.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


class FaultPlan:
    """Seeded, deterministic failure/latency injection for chaos testing.

    A plan is handed to `ClusterPlan(..., fault_plan=...)` (the
    `ClusterEngine` forwards its own to every plan it builds) and its
    `inject` hook runs at the top of the prepare build and the solve.
    Each (stage, key) pair keeps a call counter, and the fail/pass
    decision is a pure blake2b hash of ``(seed, stage, key, count)`` —
    deterministic regardless of thread interleaving, so a chaos run with
    a fixed seed replays exactly.

    ``prepare_failure_rate`` / ``solve_failure_rate`` are per-call
    failure probabilities; ``permanent_rate`` is the fraction of injected
    failures flagged permanent (the rest are transient, i.e. retryable);
    ``prepare_latency_s`` / ``solve_latency_s`` sleep before the
    decision (slow-backend simulation for deadline tests).  ``match``
    restricts injection to keys containing the substring — keys are
    ``"<seeder>/<backend>/<stage>/<fingerprint>..."``, so chaos can
    target one (seeder, backend) while its fallbacks stay healthy.
    ``max_failures_per_key`` / ``max_failures`` cap injected failures
    per key / in total, modelling transient faults that heal (retry and
    breaker-recovery tests rely on this).
    """

    def __init__(self, seed: int = 0, *,
                 prepare_failure_rate: float = 0.0,
                 solve_failure_rate: float = 0.0,
                 prepare_latency_s: float = 0.0,
                 solve_latency_s: float = 0.0,
                 permanent_rate: float = 0.0,
                 match: Optional[str] = None,
                 max_failures_per_key: Optional[int] = None,
                 max_failures: Optional[int] = None):
        for name, rate in (("prepare_failure_rate", prepare_failure_rate),
                           ("solve_failure_rate", solve_failure_rate),
                           ("permanent_rate", permanent_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.prepare_failure_rate = prepare_failure_rate
        self.solve_failure_rate = solve_failure_rate
        self.prepare_latency_s = prepare_latency_s
        self.solve_latency_s = solve_latency_s
        self.permanent_rate = permanent_rate
        self.match = match
        self.max_failures_per_key = max_failures_per_key
        self.max_failures = max_failures
        self._lock = threading.Lock()
        with self._lock:
            self._counts: dict = {}
            self._injected = 0

    def stats(self) -> dict:
        """Injection counters (total injected failures, distinct keys)."""
        with self._lock:
            return {"injected": self._injected, "keys": len(self._counts)}

    def inject(self, stage: str, key: str) -> None:
        """Maybe sleep, maybe raise an `InjectedFault` for this call.

        ``stage`` is ``"prepare"`` or ``"solve"``; ``key`` identifies the
        call site (seeder/backend/fingerprint[:seed]).  Deterministic in
        (seed, stage, key, per-key call count).
        """
        if stage == "prepare":
            rate, latency = self.prepare_failure_rate, self.prepare_latency_s
        elif stage == "solve":
            rate, latency = self.solve_failure_rate, self.solve_latency_s
        else:
            raise ValueError(f"unknown fault stage {stage!r}")
        if self.match is not None and self.match not in key:
            return
        if latency > 0:
            time.sleep(latency)
        if rate <= 0:
            return
        with self._lock:
            count = self._counts.get((stage, key), 0)
            self._counts[(stage, key)] = count + 1
            if self.max_failures is not None \
                    and self._injected >= self.max_failures:
                return
            if self.max_failures_per_key is not None \
                    and count >= self.max_failures_per_key:
                return
            material = f"{self.seed}/{stage}/{key}/{count}"
            if _uniform(material) >= rate:
                return
            self._injected += 1
            transient = _uniform("perm:" + material) >= self.permanent_rate
        raise InjectedFault(
            f"injected {'transient' if transient else 'permanent'} "
            f"{stage} fault (key={key!r}, call={count})",
            transient=transient, stage=stage, key=key)
