"""Steady-state accounting: the port's counterpart of the JAX package's
trace counters, with its names and semantics.

The JAX package counts jit traces (keys ``"<seeder>/device"`` and the
shard_map seeders' bare names): a repeated fit with the same static
configuration must reuse its compiled program.  Eager PyTorch traces
nothing, so those keys have no counterpart here.  What must not repeat in
a steady state is a kernel library's build or load: `kernels/_build.py`
counts one ``"build/<source>"`` event each time it builds or loads the
library of ``csrc/<source>.cu``, which happens once per process.  So after
one warm-up fit, further fits leave every counter untouched, and
`no_retrace()` turns any counted event into a `RetraceError`.
"""

from __future__ import annotations

import collections
import contextlib

__all__ = ["TRACE_COUNTS", "count_trace", "no_retrace", "RetraceError"]

TRACE_COUNTS: collections.Counter = collections.Counter()


def count_trace(name: str) -> None:
    """Record one event of `name` (a kernel library's build or load)."""
    TRACE_COUNTS[name] += 1


class RetraceError(AssertionError):
    """A counted event happened inside a `no_retrace()` block.

    Subclasses AssertionError: it is a violated invariant, not an
    environmental failure.
    """

    def __init__(self, deltas: dict):
        self.deltas = dict(deltas)
        detail = ", ".join(f"{k}: +{v}" for k, v in sorted(deltas.items()))
        super().__init__(
            f"unexpected build(s) inside no_retrace() block: {detail}. "
            "A steady state must reuse the kernel libraries already "
            "built and loaded.")


@contextlib.contextmanager
def no_retrace(*, watch: tuple = (), allow: tuple = ()):
    """Context manager turning counted events into a `RetraceError`.

    Snapshots `TRACE_COUNTS` on entry and compares on exit: any counter
    that grew (first-ever events included) raises.  Run one warm-up fit
    before the block, then wrap the steady state::

        plan.fit(points)           # warm-up: builds and loads the kernels
        with no_retrace():
            plan.refit(seed=1)     # must reuse them

    `watch` narrows the guard to names with any of the given prefixes;
    `allow` exempts names with any of the given prefixes (`allow` wins).
    The check runs only on a clean exit: an exception inside the block
    propagates unwrapped.
    """
    before = dict(TRACE_COUNTS)
    yield
    after = dict(TRACE_COUNTS)
    deltas = {}
    for name in set(before) | set(after):
        if watch and not any(name.startswith(p) for p in watch):
            continue
        if allow and any(name.startswith(p) for p in allow):
            continue
        grew = after.get(name, 0) - before.get(name, 0)
        if grew > 0:
            deltas[name] = grew
    if deltas:
        raise RetraceError(deltas)
