"""What the benchmark may not load: JAX, its libraries, the JAX package
and the JAX benchmark.  Names are compared by their top-level part (before
the first dot) as a whole, so `repro_torch` passes and `repro.core` does
not."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    return sorted(n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN)
