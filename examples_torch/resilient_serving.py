"""Fault-tolerant serving demo: the `ClusterEngine` resilience surface.

    PYTHONPATH=src python examples_torch/resilient_serving.py [--smoke] \
        [--backend device|cpu] [--device cuda|cpu]

The port's copy of `examples/resilient_serving.py`, with its options and
output lines: a tour of docs/resilience.md on a synthetic request stream,
chaos-driven by a seeded `FaultPlan` so every run replays identically:

  1. input quarantine — a NaN-poisoned dataset fails typed at submit();
  2. backpressure — a bounded queue shedding the oldest request;
  3. deadlines — a request with a too-tight SLO expires typed;
  4. retries — injected transient solve faults healed on fresh rng
     streams (`extras["attempts"]` > 1);
  5. graceful degradation — a persistently failing primary served from
     the registry-declared fallback chain, bit-identical to a direct
     solo fit on the fallback target;
  6. the terminal-state ledger — `stats()` books balance, per-target
     circuit health.

The JAX script runs fastkmeans++ on the cpu backend so that the demo is
seconds-sized.  This copy takes `--backend`: ``device`` (the default)
solves with the hand-written kernels on the card, ``cpu`` with the NumPy
seeders (the JAX script's run).  An engine on the card skips the
fallback chain's cpu rungs, and fastkmeans++'s chain has no other, so
the device backend's primary is rejection (its chain falls to k-means||
on the device); the cpu backend's is fastkmeans++.  `--device` defaults to ``cuda`` and raises without
CUDA; ``--device cpu`` runs the kernels' plain versions.  `main(argv)`
returns the numbers it prints.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (smaller datasets, same coverage)")
    ap.add_argument("--backend", choices=("device", "cpu"), default="device",
                    help="'device' (the kernels) or 'cpu' (NumPy seeders)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without CUDA) or "
                         "'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.k, args.requests = 1000, 8, 6

    from repro_torch.core import (
        ClusterEngine,
        ClusterPlan,
        ClusterSpec,
        DeadlineExceededError,
        ExecutionSpec,
        FaultPlan,
        InvalidInputError,
        QueueFullError,
        RetryPolicy,
    )
    from repro_torch.core.plan import resolve_device

    resolve_device(args.device)
    out: dict = {}

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(32, args.d)) * 25

    def make_dataset():
        return (centers[rng.integers(32, size=args.n)]
                + rng.normal(size=(args.n, args.d)))

    seeder = "rejection" if args.backend == "device" else "fastkmeans++"
    spec = ClusterSpec(k=args.k, seeder=seeder, seed=0)
    exe = ExecutionSpec(backend=args.backend, device=args.device)
    primary = f"{spec.seeder}/{exe.backend}"

    # ---- 1. quarantine: bad data fails typed, synchronously ---------------
    print("1. input quarantine")
    with ClusterEngine(spec, exe) as engine:
        poisoned = make_dataset()
        poisoned[3, 1] = np.nan
        try:
            engine.submit(poisoned)
        except InvalidInputError as e:
            print(f"   submit() raised InvalidInputError: {e}")
        st = engine.stats()
        print(f"   quarantined={st['quarantined']}, "
              f"submitted={st['submitted']} "
              f"(no ticket, no worker ever saw the data)")
    out["quarantine"] = {"quarantined": st["quarantined"],
                         "submitted": st["submitted"]}

    # ---- 2. backpressure: bounded queue, shed-oldest ----------------------
    print("2. backpressure (max_pending=1, shed-oldest)")
    slow = FaultPlan(seed=0, solve_latency_s=0.2)
    with ClusterEngine(spec, exe, fault_plan=slow, max_pending=1,
                       backpressure="shed-oldest") as engine:
        tickets = [engine.submit(make_dataset()) for _ in range(4)]
        outcomes = []
        for t in tickets:
            exc = t.exception()
            outcomes.append("shed" if isinstance(exc, QueueFullError)
                            else "served" if exc is None else repr(exc))
        st = engine.stats()
        print(f"   4 submits -> {outcomes}  "
              f"(shed={st['shed']}, completed={st['completed']})")
    out["backpressure"] = {"outcomes": outcomes, "shed": st["shed"],
                           "completed": st["completed"]}

    # ---- 3. deadlines: a too-tight SLO expires typed ----------------------
    print("3. per-request deadlines")
    with ClusterEngine(spec, exe, fault_plan=slow) as engine:
        urgent = engine.submit(make_dataset(), deadline=0.05)
        relaxed = engine.submit(make_dataset(), deadline=30.0)
        exc = urgent.exception()
        assert isinstance(exc, DeadlineExceededError), exc
        print(f"   50ms SLO: DeadlineExceededError ({exc})")
        attempts = relaxed.result().extras["attempts"]
        expired = engine.stats()["deadline_expired"]
        print(f"   30s SLO:  served in "
              f"{attempts} attempt(s); "
              f"deadline_expired={expired}")
    out["deadlines"] = {"attempts": attempts, "deadline_expired": expired}

    # ---- 4. retries: transient faults healed on fresh rng streams --------
    print("4. transient-failure retries")
    healing = FaultPlan(seed=1, solve_failure_rate=1.0, match=primary,
                        max_failures_per_key=1)   # first attempt fails, heals
    with ClusterEngine(spec, exe, fault_plan=healing,
                       retry=RetryPolicy(max_attempts=3)) as engine:
        res = engine.submit(make_dataset()).result()
        print(f"   served_by={res.extras['served_by']} after "
              f"{res.extras['attempts']} attempts "
              f"(retries={engine.stats()['retries']}; each retry solves "
              f"on an attempt-derived rng stream)")
        out["retries"] = {"served_by": res.extras["served_by"],
                          "attempts": res.extras["attempts"],
                          "retries": engine.stats()["retries"]}

    # ---- 5. degradation: a dead primary served from the fallback chain ---
    print("5. graceful degradation")
    dead = FaultPlan(seed=2, solve_failure_rate=1.0, match=primary)
    pts = make_dataset()
    with ClusterEngine(spec, exe, fault_plan=dead,
                       retry=RetryPolicy(max_attempts=2)) as engine:
        res = engine.submit(pts).result()
        st = engine.stats()
    # the fallback target's own backend: an engine on the card skips the
    # chain's cpu rungs, so it is the primary's there
    seeder, backend = res.extras["served_by"].split("/")
    direct = ClusterPlan(
        spec.replace(seeder=seeder),
        ExecutionSpec(backend=backend, device=args.device)).fit(pts)
    identical = bool(np.array_equal(np.asarray(res.indices.cpu()),
                                    np.asarray(direct.indices.cpu())))
    print(f"   primary {primary} kept failing -> served_by="
          f"{res.extras['served_by']} via path "
          f"{res.extras['fallback_path']}")
    print(f"   bit-identical to a direct solo fit on the fallback: "
          f"{identical}")
    out["degradation"] = {"served_by": res.extras["served_by"],
                          "fallback_path": res.extras["fallback_path"],
                          "identical": identical}

    # ---- 6. the ledger: chaos stream, books balance -----------------------
    print(f"6. chaos stream ({args.requests} requests, 35% injected "
          f"transient solve faults)")
    chaos = FaultPlan(seed=3, solve_failure_rate=0.35, match=primary)
    with ClusterEngine(spec, exe, fault_plan=chaos,
                       retry=RetryPolicy(max_attempts=3)) as engine:
        tickets = [engine.submit(make_dataset(), deadline=60.0)
                   for _ in range(args.requests)]
        for t in engine.as_completed(tickets):
            t.exception()      # drain; terminal state guaranteed
        st = engine.stats()
    print(f"   submitted={st['submitted']} completed={st['completed']} "
          f"failed={st['failed']} cancelled={st['cancelled']} "
          f"(injected={chaos.stats()['injected']}, "
          f"retries={st['retries']}, "
          f"fallback_served={st['fallback_served']})")
    print(f"   health={st['health']}")
    assert st["completed"] + st["failed"] + st["cancelled"] \
        == st["submitted"], "stranded tickets"
    print("   ledger balances: completed + failed + cancelled == submitted")
    out["ledger"] = {key: st[key] for key in (
        "submitted", "completed", "failed", "cancelled", "retries",
        "fallback_served", "health")}
    out["ledger"]["injected"] = chaos.stats()["injected"]
    return out


if __name__ == "__main__":
    main()
