"""Quickstart: the paper's fast k-means++ seeding on a synthetic dataset.

    PYTHONPATH=src python examples_torch/quickstart.py [--n 100000] \
        [--k 500] [--backend device|sharded|cpu] [--device cuda|cpu]

The port's copy of `examples/quickstart.py`, with its options and output
lines.  Compares FASTK-MEANS++ and REJECTIONSAMPLING (this paper) against
exact k-means++, AFK-MC^2 and uniform seeding (the experiment of paper §6,
the NumPy seeders, which give the JAX package's centers for one seed), then
demonstrates the plan/execute API: one `ClusterPlan` whose prepare stage
(multi-tree embedding, LSH keys, quantisation) is built once and reused by
`fit` / `refit` / `fit_batch`.

`--backend device` (the default) adds the device-backend plans, whose
sweeps, LSH accept and k-means|| distances are the hand-written kernels on
the card; `--backend sharded` runs them over `make_seeding_mesh` (one
shard a card, one on the CPU); `--backend cpu` leaves them out unless
`--smoke` is given, as the JAX script's default run does.  `--engine` (implied by
`--smoke`) adds the async pipeline: a `ClusterEngine` overlapping the host
prepare of dataset i+1 with the device solve of dataset i, plus the stacked
`fit_batch(datasets=...)` that solves several *different* datasets as one
lane-batched solve a shape bucket.

`--device` defaults to ``cuda`` and raises without CUDA; ``--device cpu``
runs the kernels' plain versions.  `main(argv)` returns the printed numbers.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

SEEDER_ROWS = ("kmeans++", "fastkmeans++", "rejection", "kmeans||",
               "afkmc2", "uniform")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: tiny dataset, every API surface")
    ap.add_argument("--backend", choices=("cpu", "device", "sharded"),
                    default="device",
                    help="'device' (the default) also runs the device "
                         "seeders (the hand-written kernels on the card); "
                         "'sharded' their sharded twins over a seeding "
                         "mesh; 'cpu' only the host seeders")
    ap.add_argument("--engine", action="store_true",
                    help="also run the async ClusterEngine pipeline demo "
                         "(overlap host prepare with device solve) and the "
                         "stacked multi-dataset fit_batch")
    ap.add_argument("--schedule", default="adaptive",
                    help="candidate-batch schedule for the device/sharded "
                         "rejection seeder: 'adaptive' (default), "
                         "'fixed:<B>' (legacy fixed block, e.g. fixed:128) "
                         "or 'adaptive:<min>,<max>' for a custom ladder")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without CUDA) or "
                         "'cpu' (the kernels' plain versions)")
    return ap


def make_points(n: int, d: int, k: int, seed: int):
    """The JAX script's mixture: (points (n, d), its 2k centers)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k * 2, d)) * 10
    pts = centers[rng.integers(len(centers), size=n)] + rng.normal(
        size=(n, d))
    return pts, centers


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.n, args.d, args.k = 4000, 8, 25

    from repro_torch.core import (
        BatchSchedule,
        ClusterPlan,
        ClusterSpec,
        ExecutionSpec,
        SEEDERS,
        clustering_cost,
    )
    from repro_torch.core.plan import resolve_device

    resolve_device(args.device)
    try:
        if args.schedule == "adaptive":
            schedule = BatchSchedule()
        elif args.schedule.startswith("fixed:"):
            schedule = BatchSchedule.fixed(
                int(args.schedule.split(":", 1)[1]))
        elif args.schedule.startswith("adaptive:"):
            lo, hi = args.schedule.split(":", 1)[1].split(",")
            schedule = BatchSchedule(min_batch=int(lo), max_batch=int(hi))
        else:
            raise ValueError("unknown schedule kind")
    except ValueError as e:
        raise SystemExit(
            f"bad --schedule {args.schedule!r} ({e}); expected 'adaptive', "
            f"'fixed:<B>' or 'adaptive:<min>,<max>'")

    out: dict = {"n": args.n, "d": args.d, "k": args.k, "seeders": {}}
    pts, centers = make_points(args.n, args.d, args.k, args.seed)
    print(f"dataset: n={args.n} d={args.d}, seeding k={args.k}\n")
    print(f"{'algorithm':16s} {'seconds':>8s} {'cost':>14s} {'vs km++':>8s}")
    base = None
    for name in SEEDER_ROWS:
        res = SEEDERS[name](pts, args.k, np.random.default_rng(args.seed))
        cost = clustering_cost(pts, res.centers)
        if name == "kmeans++":
            base = cost
        print(f"{name:16s} {res.seconds:8.2f} {cost:14.1f} {cost/base:8.3f}")
        out["seeders"][name] = {"seconds": res.seconds, "cost": cost,
                                "ratio": cost / base}

    # -- plan/execute API ---------------------------------------------------
    # ClusterSpec (what) + ExecutionSpec (where) compile into a ClusterPlan:
    # `prepare` builds the host-side artifacts once (cached by data
    # fingerprint); `fit`/`refit`/`fit_batch` only pay the solve stage.
    print("\nplan/execute API (rejection seeder + 5 Lloyd iterations):")
    spec = ClusterSpec(k=args.k, seeder="rejection", lloyd_iters=5,
                       seed=args.seed, schedule=schedule)
    plan = ClusterPlan(spec, ExecutionSpec(backend="cpu",
                                           device=args.device))
    plan.prepare(pts)
    km = plan.fit()
    print(f"  prepare: {km.prepare_seconds:.2f}s   "
          f"fit (solve only): {km.solve_seconds:.2f}s   "
          f"final cost: {float(km.cost):.1f} "
          f"({km.extras.get('lloyd_iterations', 0)} Lloyd iterations)")
    km2 = plan.refit(seed=args.seed + 1)
    print(f"  refit(seed+1): {km2.solve_seconds:.2f}s "
          f"(cpu caches the quantise step; the device plans below cache "
          f"embedding+LSH too; cost {float(km2.cost):.1f})")
    out["plan"] = {"prepare_seconds": km.prepare_seconds,
                   "solve_seconds": km.solve_seconds,
                   "cost": float(km.cost),
                   "lloyd_iterations": km.extras.get("lloyd_iterations", 0),
                   "refit_seconds": km2.solve_seconds,
                   "refit_cost": float(km2.cost)}

    if args.backend in ("device", "sharded") or args.smoke:
        # The same two paper algorithms (Algorithm 3, Algorithm 4 with the
        # fused LSH accept kernel) and k-means|| on the device backend:
        # the hand-written kernels on the card, their plain versions on
        # the CPU.  backend='sharded' runs the sharded twins: one
        # contiguous point range and sub-heap a shard, one controller.
        backend = args.backend if args.backend != "cpu" else "device"
        dev_pts, dev_k = (pts[:1500], 10) if args.smoke else (pts, args.k)
        mesh = None
        if backend == "sharded":
            from repro_torch.launch.mesh import make_seeding_mesh

            mesh = make_seeding_mesh(device=args.device)
        ndev = mesh.size if mesh is not None else 1
        print(f"\n{backend} backend plans ({ndev} device(s), "
              f"schedule={args.schedule}):")
        out["device"] = {}
        for name in ("fastkmeans++", "rejection", "kmeans||"):
            plan = ClusterPlan(
                ClusterSpec(k=dev_k, seeder=name, seed=args.seed,
                            schedule=schedule),
                ExecutionSpec(backend=backend, device=args.device,
                              mesh=mesh),
            )
            plan.prepare(dev_pts)
            km = plan.fit()
            row = {"prepare_seconds": km.prepare_seconds,
                   "solve_seconds": km.solve_seconds,
                   "cost": float(km.cost)}
            line = (f"  {name + '/' + backend:24s} "
                    f"prepare {km.prepare_seconds:7.2f}s  "
                    f"solve {km.solve_seconds:7.2f}s  "
                    f"cost={float(km.cost):14.1f}")
            if name == "rejection":
                batch = plan.fit_batch([1, 2, 3, 4])
                costs = np.asarray([float(c) for c in batch.cost])
                line += (f"  fit_batch(4 seeds"
                         f"{', vmapped' if batch.extras['vmapped'] else ''})"
                         f" {batch.solve_seconds:.2f}s best={costs.min():.1f}")
                row.update(batch_costs=costs.tolist(),
                           vmapped=bool(batch.extras["vmapped"]),
                           batch_solve_seconds=batch.solve_seconds)
            print(line)
            out["device"][name] = row

    if args.engine or args.smoke:
        # -- async pipelined engine + stacked multi-dataset fit_batch -------
        # ClusterEngine overlaps the host prepare (embedding/LSH build) of
        # request i+1 with the device solve of request i; results are
        # bit-identical to the serial prepare+fit loop.  The stacked
        # fit_batch solves B *different* datasets as one lane-batched solve
        # per shape bucket (canonical power-of-two rescale + padded lanes).
        from repro_torch.core import ClusterEngine

        b = 3 if args.smoke else 6
        n_eng = 1000 if args.smoke else min(args.n, 20_000)
        eng_rng = np.random.default_rng(args.seed + 99)
        eng_datasets = [
            centers[eng_rng.integers(len(centers), size=n_eng)]
            + eng_rng.normal(size=(n_eng, args.d))
            for _ in range(b)
        ]
        spec = ClusterSpec(k=10 if args.smoke else args.k,
                           seeder="rejection", seed=args.seed,
                           schedule=schedule)
        exe = ExecutionSpec(backend="device", device=args.device)
        print(f"\nClusterEngine pipeline ({b} datasets, n={n_eng}):")
        t0 = time.time()
        with ClusterEngine(spec, exe) as engine:
            results = engine.map_fit(eng_datasets)
            for r in results:
                r.block_until_ready()
            st = engine.stats()
        wall = time.time() - t0
        costs = [float(r.cost) for r in results]
        print(f"  pipelined wall {wall:.2f}s  "
              f"(host prepare {st['prepare_seconds']:.2f}s overlapped with "
              f"device solve {st['solve_seconds']:.2f}s; serial would be "
              f"their sum)  costs={[f'{c:.0f}' for c in costs]}")
        plan = ClusterPlan(spec, exe)
        t0 = time.time()
        stacked = plan.fit_batch(datasets=eng_datasets)
        stacked.block_until_ready()
        stacked_costs = [float(c) for c in stacked.cost]
        stacked_s = time.time() - t0
        print(f"  stacked fit_batch({b} datasets): "
              f"{stacked_s:.2f}s in {stacked.extras['shape_buckets']} "
              f"shape bucket(s), one lane-batched solve each; "
              f"costs={[f'{c:.0f}' for c in stacked_costs]}")
        out["engine"] = {"wall_seconds": wall,
                         "prepare_seconds": st["prepare_seconds"],
                         "solve_seconds": st["solve_seconds"],
                         "costs": costs,
                         "stacked_seconds": stacked_s,
                         "stacked_costs": stacked_costs,
                         "shape_buckets": stacked.extras["shape_buckets"]}
    return out


if __name__ == "__main__":
    main()
