"""Launcher for the clustering RPC server (`repro_torch.serving.net`).

Serve mode binds a `ClusterServer` and blocks until interrupted:

    python -m repro_torch.launch.cluster_serve --port 7077 \\
        --max-batch 8 --max-wait-ms 5 \\
        --tenants "bulk:50:100:1,interactive:200:40:4"

The fits run on the card (``--backend device --device cuda``, the
defaults) unless the caller asks for the CPU (``--device cpu``);
``--backend sharded --shards 4`` runs them over a seeding mesh of four
shards (`repro_torch.launch.mesh.make_seeding_mesh`; without ``--shards``,
one shard per visible card).

Smoke mode (`--smoke`) runs a self-contained loopback exercise instead:
it starts the server on an ephemeral port, drives a burst of concurrent
fits through a real `ClusterClient` over real sockets (two tenants, so
the fairness path executes), asserts every request resolved, and prints
the SLO attribution — where each millisecond went between queue wait
(coalescing hold), solve (prepare + device) and network (frame
decode/encode + delivery).  It is the quickest way to eyeball a tuning
change:

    python -m repro_torch.launch.cluster_serve --smoke --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core import ClusterSpec, ExecutionSpec
from repro_torch.launch.mesh import make_seeding_mesh
from repro_torch.serving.net import (
    ClusterClient,
    ClusterServer,
    TenantScheduler,
    parse_tenants,
)


def _build_server(args) -> ClusterServer:
    admission = None
    if args.tenants:
        admission = TenantScheduler(parse_tenants(args.tenants))
    mesh = None
    if args.backend == "sharded":
        mesh = make_seeding_mesh(args.shards, device=args.device)
    return ClusterServer(
        ClusterSpec(k=args.k, seeder=args.seeder),
        ExecutionSpec(backend=args.backend, device=args.device, mesh=mesh),
        admission=admission, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_pending=args.max_pending, backpressure=args.backpressure)


def _smoke(args) -> int:
    """Loopback exercise: burst N fits via sockets, print the breakdown."""
    rng = np.random.default_rng(0)
    datasets = [rng.normal(size=(args.smoke_n, args.smoke_d)) +
                8.0 * rng.normal(size=(1, args.smoke_d))
                for _ in range(args.smoke_requests)]
    args = argparse.Namespace(**{**vars(args), "port": 0})
    if not args.tenants:
        args.tenants = "bulk:1000:64:1,interactive:1000:64:4"
    tenants = list(parse_tenants(args.tenants))
    with _build_server(args) as srv:
        print(f"smoke: serving on {srv.address[0]}:{srv.address[1]} "
              f"(backend={args.backend}, device={args.device}, "
              f"max_batch={args.max_batch}, "
              f"max_wait_ms={args.max_wait_ms:g})")
        with ClusterClient(*srv.address) as client:
            ids = [client.submit(ds, seed=i,
                                 tenant=tenants[i % len(tenants)])
                   for i, ds in enumerate(datasets)]
            failed = 0
            for rid in client.as_completed(ids, timeout=300.0):
                try:
                    client.result(rid, timeout=60.0)
                except Exception as e:  # noqa: BLE001 — counted, reported
                    failed += 1
                    print(f"smoke: request {rid} FAILED: {e!r}")
            # The server bumps its delivery counters AFTER the terminal
            # frame hits the socket, so a stats probe racing the last
            # delivery can read one short — poll until the ledger
            # covers the burst (bounded; a genuine shortfall still
            # fails below).
            settle = time.monotonic() + 10.0
            while True:
                stats = client.stats(timeout=60.0)
                net = stats["net"]
                if (net["results_sent"] + net["errors_sent"]
                        >= len(datasets)
                        or time.monotonic() > settle):
                    break
                time.sleep(0.05)
    net = stats["net"]
    bd = net["breakdown"]
    attributed = bd["queue_wait_s"] + bd["solve_s"] + bd["network_s"]
    print(f"smoke: {net['results_sent']} results / "
          f"{net['errors_sent']} errors over "
          f"{net['connections_total']} connection(s); "
          f"lanes={stats['lanes']} "
          f"mean_occupancy={stats['mean_lane_occupancy']:.2f}")
    print("smoke: SLO attribution (cumulative seconds across requests):")
    for name, key in (("queue_wait", "queue_wait_s"),
                      ("solve", "solve_s"), ("network", "network_s")):
        share = bd[key] / attributed if attributed else 0.0
        print(f"  {name:<11} {bd[key]:8.4f}s  ({share:6.1%})")
    for tenant, rec in sorted(stats.get("tenants", {}).items()):
        qw = rec.get("queue_wait", {})
        print(f"smoke: tenant {tenant!r}: "
              f"submitted={rec.get('submitted', 0)} "
              f"completed={rec.get('completed', 0)} "
              f"queue_wait p50={qw.get('p50', 0.0) * 1e3:.2f}ms "
              f"p99={qw.get('p99', 0.0) * 1e3:.2f}ms")
    ok = failed == 0 and net["results_sent"] == len(datasets)
    print(f"smoke: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve k-means fits over the binary RPC wire.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7077,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--seeder", default="fastkmeans++")
    ap.add_argument("--backend", default="device",
                    choices=("device", "sharded", "cpu"),
                    help="execution backend")
    ap.add_argument("--shards", type=int, default=None,
                    help="the sharded backend's shard count (default: one "
                         "per visible card; one with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="where the artifacts live and the kernels run "
                         "(cuda | cpu: the kernels' plain versions)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="frontend coalescing lane width")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="frontend hold-and-batch window")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="held-queue bound (backpressure beyond this)")
    ap.add_argument("--backpressure", choices=("block", "reject"),
                    default="block")
    ap.add_argument("--tenants", default="",
                    help="per-tenant quotas: name[:rate_hz[:burst"
                         "[:weight]]],... (empty = no admission control)")
    ap.add_argument("--smoke", action="store_true",
                    help="loopback self-test: burst fits through a real "
                         "client, print the SLO breakdown, exit")
    ap.add_argument("--smoke-requests", type=int, default=12)
    ap.add_argument("--smoke-n", type=int, default=512,
                    help="points per smoke dataset")
    ap.add_argument("--smoke-d", type=int, default=8,
                    help="dimensions per smoke dataset")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.smoke:
        return _smoke(args)
    with _build_server(args) as srv:
        print(f"serving on {srv.address[0]}:{srv.address[1]} "
              f"(ctrl-c to stop)")
        try:
            srv.wait_closed()
        except KeyboardInterrupt:
            print("shutting down: draining held lanes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
