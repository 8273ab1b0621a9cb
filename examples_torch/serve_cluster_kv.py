"""Clustered-KV long-context decode: the paper's seeder as a serving feature.

    PYTHONPATH=src python examples_torch/serve_cluster_kv.py [--seq 16384] \
        [--engine] [--backend device|cpu] [--device cuda|cpu]

The port's copy of `examples/serve_cluster_kv.py`, with its options and
output lines.  Builds a synthetic long KV cache, clusters the keys per head
with FASTK-MEANS++ (+Lloyd), and compares clustered two-level attention
against exact full attention: output error, attention-mass recall, and the
bytes-read reduction that drives the memory-roofline win.

`--engine` serves the per-head codebook rebuilds through the async
`ClusterEngine` pipeline: while one head's codebook solves on the device,
the next head's embedding/prepare runs on the host thread pool (the
rebuild pattern of a live serving loop, bit-identical to the serial
build).

The JAX script builds on its default cpu backend.  This copy takes
`--backend`: ``device`` (the default) fits the codebooks with the
hand-written sweep kernels on the card, ``cpu`` with the NumPy seeders,
whose build is the JAX script's bit for bit.  `--device` defaults to
``cuda`` and raises without CUDA; ``--device cpu`` runs the kernels' plain
versions.  `main(argv)` returns the printed numbers and the cache.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=16384)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--topc", type=int, default=24)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--engine", action="store_true",
                    help="pipeline the per-head codebook rebuilds through "
                         "ClusterEngine (overlap host prepare with device "
                         "solve; bit-identical results)")
    ap.add_argument("--backend", choices=("device", "cpu"), default="device",
                    help="the codebook fits' backend: 'device' (the "
                         "kernels) or 'cpu' (NumPy seeders)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without CUDA) or "
                         "'cpu' (the kernels' plain versions)")
    return ap


def make_kv(seq: int, heads: int, head_dim: int):
    """The JAX script's keys and values: (rng, topics, keys (1, S, Hk, Dh),
    values (1, S, Hk, Dh)), f32; `rng` goes on to draw the queries."""
    rng = np.random.default_rng(0)
    b, s, hk, dh = 1, seq, heads, head_dim
    # keys with topical structure (mixture) — the realistic regime
    topics = rng.normal(size=(48, dh)) * 2.0
    keys = (topics[rng.integers(48, size=(b, s))][:, :, None, :]
            + rng.normal(size=(b, s, 1, dh)) * 0.7).repeat(hk, axis=2)
    keys = keys.astype(np.float32)
    values = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    return rng, topics, keys, values


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.core import ExecutionSpec
    from repro_torch.core.lloyd import assign as _assign
    from repro_torch.core.plan import resolve_device
    from repro_torch.models.cluster_attn import (
        ClusterKVConfig,
        build_clustered_cache,
        clustered_attention,
    )

    dev = resolve_device(args.device)
    rng, topics, keys, values = make_kv(args.seq, args.heads, args.head_dim)
    b, s, hk, dh = keys.shape
    exe = ExecutionSpec(backend=args.backend, device=args.device)

    cfg = ClusterKVConfig(num_clusters=args.clusters, topc=args.topc,
                          lloyd_iters=2, capacity_slack=3.0)
    out: dict = {}
    t0 = time.time()
    info = {}
    if args.engine:
        from repro_torch.core import ClusterEngine

        # Every head is a fresh dataset submitted exactly once:
        # retain_prepared=False keeps the prepare cache at pipeline depth
        # instead of accumulating all heads' artifacts until close.
        with ClusterEngine(execution=exe, retain_prepared=False) as engine:
            cache = build_clustered_cache(keys, values, cfg, info=info,
                                          engine=engine)
            st = engine.stats()
        out["build_seconds"] = time.time() - t0
        print(f"codebook rebuild via ClusterEngine x {hk} heads: "
              f"{out['build_seconds']:.1f}s wall "
              f"(host prepare {st['prepare_seconds']:.1f}s overlapped with "
              f"device solve {st['solve_seconds']:.1f}s; "
              f"capacity-dropped tokens: {100*info['dropped_frac']:.2f}%)")
        out.update(prepare_seconds=st["prepare_seconds"],
                   solve_seconds=st["solve_seconds"])
    else:
        cache = build_clustered_cache(keys, values, cfg, info=info,
                                      execution=exe)
        out["build_seconds"] = time.time() - t0
        print(f"codebook build (fastkmeans++ x {hk} heads): "
              f"{out['build_seconds']:.1f}s; "
              f"capacity-dropped tokens: {100*info['dropped_frac']:.2f}%")
    out["dropped_frac"] = info["dropped_frac"]

    scale = 1.0 / np.sqrt(dh)
    kf = keys.transpose(0, 2, 1, 3)          # (B, Hk, S, Dh)
    vf = values.transpose(0, 2, 1, 3)
    cent = cache["centroids"][0].cpu().numpy()       # (Hk, C, Dh)
    # token -> cluster assignment, the same for every query
    tok_cl = [_assign(keys[0, :, h, :].astype(np.float64),
                      cent[h].astype(np.float64))[0] for h in range(hk)]
    errs, coverages = [], []
    for _ in range(args.queries):
        # queries aligned with a topic (real attention is concentrated;
        # uniform attention is the worst case for ANY top-k method)
        qv = topics[rng.integers(48)] * 1.5 + rng.normal(size=dh) * 0.5
        q = np.broadcast_to(qv, (b, hk, dh)).astype(np.float32)
        out_c = clustered_attention(torch.from_numpy(q).to(dev), cache, cfg,
                                    scale=scale).cpu().numpy()
        sc = np.einsum("bhd,bhsd->bhs", q, kf) * scale
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        out_e = np.einsum("bhs,bhsv->bhv", p, vf)
        err = np.abs(out_c - out_e).max() / np.abs(out_e).max()
        errs.append(err)
        # exact attention mass covered by the gathered clusters
        csc = np.einsum("hd,hcd->hc", q[0] * scale, cent)
        top = np.argsort(csc, axis=-1)[:, -cfg.topc:]      # (Hk, topc)
        for h in range(hk):
            covered = np.isin(tok_cl[h], top[h])
            coverages.append(float(p[0, h][covered].sum()))
    kv_bytes_full = s * dh * 4 * 2
    cap = cache["k_slots"].shape[3]
    kv_bytes_clustered = (args.clusters + args.topc * cap) * dh * 4 * 2
    print(f"clustered vs exact attention over {args.queries} queries:")
    print(f"  max relative output error: {np.max(errs):.3f} "
          f"(median {np.median(errs):.3f})")
    print(f"  exact attention mass covered by gathered clusters: "
          f"{np.mean(coverages):.3f}")
    print(f"  KV bytes touched per decode step: full={kv_bytes_full/1e6:.1f}MB"
          f" clustered={kv_bytes_clustered/1e6:.2f}MB"
          f" ({kv_bytes_full/kv_bytes_clustered:.1f}x fewer)")
    out.update(max_error=float(np.max(errs)),
               median_error=float(np.median(errs)),
               coverage=float(np.mean(coverages)),
               kv_bytes_full=kv_bytes_full,
               kv_bytes_clustered=kv_bytes_clustered, cache=cache)
    return out


if __name__ == "__main__":
    main()
