"""The port against the JAX package at the main path's width, on the CPU.

The other port tests run at d <= 12 on unquantised points.  The main path
runs at d = 74 on quantised points, so here both packages take KDD-Cup-shaped
data at 5% (n = 15,551, d = 74, `benchmarks/datasets.py` at scale 0.05)
through the plan's defaults (quantised, c = 2, the adaptive schedule):

  * the plan's prepared artifacts are bit-identical, and one rejection
    round's acceptance probabilities agree at full width, with the centers
    and weights of a real solve;
  * with k = 100, the 6-seed mean costs of the port's rejection and
    fastkmeans++ seeders agree with the JAX package's `rejection/device`
    and `fastkmeans++/device` within 8%, and so does the ratio of the two.
    Per-seed costs spread by 3 to 7% here, so a 6-seed mean has a standard
    error of about 2%, and a difference of two means about 3%.

Run as a script, it prints the comparison at any k against the JAX
package's CPU seeders, whose law is the device seeders' (those take minutes
per seed at k = 1000 in interpret mode), and how often the nearest
colliding center is not the nearest center:

    PYTHONPATH=src:. python tests/test_torch_quality.py --k 1000 --seeds 3
"""

import argparse
import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.datasets import make_dataset
from repro.core import plan as jplan
from repro.core.seeding import clustering_cost
from repro.kernels import ops as jops
from repro_torch.core import device_seeding as ds
from repro_torch.core import plan as tplan
from repro_torch.kernels import ops
from repro_torch.kernels.ref import LSH_MISS

K = 100
SEEDS = 6
GATE = 0.08


@functools.lru_cache(maxsize=None)
def _points() -> np.ndarray:
    return make_dataset("kddcup", scale=0.05, seed=0)


def _port_plan(seeder: str, k: int = K):
    return tplan.ClusterPlan(tplan.ClusterSpec(k=k, seeder=seeder),
                             tplan.ExecutionSpec(device="cpu"))


def _jax_plan(seeder: str, backend: str, k: int = K):
    return jplan.ClusterPlan(jplan.ClusterSpec(k=k, seeder=seeder),
                             jplan.ExecutionSpec(backend=backend))


def _costs(plan, seeds) -> list:
    """Costs of `refit(seed=s)` on one prepare of the data, in original
    coordinates."""
    pts = _points()
    plan.prepare(pts)
    out = []
    for s in seeds:
        idx = plan.refit(seed=s).indices
        idx = idx.numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
        out.append(clustering_cost(pts, pts[idx]))
    return out


@functools.lru_cache(maxsize=None)
def _mean_cost(package: str, seeder: str) -> float:
    plan = (_port_plan(seeder) if package == "port"
            else _jax_plan(seeder, "device"))
    return float(np.mean(_costs(plan, range(SEEDS))))


def test_full_width_artifacts_and_accept_match_jax():
    """Bit-identical quantised artifacts at d = 74, then one rejection round
    mid-solve: the port's `lsh_bucket_accept` and the JAX package's agree on
    every candidate's nearest colliding center and acceptance probability."""
    pts = _points()
    data = _port_plan("rejection").prepare_data(pts).artifacts
    jdata = _jax_plan("rejection", "device").prepare_data(pts).artifacts
    for name in ("codes_lo", "codes_hi", "points", "keys_lo", "keys_hi"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)),
                                      err_msg=name)
    assert (data.scale, data.num_levels, data.m_init) == \
        (jdata.scale, jdata.num_levels, jdata.m_init)

    count = K - 1                     # the last center's rounds
    gen = torch.Generator().manual_seed(0)
    chosen, _ = ds.device_rejection_sampling(
        data.codes_lo, data.codes_hi, data.points, data.keys_lo, data.keys_hi,
        count, gen, scale=data.scale, num_levels=data.num_levels,
        m_init=data.m_init, c=2.0)
    ts, open_center, weights, coarse = ds._initial_state(
        data.codes_lo, data.codes_hi, scale=data.scale,
        num_levels=data.num_levels, m_init=data.m_init, tile=512)
    for x in chosen.tolist():
        weights, tsums = open_center(weights, x)
        coarse = ts.refresh(coarse, tsums)
    cand = ts.sample(coarse, weights, gen, 512)
    ctr = chosen.long()
    args = (data.keys_lo[:, cand], data.keys_hi[:, cand], data.points[cand],
            data.keys_lo[:, ctr].contiguous(),
            data.keys_hi[:, ctr].contiguous(), data.points[ctr],
            weights[cand])
    d2, p = ops.lsh_bucket_accept(*args, count, c2=4.0)
    jd2, jp = jops.lsh_bucket_accept(*(jnp.asarray(a.numpy()) for a in args),
                                     count, c2=4.0)
    d2, p, jd2, jp = d2.numpy(), p.numpy(), np.asarray(jd2), np.asarray(jp)
    miss = jd2 == np.float32(LSH_MISS)
    np.testing.assert_array_equal(d2 == np.float32(LSH_MISS), miss)
    assert miss.sum() < len(miss)                   # real collisions
    np.testing.assert_allclose(d2[~miss], jd2[~miss], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_full_width_mean_cost_matches_jax(seeder):
    mine, theirs = _mean_cost("port", seeder), _mean_cost("jax", seeder)
    assert abs(mine / theirs - 1.0) < GATE, (mine, theirs)


def test_full_width_rejection_to_fast_ratio_matches_jax():
    """Algorithm 4 against Algorithm 3 on the same data: the port shows the
    same relation as the JAX package, whichever way it goes."""
    mine = _mean_cost("port", "rejection") / _mean_cost("port",
                                                        "fastkmeans++")
    theirs = _mean_cost("jax", "rejection") / _mean_cost("jax",
                                                         "fastkmeans++")
    assert abs(mine / theirs - 1.0) < GATE, (mine, theirs)


def _lsh_miss_share(k: int, seed: int) -> tuple[float, float]:
    """For the port's rejection centers: the share of points whose nearest
    colliding center is not their nearest center, and the mean of
    d2_lsh / d2 over the points with d2 > 0 (no collision counts as MISS)."""
    plan = _port_plan("rejection", k)
    data = plan.prepare(_points()).prepare_data(_points()).artifacts
    idx = plan.refit(seed=seed).indices.long()
    x = data.points.double()
    c = x[idx]
    d2 = torch.cdist(x, c).square()
    collide = torch.zeros_like(d2, dtype=torch.bool)
    for lo, hi in zip(data.keys_lo, data.keys_hi):
        collide |= (lo[:, None] == lo[idx][None]) & \
            (hi[:, None] == hi[idx][None])
    d2_lsh = torch.where(collide, d2, LSH_MISS).min(dim=1).values
    d2_min = d2.min(dim=1).values
    wrong = float((d2_lsh > d2_min * (1 + 1e-9)).double().mean())
    live = d2_min > 0
    ratio = float((d2_lsh[live] / d2_min[live]).clamp_max(1e6).mean())
    return wrong, ratio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    seeds = range(args.seeds)
    pts = _points()
    print(f"KDD-Cup-shaped n={pts.shape[0]} d={pts.shape[1]} k={args.k}, "
          f"seeds {list(seeds)}, quantised, c=2")
    means = {}
    for label, plan in (
            ("port rejection (cpu)", _port_plan("rejection", args.k)),
            ("port fastkmeans++ (cpu)", _port_plan("fastkmeans++", args.k)),
            ("jax rejection/cpu", _jax_plan("rejection", "cpu", args.k)),
            ("jax fastkmeans++/cpu", _jax_plan("fastkmeans++", "cpu",
                                               args.k)),
            ("jax kmeans++/cpu", _jax_plan("kmeans++", "cpu", args.k))):
        costs = _costs(plan, seeds)
        means[label] = float(np.mean(costs))
        print(f"{label:26s} mean {means[label]:.6g}  per seed "
              + " ".join(f"{v:.6g}" for v in costs))
    exact = means["jax kmeans++/cpu"]
    for pkg, rej, fast in (("port", "port rejection (cpu)",
                            "port fastkmeans++ (cpu)"),
                           ("jax", "jax rejection/cpu",
                            "jax fastkmeans++/cpu")):
        print(f"{pkg}: rejection/kmeans++ {means[rej] / exact:.4f}, "
              f"fastkmeans++/kmeans++ {means[fast] / exact:.4f}, "
              f"rejection/fastkmeans++ {means[rej] / means[fast]:.4f}")
    wrong, ratio = _lsh_miss_share(args.k, 0)
    print(f"port rejection, seed 0: nearest colliding center is not the "
          f"nearest for {wrong:.4f} of the points; mean d2_lsh/d2 {ratio:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
