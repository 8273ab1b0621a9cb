"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test skips with a reason where no NVIDIA GPU is
present (the card is looked for inside the fixture, never at import).  On a
machine with a card, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged on purpose (n not a multiple of the tile, B and
K not multiples of the kernel's blocks, L = 15 and L = 1, 59 code rows);
`chip_smoke.py` makes the same comparison at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _codes(h, n, seed, dev):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 ** 63, size=(h, n), dtype=np.uint64)
    for j in range(1, min(h + 1, n)):        # every separation level occurs
        codes[: j - 1, j] = codes[: j - 1, 0]
    lo, hi = ops.split_codes_u64(codes)
    w = rng.uniform(0, 1e8, size=n).astype(np.float32)
    return (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
            torch.from_numpy(w).to(dev))


@pytest.mark.parametrize("h,n", [(3, 10), (14, 1025), (59, 300)])
def test_tree_sep_update_kernel_bit_identical(cuda, h, n):
    lo, hi, w = _codes(h, n, h + n, cuda)
    kw = dict(scale=7.5 * 3 ** 0.5, num_levels=h + 1)
    before = ops.launch_counts()["tree_sep_update"]
    out = ops.tree_sep_update(lo, hi, lo[:, 0], hi[:, 0], w, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tree_sep_update"] == before + 1
    plain = ref.tree_sep_update_ref(lo, hi, lo[:, 0], hi[:, 0], w, **kw)
    assert torch.equal(out, plain)
    assert float(out[0]) == 0.0


@pytest.mark.parametrize("h,n,tile", [(3, 10, 32), (14, 1100, 512),
                                      (21, 1025, 128)])
def test_tree_sep_update_tiles_kernel(cuda, h, n, tile):
    lo, hi, w = _codes(h, n, h * n, cuda)
    kw = dict(scale=7.5, num_levels=h + 1, block_n=tile)
    out, sums = ops.tree_sep_update_tiles(lo, hi, lo[:, 1], hi[:, 1], w, **kw)
    torch.cuda.synchronize()
    lo_p = ops._pad_to(lo, 1, tile, -1)
    hi_p = ops._pad_to(hi, 1, tile, -1)
    plain, psums = ref.tree_sep_update_tiles_ref(
        lo_p, hi_p, lo[:, 1], hi[:, 1], ops._pad_to(w, 0, tile, 0.0), **kw)
    assert torch.equal(out, plain)
    torch.testing.assert_close(sums, psums, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("b,k,l,d,count,miss", [
    (7, 3, 15, 6, None, False),
    (130, 129, 15, 74, 60, False),
    (64, 1, 1, 3, None, False),
    (16, 40, 15, 8, 0, False),
    (33, 40, 15, 8, 40, False),
    (50, 20, 15, 10, None, True),
    (512, 1000, 15, 74, 999, False),
])
def test_lsh_bucket_accept_kernel(cuda, b, k, l, d, count, miss):
    rng = np.random.default_rng(b + k)
    qk = rng.integers(-5, 5, size=(2, l, b)).astype(np.int32)
    ck = rng.integers(-5, 5, size=(2, l, k)).astype(np.int32) + (
        100 if miss else 0)
    arrays = (qk[0], qk[1], rng.normal(size=(b, d)).astype(np.float32),
              ck[0], ck[1], rng.normal(size=(k, d)).astype(np.float32),
              rng.uniform(0, 3, size=b).astype(np.float32))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    args[-1][::5] = 0.0
    d2, p = ops.lsh_bucket_accept(*args, count, c2=1.44)
    torch.cuda.synchronize()
    pd2, pp = ref.lsh_bucket_accept_ref(*args, count, c2=1.44)
    miss_lanes = pd2 == ref.LSH_MISS
    assert torch.equal(d2 == ref.LSH_MISS, miss_lanes)
    if miss or count == 0:
        assert miss_lanes.all()
    torch.testing.assert_close(d2[~miss_lanes], pd2[~miss_lanes], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(p, pp, rtol=1e-5, atol=1e-5)
    assert (p[::5] == 0.0).all()


def test_plan_fit_runs_through_the_kernels(cuda):
    rng = np.random.default_rng(0)
    ctr = rng.normal(size=(12, 5)) * 40
    pts = ctr[rng.integers(12, size=1200)] + rng.normal(size=(1200, 5))
    plan = ClusterPlan(ClusterSpec(k=24, c=1.2, quantize=False),
                       ExecutionSpec(backend="device"))
    ops.reset_launch_counts()
    res = plan.fit(pts)
    counts = ops.launch_counts()
    assert counts["tree_sep_update"] == 2 * 24
    assert counts["tree_sep_update_tiles"] == 24
    assert counts["lsh_bucket_accept"] >= 23
    assert res.indices.is_cuda and len(torch.unique(res.indices)) == 24
    assert torch.isfinite(res.cost) and float(res.cost) > 0


def test_one_seed_replays_on_the_card(cuda):
    """Nothing on the solve path sums in an order that varies from run to
    run, so a refit with one seed opens the same centers every time."""
    rng = np.random.default_rng(1)
    ctr = rng.normal(size=(40, 8)) * 40
    pts = ctr[rng.integers(40, size=20_000)] + rng.normal(size=(20_000, 8))
    plan = ClusterPlan(ClusterSpec(k=64), ExecutionSpec(backend="device"))
    first = plan.fit(pts)
    for _ in range(3):
        torch.testing.assert_close(plan.refit(seed=0).indices, first.indices,
                                   rtol=0, atol=0)
