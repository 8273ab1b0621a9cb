"""The port's kernel wrappers against the JAX package's, on the CPU.

The same NumPy inputs go through `repro.kernels.ops` (the Pallas kernels in
interpret mode) and `repro_torch.kernels.ops` (on CPU tensors: padding, then
the plain PyTorch versions the CUDA kernels are held to on the card).
Shapes follow `tests/test_kernels.py` and `tests/test_device_rejection.py`,
including n, k, B and K that are not multiples of 128, d = 74, L = 15, live
counts of 0 and of K, and a complete miss.  Tolerances: the tree sweep is
bit-identical (integer compares and exact powers of two), tile sums and
distances agree to rtol 1e-5 (f32 sums in another order; bf16 inputs to
the JAX tests' own 2e-2 and 3e-2), `LSH_MISS` lanes exactly, and argmins
exactly except where the best two distances lie within that tolerance.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lsh_bucket_min import LSH_MISS as JAX_LSH_MISS
from repro_torch.kernels import ops, ref

MISS32 = np.float32(ref.LSH_MISS)
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # tests/test_kernels.py


def _both(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of `dtype` (bf16
    rounds once, in NumPy, so both packages see the same bits)."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16),
                jnp.asarray(a))
    a = a.astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _d2_matrix(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Exact squared distances (float64) of the f32-widened inputs."""
    xf = np.asarray(x, np.float64)
    cf = np.asarray(c, np.float64)
    return ((xf[:, None, :] - cf[None, :, :]) ** 2).sum(-1)


def _check_argmin(d2, idx, jd2, jidx, x, c, tol):
    """Distances within `tol`; argmins equal to the JAX package's except
    where the exact distances of the two picks lie within `tol` of each
    other (a numerical tie)."""
    np.testing.assert_allclose(d2, jd2, rtol=tol, atol=tol)
    exact = _d2_matrix(x, c)
    rows = np.flatnonzero(idx != jidx)
    assert len(rows) <= max(1, len(idx) // 100)
    np.testing.assert_allclose(exact[rows, idx[rows]], exact[rows, jidx[rows]],
                               rtol=tol, atol=tol)


def _codes(h, n, seed):
    """Random (h, n) codes; lane j in 1..min(h, n-1) agrees with lane 0 on
    its first j - 1 heights, so every separation level 1..h+1 occurs."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 ** 63, size=(h, n), dtype=np.uint64)
    for j in range(1, min(h + 1, n)):
        codes[: j - 1, j] = codes[: j - 1, 0]
    return codes, rng


def _sep(lo, hi, col):
    return 1 + ((lo == lo[:, col:col + 1]) & (hi == hi[:, col:col + 1])).sum(0)


def _exact_sweep(lo, hi, col, w, scale, num_levels):
    """The sweep in exact f32 arithmetic (NumPy, powers of two by ldexp)."""
    pow2 = np.ldexp(np.float32(1.0), 1 - _sep(lo, hi, col)).astype(np.float32)
    dist = np.float32(scale) * (pow2 - np.float32(2.0 ** (1 - num_levels)))
    dist = np.maximum(dist, np.float32(0.0))
    return np.minimum(w, dist * dist)


def test_lsh_miss_and_split_codes_match():
    assert ref.LSH_MISS == JAX_LSH_MISS
    codes = np.random.default_rng(0).integers(0, 2 ** 64 - 1, size=(5, 77),
                                              dtype=np.uint64)
    for mine, theirs in zip(ops.split_codes_u64(codes),
                            jops.split_codes_u64(codes)):
        assert mine.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("h,n", [(3, 10), (14, 2049), (21, 300), (22, 1025),
                                 (31, 64)])
def test_tree_sep_update_bit_identical(h, n):
    """w' is bit-identical to exact f32 arithmetic, and to the JAX package on
    every lane where XLA's CPU `exp2` is exact.  XLA rounds 2^(1-sep) for
    sep >= 14 (sep 15 aside) within a few ulps instead of exactly, so those
    lanes agree to 1e-5 relative there; the port's `exp2`, like the CUDA
    kernel's `exp2f`, is exact on integer arguments."""
    codes, rng = _codes(h, n, h * 100 + n)
    lo, hi = jops.split_codes_u64(codes)
    w = rng.uniform(0, 1e8, size=n).astype(np.float32)
    kw = dict(scale=7.5 * np.sqrt(3.0), num_levels=h + 1)
    out = ops.tree_sep_update(torch.from_numpy(lo), torch.from_numpy(hi),
                              torch.from_numpy(lo[:, 0]),
                              torch.from_numpy(hi[:, 0]),
                              torch.from_numpy(w), **kw).numpy()
    jargs = tuple(map(jnp.asarray, (lo, hi, lo[:, 0], hi[:, 0], w)))
    expect = np.asarray(jops.tree_sep_update(*jargs, **kw))
    oracle = np.asarray(jref.tree_sep_update_ref(*jargs, **kw))
    assert out.dtype == np.float32 and out.shape == (n,)
    np.testing.assert_array_equal(out, _exact_sweep(lo, hi, 0, w, **kw))
    np.testing.assert_array_equal(expect, oracle)
    sep = _sep(lo, hi, 0)
    xla_exact = np.asarray(jnp.exp2(1.0 - jnp.asarray(sep, jnp.float32))) \
        == np.ldexp(np.float32(1.0), 1 - sep)
    np.testing.assert_array_equal(out[xla_exact], expect[xla_exact])
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-28)
    assert out[0] == 0.0                       # the center itself


@pytest.mark.parametrize("h,n,block", [(3, 10, 512), (14, 1100, 512),
                                       (21, 1025, 512), (9, 300, 128)])
def test_tree_sep_update_tiles_matches(h, n, block):
    codes, rng = _codes(h, n, h * 100 + n + 1)
    lo, hi = jops.split_codes_u64(codes)
    w = rng.uniform(0, 1e6, size=n).astype(np.float32)
    kw = dict(scale=7.5, num_levels=h + 1, block_n=block)
    out, sums = ops.tree_sep_update_tiles(
        torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(lo[:, 3 % n]), torch.from_numpy(hi[:, 3 % n]),
        torch.from_numpy(w), **kw)
    jout, jsums = jops.tree_sep_update_tiles(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(lo[:, 3 % n]),
        jnp.asarray(hi[:, 3 % n]), jnp.asarray(w), **kw)
    n_pad = -(-n // block) * block
    assert out.shape == (n_pad,) and sums.shape == (n_pad // block,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (out[n:] == 0.0).all()              # padded lanes carry w = 0
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5)
    np.testing.assert_allclose(
        sums.numpy(), out.numpy().astype(np.float64).reshape(-1, block).sum(1),
        rtol=1e-5)


def _lsh_inputs(b, k, l, d, miss, seed):
    rng = np.random.default_rng(seed)
    # A small key range forces plenty of collisions and checks that padded
    # lanes never leak into the result; a complete miss uses disjoint ranges.
    qk = rng.integers(-5, 5, size=(2, l, b)).astype(np.int32)
    ck = rng.integers(-5, 5, size=(2, l, k)).astype(np.int32)
    if miss:
        ck += 100
    q = rng.normal(size=(b, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    mtd2 = rng.uniform(0, 3, size=b).astype(np.float32)
    mtd2[::5] = 0.0            # already-covered points: never accept
    return qk[0], qk[1], q, ck[0], ck[1], c, mtd2


LSH_CASES = [
    # b, k, l, d, count, miss
    (7, 3, 15, 6, None, False),      # tiny, every padding path
    (130, 129, 15, 74, 60, False),   # several tiles, live-count mask
    (130, 129, 15, 12, 60, False),
    (64, 1, 1, 3, None, False),      # one table, one center
    (16, 40, 15, 8, 0, False),       # no live center: every lane misses
    (33, 40, 15, 8, 40, False),      # count == K
    (50, 20, 15, 10, None, True),    # keys never collide: complete miss
]


@pytest.mark.parametrize("b,k,l,d,count,miss", LSH_CASES)
def test_lsh_bucket_accept_matches(b, k, l, d, count, miss):
    arrays = _lsh_inputs(b, k, l, d, miss, b * 1000 + k)
    d2, p = ops.lsh_bucket_accept(*map(torch.from_numpy, arrays), count,
                                  c2=1.44)
    jd2, jp = jops.lsh_bucket_accept(*map(jnp.asarray, arrays), count,
                                     c2=1.44)
    rd2, rp = jref.lsh_bucket_accept_ref(*map(jnp.asarray, arrays), count,
                                         c2=1.44)
    d2, p = d2.numpy(), p.numpy()
    jd2, jp = np.asarray(jd2), np.asarray(jp)
    assert d2.shape == p.shape == (b,)
    miss_lanes = jd2 == MISS32
    np.testing.assert_array_equal(d2 == MISS32, miss_lanes)
    np.testing.assert_array_equal(np.asarray(rd2) == MISS32, miss_lanes)
    if miss or count == 0:
        assert miss_lanes.all()
    hit = ~miss_lanes
    np.testing.assert_allclose(d2[hit], jd2[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d2[hit], np.asarray(rd2)[hit], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p, np.asarray(rp), rtol=1e-5, atol=1e-5)
    assert (p[::5] == 0.0).all()


@pytest.mark.parametrize("b,k,l,d,count,miss", LSH_CASES)
def test_lsh_penalty_form_equals_count_form(b, k, l, d, count, miss):
    """The kernel's penalty-row form of the query (what the CUDA kernel and
    `chip_smoke.py` compare) equals the count form of the oracle."""
    arrays = tuple(map(torch.from_numpy, _lsh_inputs(b, k, l, d, miss, b)))
    qlo, qhi, q, clo, chi, c, mtd2 = arrays
    live = k if count is None else count
    d2, p = ref.lsh_bucket_accept_penalty_ref(
        qlo, qhi, q, clo, chi, c, ops.penalty_row(k, live, "cpu"), mtd2,
        c2=1.44)
    ed2, ep = ref.lsh_bucket_accept_ref(*arrays, count, c2=1.44)
    torch.testing.assert_close(d2, ed2, rtol=0, atol=0)
    torch.testing.assert_close(p, ep, rtol=0, atol=0)


PAIRWISE_SHAPES = [(7, 3, 5), (128, 128, 64), (300, 70, 17), (1024, 256, 74),
                   (65, 129, 33)]


@pytest.mark.parametrize("n,k,d", PAIRWISE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pairwise_argmin_matches(n, k, d, dtype):
    """The port's wrapper (padding, then the plain version) against the JAX
    package's (padding, then the Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(n * 1000 + k)
    (x, jx), (c, jc) = (_both(rng.normal(size=s), dtype)
                        for s in ((n, d), (k, d)))
    d2, idx = ops.pairwise_argmin(x, c)
    jd2, jidx = jops.pairwise_argmin(jx, jc, interpret=True)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    assert d2.shape == idx.shape == (n,)
    _check_argmin(d2.numpy(), idx.numpy(), np.asarray(jd2), np.asarray(jidx),
                  x.float().numpy(), c.float().numpy(), TOL[dtype])
    assert int(idx.max()) < k                  # never a padded slot


@pytest.mark.parametrize("dtype", DTYPES)
def test_pairwise_argmin_ties_go_to_the_smallest_index(dtype):
    """Duplicated centers, across and within the 128-slot tiles: every
    point's argmin is the first copy, in both packages."""
    rng = np.random.default_rng(3)
    base = np.round(rng.normal(size=(40, 6)) * 4)     # exact in bf16 too
    c_np = np.concatenate([base, base[::-1], base[:30], base[5:]])   # 145
    x_np = base[rng.integers(40, size=200)] + 0.25
    (x, jx), (c, jc) = _both(x_np, dtype), _both(c_np, dtype)
    d2, idx = ops.pairwise_argmin(x, c)
    jd2, jidx = jops.pairwise_argmin(jx, jc, interpret=True)
    exact = _d2_matrix(x.float().numpy(), c.float().numpy())
    first = exact.argmin(axis=1)                       # NumPy: first minimum
    np.testing.assert_array_equal(idx.numpy(), first)
    np.testing.assert_array_equal(np.asarray(jidx), first)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_pairwise_argmin_far_slots():
    """Unfilled center slots sit at the k-means|| `_FAR` (1e17 in every
    coordinate, as the padded slots do): their distances stay f32-finite
    and never win while a real center is nearer, even at d = 74; with every
    slot far, the first slot wins."""
    rng = np.random.default_rng(5)
    x_np = rng.normal(size=(300, 74)).astype(np.float32)
    c_np = np.full((200, 74), 1.0e17, dtype=np.float32)
    live = rng.choice(200, 37, replace=False)
    c_np[live] = rng.normal(size=(37, 74))
    d2, idx = ops.pairwise_argmin(torch.from_numpy(x_np),
                                  torch.from_numpy(c_np))
    jd2, jidx = jops.pairwise_argmin(jnp.asarray(x_np), jnp.asarray(c_np),
                                     interpret=True)
    assert np.isin(idx.numpy(), live).all()
    _check_argmin(d2.numpy(), idx.numpy(), np.asarray(jd2), np.asarray(jidx),
                  x_np, c_np, 1e-5)
    far_d2, far_idx = ops.pairwise_argmin(torch.from_numpy(x_np),
                                          torch.from_numpy(c_np[:5] * 0 + 1e17))
    assert torch.isfinite(far_d2).all() and (far_d2 > 1e35).all()
    assert (far_idx == 0).all()


@pytest.mark.parametrize("n,d", [(5, 3), (512, 64), (1000, 74), (513, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_d2_update_matches(n, d, dtype):
    rng = np.random.default_rng(n)
    (x, jx), (ctr, jctr) = (_both(rng.normal(size=s), dtype)
                            for s in ((n, d), (d,)))
    w = rng.uniform(0, 4, size=n).astype(np.float32)
    out = ops.d2_update(x, ctr, torch.from_numpy(w)).numpy()
    expect = np.asarray(jops.d2_update(jx, jctr, jnp.asarray(w),
                                       interpret=True))
    tol = 1e-5 if dtype == "float32" else 3e-2     # tests/test_kernels.py
    assert out.shape == (n,) and out.dtype == np.float32
    np.testing.assert_allclose(out, expect, rtol=tol, atol=tol)
    assert (out <= w).all()


@pytest.mark.parametrize("n,d,block_n", [(5, 3, 512), (512, 16, 512),
                                         (1300, 7, 512), (1000, 74, 512),
                                         (1000, 74, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_d2_update_tiles_matches(n, d, block_n, dtype):
    """w' as the JAX package's, padded lanes at 0, and tile sums to rtol
    1e-5 of both the JAX package's and a float64 sum of w'.  The port pads
    neither x nor w (its outputs are padded), the JAX package pads both."""
    rng = np.random.default_rng(n + d)
    (x, jx), (ctr, jctr) = (_both(rng.normal(size=s), dtype)
                            for s in ((n, d), (d,)))
    w = rng.uniform(0.1, 4, size=n).astype(np.float32)
    out, sums = ops.d2_update_tiles(x, ctr, torch.from_numpy(w),
                                    block_n=block_n)
    jout, jsums = jops.d2_update_tiles(jx, jctr, jnp.asarray(w),
                                       block_n=block_n, interpret=True)
    n_pad = -(-n // block_n) * block_n
    assert out.shape == (n_pad,) and sums.shape == (n_pad // block_n,)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=tol,
                               atol=tol)
    assert (out[n:] == 0.0).all()
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5)
    np.testing.assert_allclose(
        sums.numpy(),
        out.numpy().astype(np.float64).reshape(-1, block_n).sum(1),
        rtol=1e-5)


@pytest.mark.parametrize("b,k,l,d,count", [
    (7, 3, 15, 6, None),       # tests/test_device_rejection.py
    (130, 129, 15, 74, 60),
    (64, 1, 1, 3, None),
    (16, 40, 15, 8, 0),
])
def test_lsh_bucket_min_matches(b, k, l, d, count):
    """`lsh_bucket_min` against the JAX package's, on the inputs of its own
    test, and against the port's accept query's d2_min."""
    arrays = _lsh_inputs(b, k, l, d, False, b * 1000 + k)[:6]
    d2 = ops.lsh_bucket_min(*map(torch.from_numpy, arrays), count).numpy()
    jd2 = np.asarray(jops.lsh_bucket_min(*map(jnp.asarray, arrays), count,
                                         interpret=True))
    assert d2.shape == (b,) and d2.dtype == np.float32
    miss_lanes = jd2 == MISS32
    np.testing.assert_array_equal(d2 == MISS32, miss_lanes)
    if count == 0:
        assert miss_lanes.all()
    np.testing.assert_allclose(d2[~miss_lanes], jd2[~miss_lanes], rtol=1e-5,
                               atol=1e-5)
    mtd2 = torch.ones(b)
    accept_d2, _ = ops.lsh_bucket_accept(*map(torch.from_numpy, arrays), mtd2,
                                         count, c2=1.0)
    np.testing.assert_array_equal(d2, accept_d2.numpy())


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted."""
    ops.reset_launch_counts()
    codes, rng = _codes(4, 40, 0)
    lo, hi = map(torch.from_numpy, ops.split_codes_u64(codes))
    w = torch.ones(40)
    ops.tree_sep_update(lo, hi, lo[:, 0], hi[:, 0], w, scale=1.0,
                        num_levels=5)
    ops.tree_sep_update_tiles(lo, hi, lo[:, 0], hi[:, 0], w, scale=1.0,
                              num_levels=5, block_n=32)
    lsh = list(map(torch.from_numpy, _lsh_inputs(9, 5, 15, 4, False, 1)))
    ops.lsh_bucket_accept(*lsh, 3, c2=4.0)
    ops.lsh_bucket_min(*lsh[:6], 3)
    x = torch.randn(40, 6)
    ops.pairwise_argmin(x, x[:7])
    ops.d2_update(x, x[0], w)
    ops.d2_update_tiles(x, x[0], w, block_n=32)
    q = torch.randn(2, 16, 4, 8)
    ops.flash_attention(q[:, :, 0], q[:, :, 1], q[:, :, 2], scale=1.0)
    ops.attention_bshd(q, q[:, :, :2], q[:, :, 2:], scale=1.0, causal=True)
    assert ops.launch_counts() == {"tree_sep_update": 0,
                                   "tree_sep_update_tiles": 0,
                                   "lsh_bucket_accept": 0,
                                   "lsh_bucket_min": 0,
                                   "pairwise_argmin": 0,
                                   "d2_update": 0,
                                   "d2_update_tiles": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0}
