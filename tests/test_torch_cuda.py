"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test skips with a reason where no NVIDIA GPU is
present (the card is looked for inside the fixture, never at import).  On a
machine with a card, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged on purpose (n not a multiple of the tile, B and
K not multiples of the kernel's blocks, n and k not multiples of 128,
L = 15 and L = 1, 59 code rows, f32 and bf16 points); `chip_smoke.py` makes
the same comparison at the main paths' full shapes.  Two grids cover the
redesigned kernels: `flash_attention` over D, S, GQA group, causality,
dtype and both entries (strided and misaligned views included) within
`ATTN_TOL`, and the LSH queries over B and the live count, with an
all-miss case and two launches on the same inputs bit-identical.  A third
covers `d2_update` and `d2_update_tiles` over n, d (1 to 4097), dtype,
tile and an offset view of x, and the tiles wrapper is held to allocating
nothing the size of x.  The last three tests drive the plan's other entry
points on the card: the legacy `fit` against `ClusterPlan.fit` for the
three device seeders, `fit_batch(seeds)` lanes against solo refits, and
`no_retrace()` around refits after a warm-up.  The stacked-lane tests
(`-k stacked`) hold the lane axis of the two sweeps and of
`lsh_bucket_accept` to their plain versions and, lane by lane, to the
one-lane launch bit for bit (per-lane codes and shared codes with a
stride-0 lane axis, lanes of different block sizes), the lane-batched
sampler to the one-lane sampler, and `fit_batch(seeds)` and
`fit_batch(datasets=...)` lanes (mixed shape buckets included) to their
one-lane fits.  The streaming tests (`-k streaming`) hold a stream on the
card: the patched heap equal to `ts.init(w0)` bit for bit after three
thousand random extends and retires, one seed replaying, scratch
equivalence, and refits opening only live rows after an extend out of
the domain.  The service tests (`-k service`) drive the clustering
service on the card: `ClusterEngine`'s pipelined tickets against the
serial fits, a real out-of-memory (the allocator capped) classified
transient with the failed attempt's memory released before the retry and
after the ticket fails, and four loopback requests through
`ClusterServer` against their lane-batched solve.  The LM variants
(`-k lm_variants`) hold the flash entries with v narrower than q and k
(MLA's D 192 / Dv 128) to their plain versions, `apply_moe` on the card
to itself bit for bit and to the CPU, reduced deepseek-v2-lite-16b and
qwen2-moe-a2.7b `generate` on the card to the CPU's tokens, and the
clustered KV build's sweep launches (2k and k a fit).  The last slice's
tests (`-k "vlm or audio or ssm"`) hold the kernel with a prefix of full
attention (`prefix_len`: prefixes that end inside a query block, on its
edge and past S; 0 and 1 bit-identical to the plain causal launch) and
at hubert-xlarge's head dim 80 non-causal to the plain version, reduced
paligemma-3b's prefill of patches and text and reduced hubert-xlarge's
forward on the card to the CPU, and reduced rwkv6-3b and
jamba-1.5-large-398b `generate` (replayed prompts over the recurrent
states) to the CPU's tokens.  The training slice's tests (`-k training`)
hold the backward kernel of `flash_attention` (through
`ops.attention_bshd`'s autograd Function) to autograd through the plain
version over f32 and bf16, GQA, MLA's D 192 / Dv 128, prefixes, a
non-causal D 80 and a ragged S, a second launch bit-identical; the
forward's `out` the same bits with its log-sum-exp asked for, and that
log-sum-exp against the plain one; one `make_train_step` step of
reduced olmo-1b and yi-9b on the card against the same step on the CPU;
remat "dots" against "none" bit for bit on the card in f32 and bf16; and
the compressed DDP step's collective over two NCCL ranks on two cards
(it skips on one card, as the two-card sharded tests do).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import device_seeding as ds
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


def _lsh_args(b, k, l, d, miss, dev):
    rng = np.random.default_rng(b + k)
    qk = rng.integers(-5, 5, size=(2, l, b)).astype(np.int32)
    ck = rng.integers(-5, 5, size=(2, l, k)).astype(np.int32) + (
        100 if miss else 0)
    arrays = (qk[0], qk[1], rng.normal(size=(b, d)).astype(np.float32),
              ck[0], ck[1], rng.normal(size=(k, d)).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("b,k,l,d,count,miss", [
    (7, 3, 15, 6, None, False),
    (130, 129, 15, 74, 60, False),
    (64, 1, 1, 3, None, False),
    (16, 40, 15, 8, 0, False),
    (50, 20, 15, 10, None, True),
    (512, 1000, 15, 74, 999, False),
])
def test_lsh_bucket_min_kernel(cuda, b, k, l, d, count, miss):
    args = _lsh_args(b, k, l, d, miss, cuda)
    before = ops.launch_counts()["lsh_bucket_min"]
    d2 = ops.lsh_bucket_min(*args, count)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lsh_bucket_min"] == before + 1
    pd2 = ref.lsh_bucket_min_ref(*args, count)
    miss_lanes = pd2 == ref.LSH_MISS
    assert torch.equal(d2 == ref.LSH_MISS, miss_lanes)
    if miss or count == 0:
        assert miss_lanes.all()
    torch.testing.assert_close(d2[~miss_lanes], pd2[~miss_lanes], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d", [(7, 3, 5), (300, 70, 17), (1024, 256, 74),
                                   (65, 129, 33), (2000, 300, 200)])
def test_pairwise_argmin_kernel(cuda, n, k, d, dtype):
    """Distances to rtol 1e-5 (the expanded form, sums in another order);
    argmins equal except where the plain version's best two distances lie
    that close; duplicated centers go to the first copy."""
    rng = np.random.default_rng(n + k)
    x = torch.tensor(rng.normal(size=(n, d)), dtype=dtype, device=cuda)
    c = torch.tensor(rng.normal(size=(k, d)), dtype=dtype, device=cuda)
    c[k - 1] = c[0]                            # a duplicate: 0 wins
    before = ops.launch_counts()["pairwise_argmin"]
    d2, idx = ops.pairwise_argmin(x, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_argmin"] == before + 1
    pd2, pidx = ref.pairwise_argmin_ref(x, c)
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-5)
    full = ((x.float()[:, None] - c.float()[None]) ** 2).sum(-1).double()
    rows = torch.nonzero(idx != pidx).flatten()
    assert len(rows) <= max(1, n // 100)
    torch.testing.assert_close(full[rows, idx[rows].long()],
                               full[rows, pidx[rows].long()], rtol=1e-5,
                               atol=1e-5)
    assert int(idx.max()) < k and (k == 1 or not (idx == k - 1).any())


def _close_to_plain(x, c, d2, idx, count=None):
    """`test_pairwise_argmin_kernel`'s check against the plain version on
    the same inputs: distances to rtol 1e-5, argmins equal except at
    near-ties, at most n/100 of them."""
    pd2, pidx = ref.pairwise_argmin_ref(x, c, count)
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-5)
    rows = torch.nonzero(idx != pidx).flatten()
    assert len(rows) <= max(1, x.shape[0] // 100)
    xr, cd = x[rows].double(), c.double()
    torch.testing.assert_close(((xr - cd[idx[rows].long()]) ** 2).sum(-1),
                               ((xr - cd[pidx[rows].long()]) ** 2).sum(-1),
                               rtol=1e-5, atol=1e-5)


def _far_slots(c, count):
    out = c.clone()
    out[count:] = ds._FAR
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d", [(1, 5, 3), (129, 128, 33),
                                   (300, 300, 74), (1001, 400, 200)])
def test_pairwise_argmin_integer_inputs_exact(cuda, n, k, d, dtype):
    """|coordinate| <= 128 and d <= 200: every partial sum is an f32
    integer, so 3xTF32 (and the bf16 product) is exact and the kernel
    equals the plain version bit for bit.  A center copied into later
    tiles, and points sitting on it, go to the first copy."""
    rng = np.random.default_rng(n * k + d)
    x = torch.tensor(rng.integers(-128, 129, size=(n, d)), dtype=dtype,
                     device=cuda)
    c = torch.tensor(rng.integers(-128, 129, size=(k, d)), dtype=dtype,
                     device=cuda)
    first = min(3, k - 1)
    for j in (130, 260, k - 1):
        if first < j < k:
            c[j] = c[first]
    x[0] = c[first]
    d2, idx = ops.pairwise_argmin(x, c)
    torch.cuda.synchronize()
    pd2, pidx = ref.pairwise_argmin_ref(x, c)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    assert float(d2[0]) == 0.0 and int(idx[0]) == first


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,count", [
    (1001, 300, 0), (1001, 300, 1), (1001, 300, 127), (1001, 300, 128),
    (1001, 300, 129), (1001, 300, 300), (4096, 8000, 1990),
    (4096, 8000, 8000)])
def test_pairwise_argmin_count_bitwise(cuda, n, k, count, dtype):
    """Far-padded slots: the sweep over the live count (a device int32 and
    a Python int) equals the kernel's full sweep bit for bit, launch after
    launch, and the plain version at the same count."""
    rng = np.random.default_rng(n + k + count)
    x = torch.tensor(rng.normal(size=(n, 74)) * 12.0, dtype=dtype,
                     device=cuda)
    c = _far_slots(torch.tensor(rng.normal(size=(k, 74)) * 12.0,
                                dtype=dtype, device=cuda), count)
    before = ops.launch_counts()["pairwise_argmin"]
    full = ops.pairwise_argmin(x, c)
    live = torch.tensor(count, dtype=torch.int32, device=cuda)
    runs = [ops.pairwise_argmin(x, c, live) for _ in range(2)]
    runs.append(ops.pairwise_argmin(x, c, count))
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_argmin"] == before + 4
    for d2, idx in runs:
        assert torch.equal(d2, full[0]) and torch.equal(idx, full[1])
    _close_to_plain(x, ops._pad_to(c, 0, 128, ops._PAD_FAR), *runs[0],
                    count=count)


@pytest.mark.parametrize("n", [1, 127, 129, 1001])
def test_pairwise_argmin_ragged_n_in_place(cuda, n, monkeypatch):
    """Any n, read in place: only the center slots pad, and the points may
    start at any row of a larger buffer (296-byte rows, 8-byte aligned)."""
    padded = []
    pad = ops._pad_to

    def spy(a, axis, multiple, value):
        padded.append(tuple(a.shape))
        return pad(a, axis, multiple, value)

    monkeypatch.setattr(ops, "_pad_to", spy)
    rng = np.random.default_rng(n)
    buf = torch.tensor(rng.normal(size=(n + 3, 74)), dtype=torch.float32,
                       device=cuda)
    x = buf[3:]
    c = torch.tensor(rng.normal(size=(77, 74)), dtype=torch.float32,
                     device=cuda)
    d2, idx = ops.pairwise_argmin(x, c)
    torch.cuda.synchronize()
    assert padded == [(77, 74)] and d2.shape == idx.shape == (n,)
    _close_to_plain(x, c, d2, idx)


@pytest.mark.parametrize("dtype,d", [
    (dtype, d) for dtype in (torch.float32, torch.bfloat16)
    for d in (5, 33, 74, 200, 400 if dtype == torch.float32 else 1000,
              "max")])
def test_pairwise_argmin_widths(cuda, d, dtype):
    """d from 5 to the widest the kernel takes (`MAX_D`: its point tile
    of 32 rows), which runs each of its three tile heights; one past it
    raises."""
    from repro_torch.kernels import pairwise_argmin_cuda as binding

    d = binding.MAX_D[dtype] if d == "max" else d
    rng = np.random.default_rng(d)
    x = torch.tensor(rng.normal(size=(700, d)), dtype=dtype, device=cuda)
    c = torch.tensor(rng.normal(size=(300, d)), dtype=dtype, device=cuda)
    d2, idx = ops.pairwise_argmin(x, c)
    torch.cuda.synchronize()
    _close_to_plain(x, c, d2, idx)
    if d == binding.MAX_D[dtype]:
        wide = torch.zeros((4, d + 1), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match="d must be in"):
            ops.pairwise_argmin(wide, wide)


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 700), k=st.integers(1, 700), d=st.integers(1, 96),
       frac=st.floats(0.0, 1.0), bf16=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_pairwise_argmin_count_property(n, k, d, frac, bf16, seed):
    """Any shape and live count: the count sweep equals the full sweep bit
    for bit, and both agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(seed)
    count = int(round(frac * (k + 3)))
    x = torch.tensor(rng.normal(size=(n, d)), dtype=dtype, device=dev)
    c = _far_slots(torch.tensor(rng.normal(size=(k, d)), dtype=dtype,
                                device=dev), count)
    got = ops.pairwise_argmin(x, c, count)
    full = ops.pairwise_argmin(x, c)
    torch.cuda.synchronize()
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    _close_to_plain(x, ops._pad_to(c, 0, 128, ops._PAD_FAR), *got,
                    count=count)


def test_kmeans_parallel_rounds_count_equals_full_sweep(cuda, monkeypatch):
    """The rounds on the card with each round's live count give the same
    `sel` and `d2` as with every round sweeping all its slots."""
    rng = np.random.default_rng(5)
    ctr = rng.normal(size=(40, 74)) * 12
    pts = torch.tensor(ctr[rng.integers(40, size=30_000)]
                       + rng.normal(size=(30_000, 74)), dtype=torch.float32,
                       device=cuda)

    def run():
        return ds.device_kmeans_parallel_rounds(
            pts, torch.Generator(device=cuda).manual_seed(4), 256.0,
            rounds=5, cap=1024)

    sel, d2 = run()
    full_sweep = ops.pairwise_argmin
    monkeypatch.setattr(ds.ops, "pairwise_argmin",
                        lambda x, c, count=None: full_sweep(x, c))
    sel_full, d2_full = run()
    assert torch.equal(sel, sel_full) and torch.equal(d2, d2_full)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("block_n", [128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(5, 3), (1000, 74), (513, 128), (1001, 1),
                                 (777, 3), (1300, 68), (2049, 90),
                                 (300, 1000), (70, 4097)])
def test_d2_update_kernels(cuda, n, d, dtype, block_n, offset):
    """Both entries against the plain version at n that no tile divides,
    d from 1 to 4097 (the wide rows streamed in pieces), on x and w in
    place or as offset views (`big[1:]`, x 4 or 2 bytes and w 4 bytes off
    16-byte alignment): w' to 1e-5, tile sums to rtol 1e-5 of the plain ones and of a float64 sum
    of w', lanes past n exactly 0, and a second launch bit-identical."""
    rng = np.random.default_rng(n * d)
    big = torch.tensor(rng.normal(size=n * d + offset), dtype=dtype,
                       device=cuda)
    x = big[offset:].view(n, d)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    ctr = torch.tensor(rng.normal(size=(d,)), dtype=dtype, device=cuda)
    w = torch.tensor(rng.uniform(0, 4 * d, size=n + offset),
                     dtype=torch.float32, device=cuda)[offset:]
    out = ops.d2_update(x, ctr, w)
    tiles, sums = ops.d2_update_tiles(x, ctr, w, block_n=block_n)
    again = ops.d2_update(x, ctr, w)
    tiles2, sums2 = ops.d2_update_tiles(x, ctr, w, block_n=block_n)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.d2_update_ref(x, ctr, w), rtol=1e-5,
                               atol=1e-5)
    n_pad = -(-n // block_n) * block_n
    assert tiles.shape == (n_pad,) and sums.shape == (n_pad // block_n,)
    pw, psums = ref.d2_update_tiles_ref(ops._pad_to(x, 0, block_n, 0.0), ctr,
                                        ops._pad_to(w, 0, block_n, 0.0),
                                        block_n=block_n)
    torch.testing.assert_close(tiles, pw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sums, psums, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(
        sums.double(), tiles.double().reshape(-1, block_n).sum(dim=1),
        rtol=1e-5, atol=0.0)
    assert (tiles[n:] == 0.0).all()
    assert torch.equal(out, again)
    assert torch.equal(tiles, tiles2) and torch.equal(sums, sums2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_n", [128, 512])
def test_d2_update_tiles_copies_no_x(cuda, dtype, block_n):
    """The tiles wrapper pads nothing on the card: at a ragged n, the call
    allocates only its outputs and scratch, far less than x's bytes."""
    n, d = 100_003, 74
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    w = torch.rand(n, generator=gen, device=cuda) * d
    ctr = x[11].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    tiles, sums = ops.d2_update_tiles(x, ctr, w, block_n=block_n)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(cuda) - before
    n_pad = -(-n // block_n) * block_n
    assert tiles.shape == (n_pad,) and sums.shape == (n_pad // block_n,)
    assert grew < x.numel() * x.element_size() // 8, grew


def test_kmeans_parallel_plan_runs_through_the_kernel(cuda):
    """One `pairwise_argmin` launch per round, k distinct indices on the
    card, and one seed replays."""
    rng = np.random.default_rng(2)
    ctr = rng.normal(size=(40, 8)) * 40
    pts = ctr[rng.integers(40, size=20_000)] + rng.normal(size=(20_000, 8))
    plan = ClusterPlan(ClusterSpec(k=64, seeder="kmeans||",
                                   options={"rounds": 4}),
                       ExecutionSpec(backend="device"))
    ops.reset_launch_counts()
    res = plan.fit(pts)
    counts = ops.launch_counts()
    assert counts["pairwise_argmin"] == 4
    assert sum(counts.values()) == 4
    assert res.indices.is_cuda and len(torch.unique(res.indices)) == 64
    assert torch.isfinite(res.cost) and float(res.cost) > 0
    for _ in range(2):
        torch.testing.assert_close(plan.refit(seed=0).indices, res.indices,
                                   rtol=0, atol=0)
    sel, d2 = ds.device_kmeans_parallel_rounds(
        plan.prepare_data(pts).artifacts,
        torch.Generator(device=cuda).manual_seed(3), 128.0, rounds=4,
        cap=512)
    again = ds.device_kmeans_parallel_rounds(
        plan.prepare_data(pts).artifacts,
        torch.Generator(device=cuda).manual_seed(3), 128.0, rounds=4,
        cap=512)
    assert torch.equal(sel, again[0]) and torch.equal(d2, again[1])


def _attn_inputs(b, s, h, hk, d, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, n, d), generator=gen, device=dev).to(dtype)
            for n in (h, hk, hk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,causal", [
    (4, 256, 64, True), (2, 256, 32, False), (3, 512, 128, True),
    (1, 128, 16, True), (2, 200, 74, True), (3, 333, 256, False),
    (1, 1, 8, True)])
def test_flash_attention_kernel(cuda, bh, s, d, causal, dtype):
    """The (BH, S, D) entry against exact softmax on the same inputs:
    ragged S, D up to 256, f32 and bf16 (widened exactly, so f32 rounding
    only: 2e-5)."""
    q, k, v = (t[:, :, 0] for t in _attn_inputs(bh, s, 1, 1, d, dtype,
                                                 cuda, s + d))
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (bh, s, d)
    plain = ref.flash_attention_ref(q, k, v, scale=d ** -0.5, causal=causal)
    torch.testing.assert_close(out, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,causal", [
    (2, 256, 8, 8, True), (2, 256, 8, 2, False), (1, 2048, 32, 4, True),
    (3, 200, 4, 1, True)])
def test_attention_bshd_kernel(cuda, b, s, h, hk, causal, dtype):
    """The model's (B, S, H, D) entry with GQA against the chunked scan;
    q is a strided view (every other head of a wider tensor), read in
    place."""
    d = 128
    q2, k, v = _attn_inputs(b, s, 2 * h, hk, d, dtype, cuda, s + h)
    q = q2[:, :, ::2]
    assert not q.is_contiguous()
    out = ops.attention_bshd(q, k, v, scale=d ** -0.5, causal=causal)
    plain = ref.attention_bshd_ref(q, k, v, scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=2e-5, atol=2e-5)


def test_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced yi-9b in f32 with the same weights on the card and on the
    CPU: prefill logits to 1e-3 (summation order, as against the JAX
    package), the same greedy tokens, one kernel launch per layer."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params, param_specs, params_from_numpy
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    cfg = reduce_for_smoke(get_config("yi-9b"))
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    on_card = params_from_numpy(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (3, 64)))
    ops.reset_launch_counts()
    lg_card, _ = prefill(on_card, cfg, {"tokens": toks.to(cuda)},
                         max_seq=80)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    lg_cpu, _ = prefill(params, cfg, {"tokens": toks}, max_seq=80)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=1e-3, atol=1e-3)
    serve = ServeConfig(max_new_tokens=8, max_seq=80)
    np.testing.assert_array_equal(
        Engine(on_card, cfg, serve).generate(toks.numpy()),
        Engine(params, cfg, serve, device="cpu").generate(toks.numpy()))


# The serving path's tolerance (chip_smoke.py): the bf16 route splits p into
# two bf16 terms, so it is carried to about 2^-17 of each term.
ATTN_TOL = 1e-4
GRID_D = (64, 80, 128, 256)
GRID_S = (1, 63, 64, 65, 1000, 2048)
GRID = [(entry, d, s, g, causal, dtype)
        for entry, groups in (("bshd", (1, 8)), ("flat", (1,)))
        for d in GRID_D for s in GRID_S for g in groups
        for causal in (True, False)
        for dtype in (torch.bfloat16, torch.float32)]


def _grid_id(case):
    entry, d, s, g, causal, dtype = case
    return (f"{entry}-d{d}-s{s}-g{g}-{'causal' if causal else 'full'}-"
            f"{str(dtype)[6:]}")


@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_flash_attention_grid(cuda, case):
    """Both entries against their plain versions within `ATTN_TOL`.  The
    (B, S, H, D) entry reads q, k and v as strided views of one packed qkv
    tensor (2 KV heads, 2 g query heads); the (BH, S, D) entry reads views
    at an odd column offset of a wider tensor, so the pointers are not
    16-byte aligned and the tiles load element by element."""
    entry, d, s, g, causal, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(d * 10_000 + s + g)
    before = ops.launch_counts()["flash_attention"]
    if entry == "bshd":
        hk = 2
        qkv = torch.randn((1, s, hk * (g + 2), d), generator=gen,
                          device=cuda).to(dtype)
        q, k, v = qkv[:, :, :hk * g], qkv[:, :, hk * g:hk * (g + 1)], \
            qkv[:, :, hk * (g + 1):]
        out = ops.attention_bshd(q, k, v, scale=d ** -0.5, causal=causal)
        plain = ref.attention_bshd_ref(q, k, v, scale=d ** -0.5,
                                       causal=causal)
    else:
        wide = torch.randn((3, 3, s, d + 9), generator=gen,
                           device=cuda).to(dtype)
        q, k, v = (wide[i, :, :, 1:d + 1] for i in range(3))
        out = ops.flash_attention(q, k, v, scale=d ** -0.5, causal=causal)
        plain = ref.flash_attention_ref(q, k, v, scale=d ** -0.5,
                                        causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.dtype == torch.float32 and out.shape == plain.shape
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, plain, rtol=ATTN_TOL, atol=ATTN_TOL)


LSH_GRID = [(b, count, False) for b in (8, 32, 512)
            for count in (1, 31, 32, 33, 500, 1024)] + \
    [(b, 1024, True) for b in (8, 32, 512)]


@pytest.mark.parametrize("which", ["accept", "min"])
@pytest.mark.parametrize("b,count,miss", LSH_GRID)
def test_lsh_query_grid(cuda, b, count, miss, which):
    """The LSH queries against their plain versions (rtol 1e-5, `LSH_MISS`
    lanes exactly) at K = 1024 slots, d = 74, L = 15, over B and the live
    count, with an all-miss case; a second launch on the same inputs gives
    bit-identical outputs (the min over slot chunks does not depend on the
    order of evaluation)."""
    k, l, d = 1024, 15, 74
    rng = np.random.default_rng(b * 7 + count)
    qk = rng.integers(-5, 5, size=(2, l, b)).astype(np.int32)
    ck = rng.integers(-5, 5, size=(2, l, k)).astype(np.int32) + (
        100 if miss else 0)
    arrays = (qk[0], qk[1], rng.normal(size=(b, d)).astype(np.float32),
              ck[0], ck[1], rng.normal(size=(k, d)).astype(np.float32),
              rng.uniform(0, 3, size=b).astype(np.float32))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    args[-1][::5] = 0.0
    if which == "accept":
        runs = [ops.lsh_bucket_accept(*args, count, c2=1.44)
                for _ in range(2)]
        plain = ref.lsh_bucket_accept_ref(*args, count, c2=1.44)
    else:
        runs = [(ops.lsh_bucket_min(*args[:6], count),) for _ in range(2)]
        plain = (ref.lsh_bucket_min_ref(*args[:6], count),)
    torch.cuda.synchronize()
    for got, again in zip(*runs):
        assert torch.equal(got, again)
    miss_lanes = plain[0] == ref.LSH_MISS
    assert torch.equal(runs[0][0] == ref.LSH_MISS, miss_lanes)
    if miss:
        assert miss_lanes.all()
    else:
        assert not miss_lanes.all() or count == 1
    torch.testing.assert_close(runs[0][0][~miss_lanes],
                               plain[0][~miss_lanes], rtol=1e-5, atol=1e-5)
    if which == "accept":
        torch.testing.assert_close(runs[0][1], plain[1], rtol=1e-5,
                                   atol=1e-5)
        assert (runs[0][1][::5] == 0.0).all()


def _card_mixture(seed, n=20_000, d=8, k_true=40):
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(k_true, d)) * 40
    return ctr[rng.integers(k_true, size=n)] + rng.normal(size=(n, d))


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++", "kmeans||"])
def test_legacy_fit_matches_the_plan_on_the_card(cuda, seeder):
    """The legacy `fit` on the device backend opens the plan's centers for
    the same seed, through the same kernels."""
    import warnings

    from repro_torch.core import KMeansConfig, fit

    pts = _card_mixture(4)
    plan = ClusterPlan(ClusterSpec(k=48, seeder=seeder, seed=3),
                       ExecutionSpec(backend="device"))
    new = plan.fit(pts)
    ops.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        old = fit(pts, KMeansConfig(k=48, seeder=seeder, seed=3))
    counts = ops.launch_counts()
    np.testing.assert_array_equal(new.indices.cpu().numpy().astype(np.int64),
                                  old.seeding.indices)
    if seeder == "kmeans||":
        assert counts["pairwise_argmin"] == 5
    else:
        assert counts["tree_sep_update"] == 2 * 48
        assert counts["tree_sep_update_tiles"] == 48
    assert (counts["lsh_bucket_accept"] >= 47) == (seeder == "rejection")


@pytest.mark.parametrize("seeder", ["rejection", "kmeans||"])
def test_fit_batch_lanes_equal_refits_on_the_card(cuda, seeder):
    pts = _card_mixture(5)
    plan = ClusterPlan(ClusterSpec(k=32, seeder=seeder),
                       ExecutionSpec(backend="device"))
    plan.prepare(pts)
    ops.reset_launch_counts()
    b = plan.fit_batch([0, 1, 2, 3])
    batch_counts = ops.launch_counts()
    assert b.indices.is_cuda and tuple(b.indices.shape) == (4, 32)
    refits = []
    for i in range(4):
        ops.reset_launch_counts()
        lane = plan.refit(seed=i)
        refits.append(ops.launch_counts())
        assert torch.equal(b.indices[i], lane.indices)
        assert torch.equal(b.cost[i], lane.cost)
    if seeder == "rejection":
        # One lane-batched solve: each sweep launches once a center for
        # all four lanes, the accept kernel once a round for the lanes
        # still drawing.
        lsh = [c["lsh_bucket_accept"] for c in refits]
        assert batch_counts["tree_sep_update"] == 2 * 32
        assert batch_counts["tree_sep_update_tiles"] == 32
        assert max(lsh) <= batch_counts["lsh_bucket_accept"] <= sum(lsh)
        assert b.extras["vmapped"] is True
    else:                    # k-means|| keeps the loop of refits
        assert batch_counts == {name: sum(c[name] for c in refits)
                                for name in batch_counts}


def test_no_retrace_holds_around_refits_on_the_card(cuda):
    """After a warm-up fit has built and loaded every kernel library,
    refits and `fit_batch` count no build."""
    from repro_torch.core import no_retrace

    plan = ClusterPlan(ClusterSpec(k=16), ExecutionSpec(backend="device"))
    plan.fit(_card_mixture(6, n=5000))
    with no_retrace():
        plan.refit(seed=1)
        plan.refit(seed=2)
        plan.fit_batch([3, 4])


# -- stacked lanes: the lane axis of the three kernels ------------------------

def _lane_planes(b, h, n, seed, dev, shared):
    """(B, H, n) code planes (an `expand`ed stride-0 lane axis when
    `shared`), x (B,) int64 and w (B, n) on the card."""
    planes = [_codes(h, n, seed + (0 if shared else j), dev)
              for j in range(1 if shared else b)]
    lo = torch.stack([p[0] for p in planes])
    hi = torch.stack([p[1] for p in planes])
    if shared:
        lo, hi = lo.expand(b, h, n), hi.expand(b, h, n)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, n, size=b), device=dev)
    w = torch.as_tensor(rng.uniform(0, 1e8, size=(b, n)).astype(np.float32),
                        device=dev)
    return lo, hi, x, w


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b,h,n,tile", [(1, 11, 1024, 512), (4, 11, 4096, 512),
                                        (3, 59, 384, 128), (8, 14, 1536, 512)])
def test_stacked_sweep_kernels_equal_one_lane_launches(cuda, b, h, n, tile,
                                                       shared):
    lo, hi, x, w = _lane_planes(b, h, n, b * n + h, cuda, shared)
    kw = dict(scale=7.5 * 3 ** 0.5, num_levels=h + 1)
    before = ops.launch_counts()
    out = ops.tree_sep_update_lanes(lo, hi, x, w, **kw)
    tout, tsums = ops.tree_sep_update_tiles_lanes(lo, hi, x, w, block_n=tile,
                                                  **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["tree_sep_update"] == before["tree_sep_update"] + 1
    assert after["tree_sep_update_tiles"] == \
        before["tree_sep_update_tiles"] + 1
    assert torch.equal(out, ref.tree_sep_update_lanes_ref(lo, hi, x, w, **kw))
    plain, psums = ref.tree_sep_update_tiles_lanes_ref(lo, hi, x, w,
                                                       block_n=tile, **kw)
    assert torch.equal(tout, plain)
    torch.testing.assert_close(tsums, psums, rtol=1e-5, atol=0.0)
    for j, xj in enumerate(x.tolist()):
        col = (lo[j][:, xj], hi[j][:, xj])
        assert torch.equal(out[j], ops.tree_sep_update(lo[j], hi[j], *col,
                                                       w[j], **kw))
        one, one_sums = ops.tree_sep_update_tiles(lo[j], hi[j], *col, w[j],
                                                  block_n=tile, **kw)
        assert torch.equal(tout[j], one) and torch.equal(tsums[j], one_sums)
        assert float(out[j, xj]) == 0.0


def test_stacked_sweep_kernels_take_a_lane_of_a_larger_stack(cuda):
    """The seeders pass tree t of (B, T, H-1, n) codes: a strided lane
    axis over contiguous planes."""
    codes = [_codes(11, 2048, 40 + j, cuda) for j in range(3 * 3)]
    lo = torch.stack([c[0] for c in codes]).reshape(3, 3, 11, 2048)
    hi = torch.stack([c[1] for c in codes]).reshape(3, 3, 11, 2048)
    x = torch.tensor([5, 0, 2047], device=cuda)
    w = torch.rand(3, 2048, device=cuda) * 1e6
    kw = dict(scale=2.0, num_levels=12)
    out = ops.tree_sep_update_lanes(lo[:, 1], hi[:, 1], x, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.tree_sep_update_lanes_ref(lo[:, 1], hi[:, 1],
                                                          x, w, **kw))


@pytest.mark.parametrize("sizes,count", [((512, 512, 512, 512), 500),
                                         ((32, 0, 256, 64), 999),
                                         ((128,), 0), ((7, 300), 1000)])
def test_stacked_lsh_kernel_equals_one_lane_launches(cuda, sizes, count):
    b, k, l, d = len(sizes), 1000, 15, 74
    rng = np.random.default_rng(sum(sizes) + count)
    s = sum(sizes)
    lanes = torch.as_tensor(np.repeat(np.arange(b), sizes), device=cuda)
    arrays = (rng.integers(-5, 5, size=(l, s)).astype(np.int32),
              rng.integers(-5, 5, size=(l, s)).astype(np.int32),
              rng.normal(size=(s, d)).astype(np.float32),
              rng.integers(-5, 5, size=(b, l, k)).astype(np.int32),
              rng.integers(-5, 5, size=(b, l, k)).astype(np.int32),
              rng.normal(size=(b, k, d)).astype(np.float32),
              rng.uniform(0, 3, size=s).astype(np.float32))
    qlo, qhi, q, clo, chi, c, mtd2 = (torch.from_numpy(a).to(cuda)
                                      for a in arrays)
    mtd2[::5] = 0.0
    before = ops.launch_counts()["lsh_bucket_accept"]
    d2, p = ops.lsh_bucket_accept_lanes(qlo, qhi, q, lanes, clo, chi, c, mtd2,
                                        count, c2=1.44)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lsh_bucket_accept"] == before + 1
    pd2, pp = ref.lsh_bucket_accept_lanes_penalty_ref(
        qlo, qhi, q, lanes, clo, chi, c, ops.penalty_row(k, count, cuda),
        mtd2, c2=1.44)
    miss = pd2 == ref.LSH_MISS
    assert torch.equal(d2 == ref.LSH_MISS, miss)
    torch.testing.assert_close(d2[~miss], pd2[~miss], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(p, pp, rtol=1e-5, atol=1e-5)
    start = 0
    for j, size in enumerate(sizes):
        seg = slice(start, start + size)
        one = ops.lsh_bucket_accept(qlo[:, seg].contiguous(),
                                    qhi[:, seg].contiguous(), q[seg], clo[j],
                                    chi[j], c[j], mtd2[seg], count, c2=1.44)
        assert torch.equal(d2[seg], one[0]) and torch.equal(p[seg], one[1])
        start += size


def test_stacked_sampler_equals_one_lane_sampler(cuda):
    """The lane-batched descent and the per-lane cumsum draw each lane's
    block exactly as `TiledSampleTree.sample` draws it alone."""
    from repro_torch.core.sample_tree import TiledSampleTree

    ts = TiledSampleTree(311_029, tile=512)
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.rand(4, ts.n_pad, generator=gen, device=cuda)
    w[:, 311_029:] = 0.0
    w[2, :200_000] = 0.0
    heaps = torch.stack([ts.init(w[j].clone()) for j in range(4)])
    for sizes in ((512, 512, 512, 512), (32, 0, 256, 64), (1, 1, 1, 1)):
        lanes = torch.as_tensor(np.repeat(np.arange(4), sizes), device=cuda)
        gens = [torch.Generator(device=cuda).manual_seed(10 + j)
                for j in range(4)]
        cand = ts.sample_lanes(heaps, w, gens, sizes, lanes)
        start = 0
        for j, size in enumerate(sizes):
            if size:
                one = ts.sample(heaps[j], w[j].clone(),
                                torch.Generator(device=cuda).manual_seed(
                                    10 + j), size)
                assert torch.equal(cand[start: start + size], one), (sizes, j)
            start += size


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_stacked_seeds_lanes_equal_refits_on_the_card(cuda, seeder):
    plan = ClusterPlan(ClusterSpec(k=48, seeder=seeder, seed=3),
                       ExecutionSpec(backend="device"))
    plan.prepare(_card_mixture(7))
    batch = plan.fit_batch([3, 5, 6, 0, 9])
    assert batch.extras["vmapped"] is True
    for i, s in enumerate((3, 5, 6, 0, 9)):
        lane = plan.refit(seed=s)
        assert torch.equal(batch.indices[i], lane.indices)
        assert torch.equal(batch.centers[i], lane.centers)
        if seeder == "rejection":
            assert torch.equal(batch.extras["trials"][i],
                               lane.extras["trials"])
    assert torch.equal(plan.fit_batch([9]).indices[0], batch.indices[4])


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_stacked_datasets_equal_one_lane_fits_on_the_card(cuda, seeder):
    datasets = [_card_mixture(20, n=20_000), _card_mixture(21, n=30_000),
                _card_mixture(22, n=9_000), _card_mixture(23, n=31_000)]
    plan = ClusterPlan(ClusterSpec(k=40, seeder=seeder, seed=1),
                       ExecutionSpec(backend="device"))
    ops.reset_launch_counts()
    batch = plan.fit_batch(datasets=datasets, seeds=[1, 2, 3, 4])
    counts = ops.launch_counts()
    assert batch.extras["stacked"] and batch.extras["shape_buckets"] == 2
    assert batch.extras["bucket_rows"] == (32768, 32768, 16384, 32768)
    assert batch.extras["lane_rows"] == (20_000, 30_000, 9_000, 31_000)
    # One solve per bucket: 2 sweeps and a tiles sweep a center each.
    assert counts["tree_sep_update"] == 2 * 2 * 40
    assert counts["tree_sep_update_tiles"] == 2 * 40
    for i, (x, s) in enumerate(zip(datasets, (1, 2, 3, 4))):
        solo = plan.fit_batch(datasets=[x], seeds=[s])
        assert torch.equal(batch.indices[i], solo.indices[0])
        assert torch.equal(batch.cost[i], solo.cost[0])
        assert int(batch.indices[i].max()) < len(x)
        assert len(torch.unique(batch.indices[i])) == 40


# -- streaming (`-k streaming`) -----------------------------------------------

def _stream_plan(seeder="rejection", k=24, seed=0):
    return ClusterPlan(ClusterSpec(k=k, seeder=seeder, seed=seed),
                       ExecutionSpec(backend="device"))


def test_streaming_patched_heap_equals_init_on_the_card(cuda):
    """Three thousand random extends and retires, crossing three capacity
    rungs: `w0` is m_init on exactly the live rows and the patched heap is
    `ts.init(w0)` bit for bit."""
    pts = _card_mixture(30, n=3_000)
    plan = _stream_plan()
    prep = plan.prepare_streaming(pts[:1_000])
    state = prep.streaming
    rng = np.random.default_rng(30)
    for step in range(3_000):
        if step % 3 < 2:
            rows = pts[rng.integers(0, 1_000, size=rng.integers(1, 4))]
            plan.extend(rows, prepared=prep)
        else:
            live = state.live_ids()
            plan.retire(rng.choice(live, size=rng.integers(1, 3),
                                   replace=False), prepared=prep)
    assert state.capacity == 8192 and state.rebuilds == 0
    want = torch.zeros(state.ts.n_pad, device=cuda)
    want[:state.capacity] = torch.as_tensor(
        state.live, dtype=torch.float32, device=cuda) * state.statics[2]
    assert torch.equal(state.w0, want)
    assert torch.equal(state.base_heap, state.ts.init(state.w0))


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_streaming_refit_replays_one_seed_on_the_card(cuda, seeder):
    pts = _card_mixture(31, n=12_000)
    plan = _stream_plan(seeder)
    prep = plan.prepare_streaming(pts[:8_000])
    plan.extend(pts[8_000:], prepared=prep)
    plan.retire(np.arange(0, 12_000, 5), prepared=prep)
    first = plan.fit_prepared(prep, seed=4)
    assert torch.equal(plan.fit_prepared(prep, seed=4).indices,
                       first.indices)


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_streaming_scratch_equivalence_on_the_card(cuda, seeder):
    pts = _card_mixture(32, n=6_000)
    dups = pts[np.random.default_rng(32).integers(0, 6_000, size=2_500)]
    plan = _stream_plan(seeder)
    inc = plan.prepare_streaming(pts)
    plan.extend(dups, prepared=inc)
    scratch = plan.prepare_streaming(np.concatenate([pts, dups]))
    si, ss = inc.streaming, scratch.streaming
    assert si.rebuilds == 0 and si.capacity == ss.capacity == 16384
    for name in ("codes_lo", "codes_hi", "keys_lo", "keys_hi", "pts_scaled",
                 "w0", "base_heap"):
        a, b = getattr(si, name), getattr(ss, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(plan.fit_prepared(inc, seed=2).indices,
                       plan.fit_prepared(scratch, seed=2).indices)


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_streaming_refit_indices_are_live_on_the_card(cuda, seeder):
    """After extends, retires and an extend out of the domain, refits open
    only live rows, distinct, through the kernels."""
    pts = _card_mixture(33, n=10_000)
    plan = _stream_plan(seeder, k=40)
    prep = plan.prepare_streaming(pts[:6_000])
    plan.extend(pts[6_000:], prepared=prep)
    plan.retire(np.random.default_rng(33).choice(10_000, 4_000,
                                                 replace=False),
                prepared=prep)
    state = prep.streaming
    plan.extend(pts[:100] + 2.0 / state.scale, prepared=prep)
    assert state.rebuilds == 1
    for s in range(4):
        ops.reset_launch_counts()
        res = plan.fit_prepared(prep, seed=s)
        torch.cuda.synchronize()
        assert ops.launch_counts()["tree_sep_update_tiles"] == 40
        idx = res.indices.cpu().numpy()
        assert res.indices.is_cuda and len(np.unique(idx)) == 40
        assert state.live[idx].all()


# -- the clustering service (`-k service`) ------------------------------------

def test_service_engine_pipelined_equals_serial_on_the_card(cuda):
    """Two prepare workers uploading while the solve worker launches, on
    the default stream: every ticket equals the serial prepare + solve."""
    from repro_torch.core import ClusterEngine

    spec = ClusterSpec(k=32, seeder="rejection", seed=0)
    exe = ExecutionSpec(backend="device")
    datasets = [_card_mixture(40 + i, n=20_000 + 3_000 * i)
                for i in range(3)]
    ops.reset_launch_counts()
    with ClusterEngine(spec, exe, prepare_workers=2) as engine:
        tickets = [engine.submit(x, seed=s) for x in datasets
                   for s in (0, 1)]
        results = [t.result(timeout=300) for t in tickets]
    counts = ops.launch_counts()
    assert counts["tree_sep_update_tiles"] == 6 * 32
    assert counts["lsh_bucket_accept"] >= 6 * 31
    serial = ClusterPlan(spec, exe)
    for i, x in enumerate(datasets):
        prep = serial.prepare_data(x)
        for j, s in enumerate((0, 1)):
            want = serial.fit_prepared(prep, seed=s)
            got = results[2 * i + j]
            assert got.indices.is_cuda
            assert torch.equal(got.indices, want.indices)
            assert torch.equal(got.centers, want.centers)
            assert torch.equal(got.cost, want.cost)


def test_service_real_oom_is_transient_and_released_on_the_card(cuda):
    """A real out-of-memory on the solve (the allocator capped just above
    what is reserved) is transient; the failed attempt's tensors are
    released before the retry (which succeeds once the cap is lifted, on
    the retry's own seed) and after a ticket fails with it; the request
    then equals its uncapped fit."""
    from repro_torch.core import (ClusterEngine, RetryPolicy, attempt_seed,
                                  classify_failure)

    spec = ClusterSpec(k=256, seeder="rejection", seed=0)
    exe = ExecutionSpec(backend="device")
    pts = _card_mixture(50, n=70_000)       # the cost's (65536, 256) chunk
    total = torch.cuda.get_device_properties(cuda).total_memory

    class Cap:
        """The plan's fault hook: records the memory allocated at each
        solve's start once armed, and lifts the cap at call `lift`."""

        def __init__(self):
            self.seen, self.lift = None, None

        def arm(self, lift=None):
            torch.cuda.empty_cache()
            self.seen, self.lift = [], lift
            torch.cuda.set_per_process_memory_fraction(
                (torch.cuda.memory_reserved() + (8 << 20)) / total)
            return torch.cuda.memory_allocated()

        def inject(self, stage, key):
            if stage == "solve" and self.seen is not None:
                self.seen.append(torch.cuda.memory_allocated())
                if len(self.seen) == self.lift:
                    torch.cuda.set_per_process_memory_fraction(1.0)

    cap = Cap()
    try:
        with ClusterEngine(spec, exe, degrade=False,
                           fault_plan=cap) as engine:
            want = engine.submit(pts).result(timeout=300)
            before = cap.arm(lift=2)
            res = engine.submit(pts, retry=RetryPolicy(
                max_attempts=2)).result(timeout=300)
            retry_seen = list(cap.seen)
            before_fail = cap.arm()
            exc = engine.submit(pts).exception(timeout=300)
            torch.cuda.synchronize()
            after_fail = torch.cuda.memory_allocated()
            torch.cuda.set_per_process_memory_fraction(1.0)
            again = engine.submit(pts).result(timeout=300)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert res.extras["attempts"] == 2 and retry_seen == [before, before]
    assert isinstance(exc, torch.cuda.OutOfMemoryError)
    assert classify_failure(exc) == "transient"
    assert after_fail == before_fail
    assert torch.equal(again.indices, want.indices)
    assert torch.equal(again.cost, want.cost)
    plan = ClusterPlan(spec, exe)
    retried = plan.fit_prepared(plan.prepare_data(pts),
                                seed=attempt_seed(None, 1))
    assert torch.equal(res.indices, retried.indices)
    assert torch.equal(res.cost, retried.cost)


def test_service_loopback_fits_through_the_server_on_the_card(cuda):
    """Four requests from a client over loopback, two tenants, coalesced
    into one stacked lane on the card: each answer equals the lane of
    `fit_batch_prepared` over `prepare_stacked` at its seed."""
    from repro_torch.serving.net import (ClusterClient, ClusterServer,
                                         TenantScheduler, parse_tenants)

    spec = ClusterSpec(k=24, seeder="rejection", seed=0)
    exe = ExecutionSpec(backend="device")
    x = _card_mixture(60, n=25_000)
    scheduler = TenantScheduler(parse_tenants("bulk:1000:64:1,rt:1000:64:4"))
    ops.reset_launch_counts()
    with ClusterServer(spec, exe, admission=scheduler, max_batch=4,
                       max_wait_ms=60_000.0) as srv:
        with ClusterClient(*srv.address) as client:
            ids = [client.submit(x, seed=s, tenant=("bulk", "rt")[s % 2])
                   for s in range(4)]
            wire = [client.result(rid, timeout=300) for rid in ids]
            stats = client.stats(timeout=60)
    assert ops.launch_counts()["tree_sep_update_tiles"] == 24
    assert stats["lanes"] == 1 and stats["mean_lane_occupancy"] == 4.0
    plan = ClusterPlan(spec, exe)
    prep = plan.prepare_stacked(x)
    want = plan.fit_batch_prepared([prep] * 4, seeds=[0, 1, 2, 3])
    for i, got in enumerate(wire):
        np.testing.assert_array_equal(got.indices,
                                      want.indices[i].cpu().numpy())
        np.testing.assert_array_equal(got.centers,
                                      want.centers[i].cpu().numpy())
        assert got.cost == float(want.cost[i])
        assert got.extras["lane_size"] == 4


# -- the sharded backend (`-k sharded`) ------------------------------------------

def _sharded_plan(seeder, mesh, k=24, seed=0):
    return ClusterPlan(ClusterSpec(k=k, seeder=seeder, seed=seed),
                       ExecutionSpec(backend="sharded", mesh=mesh))


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: cross-card shards and launches "
                    f"on another card; {torch.cuda.device_count()} visible")


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_sharded_replays_one_seed_on_the_card(cuda, seeder):
    """Four shards on cuda:0: one seed replays the same indices, distinct
    and in range, through the kernels."""
    from repro_torch.launch.mesh import make_seeding_mesh

    pts = _card_mixture(70, n=20_000)
    mesh = make_seeding_mesh(4, device="cuda:0")
    plan = _sharded_plan(seeder, mesh)
    first = plan.fit(pts)
    again = plan.refit(seed=0)
    assert first.extras["devices"] == 4
    assert torch.equal(first.indices, again.indices)
    assert torch.equal(first.cost, again.cost)
    idx = first.indices.cpu().numpy()
    assert len(np.unique(idx)) == 24 and idx.max() < len(pts)


def test_sharded_launch_counts_on_the_card(cuda):
    """Per opened center D x (T-1) `tree_sep_update` and D
    `tree_sep_update_tiles` launches, one `lsh_bucket_accept` a round,
    and D `pairwise_argmin` a k-means|| round."""
    from repro_torch.launch.mesh import make_seeding_mesh

    pts = _card_mixture(71, n=20_000)
    d, k = 4, 24
    mesh = make_seeding_mesh(d, device="cuda:0")
    plan = _sharded_plan("rejection", mesh, k=k)
    plan.prepare(pts)
    t = plan._active.artifacts.codes_lo[0].shape[0]
    ops.reset_launch_counts()
    res = plan.refit(seed=3)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["tree_sep_update"] == d * (t - 1) * k
    assert counts["tree_sep_update_tiles"] == d * k
    assert counts["lsh_bucket_accept"] == sum(
        res.extras["rounds_per_batch"].values())
    km = _sharded_plan("kmeans||", mesh, k=k)
    km.prepare(pts)
    ops.reset_launch_counts()
    km.refit(seed=3)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["pairwise_argmin"] == d * 5
    assert counts["tree_sep_update"] == counts["lsh_bucket_accept"] == 0


@pytest.mark.parametrize("seeder", ["rejection", "fastkmeans++"])
def test_sharded_one_shard_equals_the_device_backend_on_the_card(cuda,
                                                                 seeder):
    from repro_torch.launch.mesh import make_seeding_mesh

    pts = _card_mixture(72, n=20_000)
    sharded = _sharded_plan(seeder, make_seeding_mesh(1)).fit(pts)
    device = ClusterPlan(ClusterSpec(k=24, seeder=seeder, seed=0),
                         ExecutionSpec(backend="device")).fit(pts)
    assert torch.equal(sharded.indices, device.indices)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_sampler_law_on_the_card(cuda, d):
    """The CPU test's shard sampler law on the card: 120,000 draws within
    0.01 of w / total, no zero weight drawn, a whole empty shard
    included."""
    from repro_torch.core import sharded_seeding as shs
    from repro_torch.core.sample_tree import TiledSampleTree
    from repro_torch.launch.mesh import make_seeding_mesh

    tile = 32
    n = d * tile * 4
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 2, size=n).astype(np.float32)
    w[rng.choice(n, n // 5, replace=False)] = 0.0
    if d > 1:
        w[(d - 1) * n // d:] = 0.0
    mesh = make_seeding_mesh(d, device="cuda:0")
    data = shs.ShardedData(mesh=mesh, tile=tile, n_real=n, n_loc=n // d)
    ts_loc = TiledSampleTree(n // d, tile=tile)
    weights = list(torch.from_numpy(w).to(cuda).chunk(d))
    heaps = [ts_loc.init(x) for x in weights]
    g = torch.Generator(device=cuda).manual_seed(0)
    x = shs._shard_sampler(data, ts_loc)(heaps, weights, g, 120_000)[0]
    freq = np.bincount(x.cpu().numpy(), minlength=n) / 120_000
    assert (freq[w == 0.0] == 0.0).all()
    np.testing.assert_allclose(freq, w / w.sum(), atol=0.01)


def test_sharded_kernels_launch_on_their_tensors_device(cuda):
    """Each binding launches on its tensors' card, not the current one:
    every kernel on the last card while cuda:0 is current, against its
    plain version there."""
    _two_cards()
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    lo, hi, w = _codes(14, 1024, 5, last)
    kw = dict(scale=7.5, num_levels=15)
    assert torch.equal(ops.tree_sep_update(lo, hi, lo[:, 3], hi[:, 3], w,
                                           **kw),
                       ref.tree_sep_update_ref(lo, hi, lo[:, 3], hi[:, 3],
                                               w, **kw))
    tw, ts = ops.tree_sep_update_tiles(lo, hi, lo[:, 3], hi[:, 3], w,
                                       block_n=256, **kw)
    pw, pts_ = ref.tree_sep_update_tiles_ref(lo, hi, lo[:, 3], hi[:, 3], w,
                                             block_n=256, **kw)
    assert torch.equal(tw, pw)
    torch.testing.assert_close(ts, pts_, rtol=1e-6, atol=0)
    args = _lsh_args(64, 40, 15, 8, False, last)
    args.append(torch.rand(64, device=last) + 0.5)             # mtd2
    d2, p = ops.lsh_bucket_accept(*args, 30, c2=1.44)
    pd2, pp = ref.lsh_bucket_accept_ref(*args, 30, c2=1.44)
    torch.testing.assert_close(p, pp, rtol=1e-5, atol=1e-5)
    x = torch.randn(3000, 20, device=last)
    c = torch.randn(70, 20, device=last)
    dmin, arg = ops.pairwise_argmin(x, c)
    pmin, parg = ref.pairwise_argmin_ref(x, c)
    torch.testing.assert_close(dmin, pmin, rtol=1e-5, atol=1e-4)
    wd = torch.rand(3000, device=last)
    torch.testing.assert_close(ops.d2_update(x, c[0], wd),
                               ref.d2_update_ref(x, c[0], wd))
    q = torch.randn(2, 64, 4, 32, device=last, dtype=torch.bfloat16)
    kv = torch.randn(2, 64, 2, 32, device=last, dtype=torch.bfloat16)
    out = ops.attention_bshd(q, kv, kv, scale=0.2, causal=True)
    torch.testing.assert_close(out, ref.attention_bshd_ref(
        q, kv, kv, scale=0.2, causal=True), rtol=1e-3, atol=1e-3)
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == 0


def test_sharded_mesh_of_two_cards(cuda):
    """Shards on two cards: the fit runs, replays, and opens distinct
    points; the shards' tensors sit on their cards."""
    _two_cards()
    from repro_torch.launch.mesh import make_seeding_mesh

    mesh = make_seeding_mesh(2)
    assert [d.index for d in mesh.devices] == [0, 1]
    pts = _card_mixture(73, n=20_000)
    for seeder in ("rejection", "fastkmeans++", "kmeans||"):
        plan = _sharded_plan(seeder, mesh)
        first = plan.fit(pts)
        assert torch.equal(plan.refit(seed=0).indices, first.indices)
        assert len(torch.unique(first.indices)) == 24
        data = plan._active.artifacts
        arrays = data.points or data.codes_lo
        assert [a.device.index for a in arrays] == [0, 1]


# ---------------------------------------------------------------------------
# LM variants: MLA's narrower v, MoE, the clustered KV cache.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,causal", [
    (2, 256, 16, 16, True), (1, 1000, 4, 4, False), (1, 333, 8, 2, True)])
def test_lm_variants_attention_with_a_narrower_v(cuda, b, s, h, hk, causal,
                                                 dtype):
    """q, k of head dim 192 and v of 128 (MLA's prefill): both entries
    against their plain versions within `ATTN_TOL`."""
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    q, k = (torch.randn((b, s, n, 192), generator=gen, device=cuda).to(dtype)
            for n in (h, hk))
    v = torch.randn((b, s, hk, 128), generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()["flash_attention"]
    out = ops.attention_bshd(q, k, v, scale=192 ** -0.5, causal=causal)
    plain = ref.attention_bshd_ref(q, k, v, scale=192 ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.shape == (b, s, h, 128) and out.dtype == torch.float32
    torch.testing.assert_close(out, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    flat = ops.flash_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                               scale=0.07, causal=causal)
    flat_plain = ref.flash_attention_ref(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                         scale=0.07, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(flat, flat_plain, rtol=ATTN_TOL, atol=ATTN_TOL)


def _reduced(arch):
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params, param_specs

    cfg = reduce_for_smoke(get_config(arch))
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    return cfg, params


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_lm_variants_apply_moe_on_the_card(cuda, arch):
    """One MoE layer on 2 x 300 tokens (some dropped): two runs on the
    card bit-identical (the ordered combine uses no atomics), and the CPU's
    output to 1e-3 (f32 products in other orders)."""
    from repro_torch.models import moe, params_from_numpy
    from repro_torch.models.model import layer_slice

    cfg, params = _reduced(arch)
    layer = layer_slice(params["groups"]["pos00"], 0)["moe"]
    on_card = params_from_numpy(layer, cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 300, cfg.d_model)).astype(np.float32))
    a, aux_a = moe.apply_moe(on_card, x.to(cuda), cfg)
    b, aux_b = moe.apply_moe(on_card, x.to(cuda), cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    want, aux = moe.apply_moe(layer, x, cfg)
    torch.testing.assert_close(a.cpu(), want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(aux_a.cpu(), aux, rtol=1e-5, atol=1e-7)
    half = params_from_numpy(layer, cuda, torch.bfloat16)
    xb = x.to(cuda, torch.bfloat16)
    assert torch.equal(moe.apply_moe(half, xb, cfg)[0],
                       moe.apply_moe(half, xb, cfg)[0])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_lm_variants_generate_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced model in f32 with the same weights on the card and the CPU:
    prefill logits to 1e-3 with one kernel launch per layer, and the same
    greedy tokens from `generate` (deepseek replays its prompt)."""
    from repro_torch.models import params_from_numpy
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.prefill import prefill

    cfg, params = _reduced(arch)
    on_card = params_from_numpy(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (3, 32)))
    ops.reset_launch_counts()
    lg_card, _ = prefill(on_card, cfg, {"tokens": toks.to(cuda)},
                         max_seq=48)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    lg_cpu, _ = prefill(params, cfg, {"tokens": toks}, max_seq=48)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=1e-3, atol=1e-3)
    serve = ServeConfig(max_new_tokens=8, max_seq=48)
    np.testing.assert_array_equal(
        Engine(on_card, cfg, serve).generate(toks.numpy()),
        Engine(params, cfg, serve, device="cpu").generate(toks.numpy()))


def test_lm_variants_clustered_build_on_the_card(cuda):
    """`build_clustered_cache` on the device backend on the card: 2k
    `tree_sep_update` and k `tree_sep_update_tiles` launches a fit (one fit
    a head), no other kernel; the cache on the card, every kept token in
    one valid slot."""
    from repro_torch.models import cluster_attn as CA

    rng = np.random.default_rng(2)
    keys = torch.from_numpy(rng.normal(size=(1, 512, 2, 32)).astype(
        np.float32)).to(cuda)
    values = torch.from_numpy(rng.normal(size=(1, 512, 2, 32)).astype(
        np.float32)).to(cuda)
    cfg = CA.ClusterKVConfig(num_clusters=16, topc=16, capacity_slack=2.0)
    ops.reset_launch_counts()
    info = {}
    cache = CA.build_clustered_cache(keys, values, cfg, info=info)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["tree_sep_update"] == 2 * 16 * 2
    assert counts["tree_sep_update_tiles"] == 16 * 2
    assert sum(counts.values()) == 3 * 16 * 2
    assert all(t.is_cuda for t in cache.values())
    kept = int(cache["slot_valid"].sum())
    assert kept == round(2 * 512 * (1 - info["dropped_frac"]))
    q = torch.from_numpy(rng.normal(size=(1, 4, 32)).astype(
        np.float32)).to(cuda)
    out = CA.clustered_attention(q, cache, cfg, scale=32 ** -0.5)
    assert out.shape == (1, 4, 32) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# The vlm prefix, the audio inputs, Mamba and RWKV-6.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,prefix", [
    (2, 300, 8, 1, 256, 100), (2, 300, 8, 1, 256, 128),
    (1, 600, 4, 2, 64, 264), (1, 333, 4, 4, 128, 333),
    (1, 200, 4, 1, 80, 77), (1, 257, 2, 1, 64, 127),
    (1, 257, 2, 2, 128, 129), (1, 129, 2, 1, 64, 128),
    (1, 100, 2, 1, 32, 99), (1, 64, 2, 2, 64, 63),
    (1, 200, 2, 1, 64, 300)])
def test_vlm_prefix_attention_kernel(cuda, b, s, h, hk, d, prefix, dtype):
    """The causal kernel with a prefix of full attention against the plain
    version, within `ATTN_TOL`: prefixes that end inside a 128-row query
    block and inside a warp (100, 264, 77), one row either side of a
    block's edge (127, 129), on it (128), one below S (99, and 63 of a
    64-row S, one 64-row block), all of S (333), and past S (300 of 200,
    clamped); sequences one row past a block (129, 257); paligemma's 8
    heads over 1 KV head of 256."""
    q, k, v = _attn_inputs(b, s, h, hk, d, dtype, cuda, s + prefix)
    before = ops.launch_counts()["flash_attention"]
    out = ops.attention_bshd(q, k, v, scale=d ** -0.5, causal=True,
                             prefix_len=prefix)
    plain = ref.attention_bshd_ref(q, k, v, scale=d ** -0.5, causal=True,
                                   prefix_len=prefix)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(out, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    causal = ops.attention_bshd(q, k, v, scale=d ** -0.5, causal=True)
    assert not torch.allclose(out[:, 0], causal[:, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vlm_prefix_of_zero_and_one_is_the_causal_launch(cuda, dtype):
    """A prefix of 0, or of 1 (row 0 sees key 0 either way), gives the
    plain causal launch's bits."""
    q, k, v = _attn_inputs(2, 1000, 8, 1, 256, dtype, cuda, 7)
    causal = ops.attention_bshd(q, k, v, scale=0.0625, causal=True)
    for prefix in (0, 1):
        assert torch.equal(ops.attention_bshd(q, k, v, scale=0.0625,
                                              causal=True,
                                              prefix_len=prefix), causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [333, 1024])
def test_audio_attention_at_head_dim_80(cuda, s, dtype):
    """hubert-xlarge's attention: 16 heads of 80, bidirectional (a prefix
    changes nothing there)."""
    q, k, v = _attn_inputs(2, s, 16, 16, 80, dtype, cuda, s)
    out = ops.attention_bshd(q, k, v, scale=80 ** -0.5, causal=False)
    plain = ref.attention_bshd_ref(q, k, v, scale=80 ** -0.5, causal=False)
    torch.cuda.synchronize()
    assert out.shape == (2, s, 16, 80)
    torch.testing.assert_close(out, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert torch.equal(ops.attention_bshd(q, k, v, scale=80 ** -0.5,
                                          causal=False, prefix_len=100), out)


def _noise_floor(fn, params) -> float:
    """How far `fn`'s f32 output moves on the CPU when every weight is
    scaled by (1 + 1e-7 z), z standard normal from a seed (about one
    rounding of each weight): the largest change over two draws.  A card
    that sums in another order than the CPU differs by about as much."""
    base = fn(params)

    def jitter(tree, gen):
        return {k: jitter(v, gen) if isinstance(v, dict) else
                v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                for k, v in tree.items()}

    return max(float((fn(jitter(params, torch.Generator().manual_seed(s)))
                      - base).abs().max()) for s in (1, 2))


def _close_to_cpu(card, cpu, floor):
    """Card against CPU within 1e-3, or 4 times the CPU's own noise floor
    where the random reduced model amplifies roundings past that (hubert's
    and jamba's logits move by 1e-3 to 3e-3 under the floor's 1e-7 weight
    noise at these shapes)."""
    tol = max(1e-3, 4 * floor)
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=tol)


def test_vlm_and_audio_models_on_the_card_match_the_cpu(cuda):
    """Reduced paligemma-3b's prefill of 16 patches and 16 text tokens and
    reduced hubert-xlarge's forward on 2 x 32 frames, f32, the same
    weights on the card and the CPU: logits to `_close_to_cpu`, one kernel
    launch a layer; paligemma's decode after the prefill likewise."""
    from repro_torch.models import decode_step, forward, params_from_numpy
    from repro_torch.serving.prefill import prefill

    rng = np.random.default_rng(3)
    cfg, params = _reduced("paligemma-3b")
    on_card = params_from_numpy(params, cuda)
    batch = {"patches": torch.from_numpy(rng.normal(
        size=(2, 16, cfg.frontend_dim)).astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16)))}
    ops.reset_launch_counts()
    lg_card, cache = prefill(on_card, cfg, {k: t.to(cuda) for k, t in
                                            batch.items()}, max_seq=40)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers

    def run(p):
        return prefill(p, cfg, batch, max_seq=40)[0]

    lg_cpu, cache_cpu = prefill(params, cfg, batch, max_seq=40)
    _close_to_cpu(lg_card, lg_cpu, _noise_floor(run, params))
    tok = batch["tokens"][:, -1]
    step_card, _ = decode_step(on_card, cfg, tok.to(cuda), cache)
    step_cpu, _ = decode_step(params, cfg, tok, cache_cpu)
    _close_to_cpu(step_card, step_cpu, 0.0)

    cfg, params = _reduced("hubert-xlarge")
    frames = torch.from_numpy(rng.normal(
        size=(2, 32, cfg.frontend_dim)).astype(np.float32))
    ops.reset_launch_counts()
    out_card, _, _ = forward(params_from_numpy(params, cuda), cfg,
                             {"embeddings": frames.to(cuda)})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers

    def encode(p):
        return forward(p, cfg, {"embeddings": frames})[0]

    _close_to_cpu(out_card, encode(params), _noise_floor(encode, params))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_ssm_generate_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced rwkv6-3b and jamba-1.5-large-398b in f32 with the same
    weights on the card and the CPU: the chunked forward's logits to
    `_close_to_cpu` (one kernel launch for jamba's attention layer a
    period, none for rwkv6), and the same greedy tokens from `generate`,
    whose replayed prompt carries the recurrent states in place."""
    from repro_torch.models import forward, params_from_numpy
    from repro_torch.models.transformer import layer_layout
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg, params = _reduced(arch)
    on_card = params_from_numpy(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (3, 32)))
    ops.reset_launch_counts()
    lg_card, _, _ = forward(on_card, cfg, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    layout = layer_layout(cfg)
    attn = sum(bt == "attn" for bt, _ in layout.positions)
    assert ops.launch_counts()["flash_attention"] == attn * layout.num_groups

    def run(p):
        return forward(p, cfg, {"tokens": toks})[0]

    _close_to_cpu(lg_card, run(params), _noise_floor(run, params))
    serve = ServeConfig(max_new_tokens=8, max_seq=48)
    np.testing.assert_array_equal(
        Engine(on_card, cfg, serve).generate(toks.numpy()),
        Engine(params, cfg, serve, device="cpu").generate(toks.numpy()))


# (B, S, H, Hk, D, Dv, dtype, causal, prefix[, "fused"]): "fused" makes
# q, k and v strided views of one (B, S, H + 2 Hk, D) tensor; at D 100 no
# stride is whole 16-byte chunks, so the kernel loads them element by
# element
BWD_CASES = [
    (2, 256, 4, 4, 128, 128, torch.float32, True, 0),
    (2, 333, 4, 2, 64, 64, torch.float32, True, 0),
    (1, 200, 3, 3, 24, 24, torch.float32, False, 0),
    (2, 256, 8, 2, 128, 128, torch.bfloat16, True, 0),
    (1, 300, 4, 4, 192, 128, torch.bfloat16, True, 0),
    (2, 257, 4, 1, 256, 256, torch.bfloat16, True, 100),
    (1, 256, 2, 2, 64, 64, torch.float32, True, 300),
    (2, 256, 4, 4, 80, 80, torch.bfloat16, False, 0),
    (2, 256, 8, 2, 100, 100, torch.bfloat16, True, 0, "fused"),
    (2, 200, 4, 2, 80, 80, torch.bfloat16, True, 0),
]
# a share of the largest |gradient|: f32 sums in other orders; one bf16
# rounding of each gradient (at most 2^-8 of it) for bf16 inputs
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}


def _bwd_inputs(cuda, b, s, h, hk, d, dv, dtype, seed=0, fused=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if fused:       # q, k, v: views of one (B, S, H + 2 Hk, D) tensor
        assert dv == d
        qkv = torch.randn((b, s, h + 2 * hk, d), generator=gen,
                          device=cuda).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]
    else:
        q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                   for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, dv)))
    dout = torch.randn((b, s, h, dv), generator=gen, device=cuda)
    return q, k, v, dout


@pytest.mark.parametrize("case", BWD_CASES)
def test_training_flash_backward_matches_plain_autograd(cuda, case):
    b, s, h, hk, d, dv, dtype, causal, prefix, *layout = case
    q, k, v, dout = _bwd_inputs(cuda, b, s, h, hk, d, dv, dtype,
                                fused=layout == ["fused"])
    kw = dict(scale=d ** -0.5, causal=causal, prefix_len=prefix)
    if layout:      # the gradients of the views themselves
        qkv = torch.cat([q, k, v], dim=2).requires_grad_(True)
        leaves = [qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]]
        assert not any(t.is_contiguous() for t in leaves)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()
    out = ops.attention_bshd(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    now = ops.launch_counts()
    assert now["flash_attention"] == before["flash_attention"] + 1
    assert now["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    again = torch.autograd.grad(ops.attention_bshd(*leaves, **kw), leaves,
                                dout)
    for g, g2 in zip(grads, again):
        assert torch.equal(g, g2)         # no atomics: the same bits
    f32 = [t.float().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(ref.attention_bshd_ref(*f32, **kw), f32,
                                dout)
    for g, p in zip(grads, plain):
        assert g.dtype == dtype and g.shape == p.shape
        err = float((g.float() - p).abs().max()) / float(p.abs().max())
        assert err <= BWD_TOL[dtype], err


@pytest.mark.parametrize("case", BWD_CASES[:1] + BWD_CASES[3:6])
def test_training_forward_lse_leaves_out_unchanged(cuda, case):
    from repro_torch.kernels import flash_attention_cuda as fa_cuda

    b, s, h, hk, d, dv, dtype, causal, prefix = case
    q, k, v, _ = _bwd_inputs(cuda, b, s, h, hk, d, dv, dtype, seed=1)
    kw = dict(scale=d ** -0.5, causal=causal, prefix_len=prefix)
    out, lse = fa_cuda.launch(q, k, v, with_lse=True, **kw)
    assert torch.equal(out, fa_cuda.launch(q, k, v, **kw))
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    g = h // hk
    qf = q.float().permute(0, 2, 1, 3) * kw["scale"]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    scores = qf @ kf.transpose(-1, -2)
    if causal:
        pos = torch.arange(s, device=cuda)
        keep = ref.prefix_causal_mask(pos, pos, prefix)
        scores = scores.masked_fill(~keep, float("-inf"))
    want = torch.logsumexp(scores, dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-9b"])
def test_training_reduced_step_on_the_card_matches_the_cpu(cuda, arch):
    """One `make_train_step` step (f32, remat "block" then "none") of the
    reduced config on the same weights and tokens on the card and the
    CPU: the loss to 1e-5 relative; the gradients' norm to 1e-3 relative
    or 4 times the CPU's own noise floor if larger (the reduced random
    model amplifies f32 roundings: 1e-7 weight noise moves reduced
    yi-9b's norm by about 1e-3 of it), as `_close_to_cpu` holds logits;
    and one forward and one backward kernel launch a layer on the card
    (two forward launches a layer under "block", which recomputes the
    group)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import params_from_numpy
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg, params = _reduced(arch)
    toks = TokenStream(cfg.vocab_size, 64, 4, seed=2).next_batch()
    for remat, fwd in (("block", 2), ("none", 1)):
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=4,
                         remat=remat)
        step = make_train_step(cfg, tc)
        out = {}
        for dev in ("cpu", cuda):
            p = params_from_numpy(params, dev)
            before = ops.launch_counts()
            _, _, m = step(p, init_opt_state(p), {"tokens": toks})
            out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
            now = ops.launch_counts()
            if dev != "cpu":
                assert now["flash_attention"] - before["flash_attention"] \
                    == fwd * cfg.num_layers
                assert now["flash_attention_bwd"] \
                    - before["flash_attention_bwd"] == cfg.num_layers
        (lc, nc), (lg, ng) = out["cpu"], out[str(cuda)]

        def norm(tree):
            p = params_from_numpy(tree, "cpu")      # the step updates p
            return step(p, init_opt_state(p), {"tokens": toks})[2][
                "grad_norm"]

        floor = _noise_floor(norm, params)
        assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
        assert abs(ng - nc) <= max(1e-3 * abs(nc), 4 * floor), (ng, nc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_remat_dots_matches_none_on_the_card(cuda, dtype):
    """Reduced olmo-1b on the card (f32, and bf16 parameters and
    activations), two microbatches: remat "dots" gives the loss and every
    gradient of remat "none" bit for bit (it saves the products and
    recomputes the same ops in the same order; the kernels use no
    atomics), with two forward launches a layer and microbatch (the flash
    kernel's Function is no aten op, so its forward runs again in the
    backward) against none's one, and one backward launch each."""
    import dataclasses

    from repro_torch.configs import TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import params_from_numpy
    from repro_torch.training.train_step import make_grads_fn

    cfg, params = _reduced("olmo-1b")
    name = str(dtype).split(".")[-1]
    cfg = dataclasses.replace(cfg, dtype=name, param_dtype=name)
    p = params_from_numpy(params, cuda, dtype)
    toks = TokenStream(cfg.vocab_size, 1024, 4, seed=3).next_batch()
    out = {}
    for remat, fwd in (("none", 1), ("dots", 2)):
        tc = TrainConfig(learning_rate=1e-3, microbatches=2, remat=remat)
        before = ops.launch_counts()
        loss, _, grads = make_grads_fn(cfg, tc)(p, {"tokens": toks})
        torch.cuda.synchronize()
        now = ops.launch_counts()
        assert now["flash_attention"] - before["flash_attention"] == \
            fwd * 2 * cfg.num_layers
        assert now["flash_attention_bwd"] - before["flash_attention_bwd"] \
            == 2 * cfg.num_layers
        assert torch.isfinite(loss) and all(g.dtype == torch.float32
                                            for g in grads)
        out[remat] = (loss, grads)
    assert torch.equal(out["none"][0], out["dots"][0])
    for a, b in zip(out["none"][1], out["dots"][1]):
        assert torch.equal(a, b)


def test_training_ddp_on_two_cards(cuda, tmp_path):
    """Two NCCL ranks on two cards (spawned; skips on one card):
    `compressed_psum` equal to the ranks' summed q times the largest scale
    over 2, bit for bit, and the uncompressed DDP step on two halves of a
    batch against one rank with the whole batch within f32 rounding."""
    import _torch_dist_workers as workers

    from repro_torch.training.grad_compress import int8_compress

    _two_cards()
    got = workers.spawn_ranks("compressed_psum_body", 2,
                              str(tmp_path / "psum"), backend="nccl", n=4099,
                              seed=5)
    qs, scales = [], []
    for r in got:
        q, s, _ = int8_compress(torch.from_numpy(r["x"]))
        qs.append(q.numpy().astype(np.int32))
        scales.append(np.float32(s))
    want = (np.sum(qs, axis=0).astype(np.float32) * max(scales)) \
        / np.float32(2)
    for r in got:
        np.testing.assert_array_equal(r["value"], want)
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(4, 1)).astype(np.float32)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = x @ np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    kw = dict(x=x, y=y, w0=w0, steps=10, compress=False, backend="nccl")
    two = workers.spawn_ranks("ddp_body", 2, str(tmp_path / "two"), **kw)
    one = workers.spawn_ranks("ddp_body", 1, str(tmp_path / "one"), **kw)[0]
    for r in two:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["w"], one["w"], rtol=1e-5, atol=1e-6)
