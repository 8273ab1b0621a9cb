"""`pairwise_argmin` over the live center slots only, on the CPU.

The port's wrapper takes a live count and sweeps slots 0 .. min(count,
K_pad - 1): the live slots and the first dead one.  Where every dead slot
is the same far row (`_FAR`, 1e17 in every coordinate, as the k-means||
picks and the wrapper's padding leave them), that must give the full
sweep's outputs bit for bit.  Held here against the JAX package's full
sweep (the Pallas kernel in interpret mode) on integer-valued inputs,
where every f32 partial sum is exact so both packages give the same bits,
and against the port's own full sweep on Gaussian inputs; and the
k-means|| rounds with the count against the same rounds without it.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.core import device_seeding as ds
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_argmin_cuda as binding

COUNTS = [0, 1, 127, 128, 129, "K"]
DTYPES = ["float32", "bfloat16"]


def _far_slots(c: np.ndarray, count: int) -> np.ndarray:
    out = c.copy()
    out[count:] = ds._FAR
    return out


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(getattr(torch, dtype))


def _jax(a: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return jnp.asarray(a.astype(ml_dtypes.bfloat16))
    return jnp.asarray(a.astype(np.float32))


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,d", [(300, 300, 6), (129, 257, 74)])
def test_count_sweep_equals_jax_full_sweep(n, k, d, dtype, count):
    """Integer coordinates in -8..8: the live-count sweep, the port's full
    sweep and the JAX package's full sweep give the same bits."""
    count = k if count == "K" else count
    rng = np.random.default_rng(n + k + d)
    x = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    c = _far_slots(rng.integers(-8, 9, size=(k, d)).astype(np.float32),
                   count)
    xt, ct = _tensor(x, dtype), _tensor(c, dtype)
    d2, idx = ops.pairwise_argmin(xt, ct, count)
    full_d2, full_idx = ops.pairwise_argmin(xt, ct)
    jd2, jidx = jops.pairwise_argmin(_jax(x, dtype), _jax(c, dtype),
                                     interpret=True)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    assert d2.shape == idx.shape == (n,)
    assert torch.equal(d2, full_d2) and torch.equal(idx, full_idx)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(idx.max()) <= count


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_count_sweep_equals_full_sweep_on_gaussian_data(dtype, count):
    """Gaussian points at d = 74 against far-padded slots: the count given
    as an int and as a one-element int32 tensor both equal the full
    sweep, bit for bit."""
    n, k, d = 1001, 300, 74
    count = k if count == "K" else count
    rng = np.random.default_rng(count)
    x = _tensor(rng.normal(size=(n, d)) * 12.0, dtype)
    c = _tensor(_far_slots(rng.normal(size=(k, d)) * 12.0, count), dtype)
    full = ops.pairwise_argmin(x, c)
    for live in (count, torch.tensor(count, dtype=torch.int32)):
        got = ops.pairwise_argmin(x, c, live)
        assert all(torch.equal(a, b) for a, b in zip(got, full))


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 300), k=st.integers(1, 400), d=st.integers(1, 40),
       frac=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 16))
def test_count_sweep_property(n, k, d, frac, seed):
    """Any shape and any live count (including past K, which sweeps
    everything): the count sweep equals the full sweep bit for bit."""
    rng = np.random.default_rng(seed)
    count = int(round(frac * (k + 3)))
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy(_far_slots(rng.normal(size=(k, d)), count)
                         .astype(np.float32))
    got = ops.pairwise_argmin(x, c, count)
    full = ops.pairwise_argmin(x, c)
    assert all(torch.equal(a, b) for a, b in zip(got, full))


def _mixture(n, d, seed):
    rng = np.random.default_rng(seed)
    ctr = rng.normal(size=(12, d)) * 20.0
    return torch.from_numpy(
        (ctr[rng.integers(12, size=n)] + rng.normal(size=(n, d)))
        .astype(np.float32))


@pytest.mark.parametrize("cap", [4, 48, 600])
def test_rounds_with_the_count_equal_the_full_sweep(cap, monkeypatch):
    """The k-means|| rounds pass each round's live count; with the count
    dropped (every round sweeps all `cap` slots) the same generator gives
    the same `sel` and `d2`, bit for bit.  cap = 4 keeps every slot live
    (more points are wanted than kept), 600 leaves most of them far."""
    pts = _mixture(800, 7, cap)
    counts = []
    full_sweep = ops.pairwise_argmin

    def sweep_all(x, c, count=None):
        counts.append(int(count))
        return full_sweep(x, c)

    sel, d2 = ds.device_kmeans_parallel_rounds(
        pts, torch.Generator().manual_seed(cap), 30.0, rounds=5, cap=cap)
    monkeypatch.setattr(ds.ops, "pairwise_argmin", sweep_all)
    sel_full, d2_full = ds.device_kmeans_parallel_rounds(
        pts, torch.Generator().manual_seed(cap), 30.0, rounds=5, cap=cap)
    assert len(counts) == 5 and all(0 <= c <= cap for c in counts)
    if cap == 4:
        assert counts == [cap] * 5
    if cap == 600:
        assert max(counts) < cap
    assert torch.equal(sel, sel_full) and torch.equal(d2, d2_full)


def test_picks_return_the_live_count_on_the_device():
    """`_kmeans_parallel_picks` returns the live count as a 0-d int32
    tensor (no host sync), and the slots from it on are `_FAR`."""
    pts = _mixture(500, 5, 1)
    d2 = ((pts - pts[0]) ** 2).sum(dim=1)
    picked, slots, live = ds._kmeans_parallel_picks(
        pts, d2, torch.Generator().manual_seed(2), 20.0, 64)
    assert live.dtype == torch.int32 and live.dim() == 0
    m = int(live)
    assert 0 < m < 64 and m == int(picked.sum())
    assert (slots[m:] == ds._FAR).all() and (slots[:m] < ds._FAR).all()


def test_binding_checks_count_and_width():
    """The binding refuses a count that is not one int32, and a d past
    what the kernel's shared memory takes, before loading any library;
    any n passes its shape checks (it then stops at the CPU tensors)."""
    x, c = torch.zeros((100, 3)), torch.zeros((128, 3))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        binding.launch(x, c)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        binding.launch(x, c, torch.tensor(5, dtype=torch.int32))
    with pytest.raises(TypeError, match="count must be torch.int32"):
        binding.launch(x, c, torch.tensor(5))
    with pytest.raises(ValueError, match="count must have shape"):
        binding.launch(x, c, torch.zeros(2, dtype=torch.int32))
    for dtype, top in binding.MAX_D.items():
        with pytest.raises(ValueError, match=f"d must be in 1..{top}"):
            binding.launch(torch.zeros((4, top + 1), dtype=dtype),
                           torch.zeros((128, top + 1), dtype=dtype))
        with pytest.raises(ValueError, match="CUDA kernel got a tensor"):
            binding.launch(torch.zeros((4, top), dtype=dtype),
                           torch.zeros((128, top), dtype=dtype))
    assert ops.launch_counts()["pairwise_argmin"] == 0
