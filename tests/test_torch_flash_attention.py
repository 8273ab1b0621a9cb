"""The port's attention entries against the JAX package, on the CPU.

On CPU tensors `ops.flash_attention` and `ops.attention_bshd` run their
plain versions (`kernels/ref.py`); the CUDA kernel itself is held against
those on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.

  * `ops.flash_attention` (BH, S, D) against the TPU kernel
    `flash_attention_pallas` in interpret mode: the four `CASES`, the bf16
    case and the causality property of `tests/test_flash_attention.py`, at
    its tolerances (2e-5 f32, 3e-2 bf16).
  * `ops.attention_bshd` (B, S, H, D) against the model's
    `_flash_attention` for GQA groups 1, 2 and 4, causal or not, S in
    {16, 256, 2048}, f32 and bf16 inputs.  Both widen to f32 before any
    arithmetic and differ only in summation order, so both dtypes are
    held to 2e-5.
  * A ragged S (not a multiple of the key chunk) against exact softmax,
    and a property test of the chunked scan against exact softmax.
  * The rounding of the kernel's bf16 route, modelled in plain torch: bf16
    q and k with f32 products and the scale after, p split into bf16 hi
    and lo against bf16 v, stays within a quarter of the card check's
    1e-4 at the serving shape's S and D; p rounded to bf16 alone does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import _flash_attention
from repro_torch.kernels import ops, ref

CASES = [
    # (bh, s, d, causal, bq, bk), as tests/test_flash_attention.py
    (4, 256, 64, True, 128, 128),
    (2, 256, 32, False, 64, 128),
    (3, 512, 128, True, 128, 64),
    (1, 128, 16, True, 64, 64),
]


def _normal(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("bh,s,d,causal,bq,bk", CASES)
def test_flash_attention_matches_the_tpu_kernel(bh, s, d, causal, bq, bk):
    rng = np.random.default_rng(bh * 100 + s)
    q, k, v = (_normal(rng, (bh, s, d)) for _ in range(3))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=d ** -0.5,
                                  causal=causal, block_q=bq, block_k=bk,
                                  interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=d ** -0.5,
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (bh, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_bf16_inputs():
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(_normal(rng, (2, 256, 64)), jnp.bfloat16)
               for _ in range(3))
    want = flash_attention_pallas(q, k, v, scale=0.125, causal=True,
                                  interpret=True, block_q=128, block_k=128)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, scale=0.125, causal=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)


def test_flash_attention_causality_property():
    """Changing future K/V never changes a position's output."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 256, 32))) for _ in range(3))
    out1 = ops.flash_attention(q, k, v, scale=1.0, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 99.0
    v2[:, 128:] = -99.0
    out2 = ops.flash_attention(q, k2, v2, scale=1.0, causal=True)
    np.testing.assert_allclose(out1[:, :128], out2[:, :128], rtol=1e-6)
    assert float((out1[:, 128:] - out2[:, 128:]).abs().max()) > 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 256, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_attention_bshd_matches_the_model_attention(g, causal, s, dtype):
    h, d = 4, 16
    b = 2 if s < 2048 else 1
    rng = np.random.default_rng(g * 1000 + s + causal)
    q = jnp.asarray(_normal(rng, (b, s, h, d)), dtype)
    k = jnp.asarray(_normal(rng, (b, s, h // g, d)), dtype)
    v = jnp.asarray(_normal(rng, (b, s, h // g, d)), dtype)
    want = _flash_attention(q, k, v, causal=causal, scale=d ** -0.5)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (q, k, v))
    got = ops.attention_bshd(tq, tk, tv, causal=causal, scale=d ** -0.5)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _exact(q, k, v, scale, causal):
    """Exact softmax on the (B, S, H, D) layout, KV heads repeated."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kr = k.repeat_interleave(g, dim=2)
    vr = v.repeat_interleave(g, dim=2)
    flat = [t.permute(0, 2, 1, 3).reshape(b * h, s, d) for t in (q, kr, vr)]
    out = ref.flash_attention_ref(*flat, scale=scale, causal=causal)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_sequence_against_exact_softmax(causal):
    """S = 200 is no multiple of the 64-key chunk: the last chunk is short.
    f32 rounding only (2e-5)."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_normal(rng, (2, 200, 4, 32)))
    k = torch.from_numpy(_normal(rng, (2, 200, 2, 32)))
    v = torch.from_numpy(_normal(rng, (2, 200, 2, 32)))
    want = _exact(q, k, v, 32 ** -0.5, causal)
    got = ref.attention_bshd_ref(q, k, v, scale=32 ** -0.5, causal=causal,
                                 chunk=64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    flat = ops.flash_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                               scale=0.5, causal=causal)
    assert flat.shape == (2, 200, 32) and bool(torch.isfinite(flat).all())


@settings(deadline=None, max_examples=25)
@given(s=st.integers(1, 70), g=st.sampled_from([1, 2, 3]),
       chunk=st.integers(1, 40), causal=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_chunked_scan_is_exact_softmax(s, g, chunk, causal, seed):
    """Any S and any chunk: the online-softmax scan gives exact softmax to
    f32 rounding (2e-5)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(_normal(rng, (1, s, 2 * g, 8)) * 2)
    k = torch.from_numpy(_normal(rng, (1, s, 2, 8)) * 2)
    v = torch.from_numpy(_normal(rng, (1, s, 2, 8)))
    got = ref.attention_bshd_ref(q, k, v, scale=0.3, causal=causal,
                                 chunk=chunk)
    want = _exact(q, k, v, 0.3, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def _bf16_route_model(q, k, v, scale, *, split, tile=64):
    """The CUDA kernel's bf16 route on one (S, D) head, causal, in plain
    torch: s = (q k^T) * scale log2(e) in f32 (bf16 products are exact in
    f32), online softmax over `tile`-key tiles with exp2, and P V with p
    rounded to bf16 (p_hi) plus, with `split`, its bf16 remainder (p_lo),
    each product summed in f32 against the bf16 v; l from the f32 p."""
    n = q.shape[0]
    t = (q.float() @ k.float().T) * (scale * 1.4426950408889634)
    t = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), t, -1.0e30)
    vf = v.float()
    m = torch.full((n, 1), -1.0e30)
    l = torch.zeros((n, 1))
    acc = torch.zeros((n, q.shape[1]))
    for k0 in range(0, n, tile):
        tk = t[:, k0:k0 + tile]
        m_new = torch.maximum(m, tk.max(dim=1, keepdim=True).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(tk - m_new)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[k0:k0 + tile]
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[k0:k0 + tile]
        l = l * alpha + p.sum(dim=1, keepdim=True)
        acc = acc * alpha + pv
        m = m_new
    return acc / l.clamp_min(1e-30)


def test_bf16_route_rounding_keeps_the_card_tolerance():
    """The argument for keeping `ATTN_TOL` = 1e-4 on the bf16 tensor-core
    route, before any chip run: at S = 2048 and D = 128, causal, on
    numpy-seeded bf16 inputs, the split p stays within 2.5e-5 (a quarter of
    the tolerance) of the f32 reference, and p rounded to bf16 alone does
    not."""
    s, d = 2048, 128
    rng = np.random.default_rng(2048)
    q, k, v = (torch.from_numpy(_normal(rng, (1, s, n, d))).to(torch.bfloat16)
               for n in (2, 1, 1))
    want = ref.attention_bshd_ref(q, k, v, scale=d ** -0.5, causal=True)
    for h in range(2):
        args = (q[0, :, h], k[0, :, 0], v[0, :, 0], d ** -0.5)
        split = _bf16_route_model(*args, split=True)
        alone = _bf16_route_model(*args, split=False)
        err_split = float((split - want[0, :, h]).abs().max())
        err_alone = float((alone - want[0, :, h]).abs().max())
        assert err_split <= 2.5e-5, err_split
        assert err_alone > 2.5e-5, err_alone
