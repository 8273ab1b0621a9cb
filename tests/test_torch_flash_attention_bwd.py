"""The backward of the port's attention on the CPU: the plain version of the
backward kernel's equations and the kernel's bf16 roundings.

  * `ref.attention_bshd_bwd_ref` (P from the log-sum-exp, delta = rowsum(dO
    * O), dV, dK, dQ; GQA summed over the group) against `jax.grad` of the
    JAX package's `models/attention.py:_flash_attention` and against
    autograd through `ref.attention_bshd_ref`, on numpy-seeded f32 inputs:
    GQA groups 1, 2 and 4, causal and not, a prefix of full attention, v
    narrower than q and k, and S a multiple of the JAX scan's key chunk.
    All three are f32 and differ only in the order of their sums (the scan
    re-derives P from its running max), so each gradient is held to 1e-5
    of its largest magnitude.
  * The bf16 route's operand roundings (`csrc/flash_attention_bwd.cu`),
    modelled in plain torch at S = 2048, D = 128, causal, one query head
    over its KV head: with dO, P and dS split into bf16 hi and lo, dq, dk
    and dv stay within half of the card check's 4e-3 of the largest
    |gradient| of `attention_bshd_bwd_ref`; one rounding of dO or of dS
    does not, and one of P takes more than a quarter of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _flash_attention
from repro_torch.kernels import ref

LOG2E = 1.4426950408889634
CARD_TOL = 4e-3   # tests/test_torch_cuda.py BWD_TOL for bf16


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _lse(q, k, *, scale, causal, prefix_len=0):
    """Each row's log-sum-exp of its scaled, masked scores, (B, H, S), as
    the forward kernel writes it."""
    g = q.shape[2] // k.shape[2]
    kr = k.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if causal:
        pos = torch.arange(q.shape[1])
        keep = ref.prefix_causal_mask(pos, pos, prefix_len)
        scores = scores.masked_fill(~keep, float("-inf"))
    return torch.logsumexp(scores, dim=-1)


# (B, S, H, Hk, D, Dv, causal, prefix, chunk)
CASES = [
    (2, 128, 4, 4, 32, 32, True, 0, 128),
    (2, 128, 4, 2, 32, 32, True, 0, 128),
    (2, 128, 4, 1, 32, 32, True, 0, 128),
    (2, 128, 4, 4, 32, 32, False, 0, 128),
    (2, 128, 4, 2, 32, 32, False, 0, 128),
    (2, 128, 4, 1, 32, 32, False, 0, 128),
    (1, 128, 4, 2, 32, 32, True, 40, 128),       # a prefix
    (2, 128, 4, 2, 48, 16, True, 0, 128),        # Dv < D
    (1, 256, 4, 2, 32, 32, True, 0, 64),         # four chunks of the scan
    (1, 256, 8, 2, 24, 16, False, 0, 64),
]


@pytest.mark.parametrize("against", ["jax_grad", "autograd"])
@pytest.mark.parametrize("case", CASES)
def test_backward_ref_matches_the_references(case, against):
    b, s, h, hk, d, dv, causal, prefix, chunk = case
    rng = np.random.default_rng(s * 100 + h * 10 + hk + d + prefix)
    q, k = _normal(rng, (b, s, h, d)), _normal(rng, (b, s, hk, d))
    v, dout = _normal(rng, (b, s, hk, dv)), _normal(rng, (b, s, h, dv))
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal, prefix_len=prefix)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = ref.attention_bshd_ref(tq, tk, tv, **kw)
    got = ref.attention_bshd_bwd_ref(tq, tk, tv, out, tdo,
                                     _lse(tq, tk, **kw), **kw)
    if against == "jax_grad":
        _, vjp = jax.vjp(lambda q_, k_, v_: _flash_attention(
            q_, k_, v_, chunk=chunk, **kw), jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(v))
        want = [torch.from_numpy(np.array(g))
                for g in vjp(jnp.asarray(dout))]
    else:
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        want = torch.autograd.grad(ref.attention_bshd_ref(*leaves, **kw),
                                   leaves, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-5, (name, err)


def _r(x):
    return x.to(torch.bfloat16).float()


def _bf16_route_model(q, k, v, out, dout, lse, scale, *, causal=True,
                      prefix_len=0, split_do=True, split_p=True,
                      split_ds=True):
    """The CUDA kernel's bf16 route on one (S, D) head, in plain torch: S
    from the bf16 q and k in f32 (their products are exact), P = exp2(S
    scale log2(e) - lse log2(e)), delta = rowsum(dO O) in f32, dP = (dO_hi
    + dO_lo) v, dS = P (dP - delta); dV = P_hi dO_hi + P_lo dO_hi + P_hi
    dO_lo, dK = scale (dS_hi + dS_lo)^T q, dQ = scale (dS_hi + dS_lo) k,
    every product summed in f32.  A `split_*` set False rounds that
    operand to bf16 once instead (its lo part is 0)."""
    n = q.shape[0]
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = torch.arange(n)
    keep = (ref.prefix_causal_mask(pos, pos, prefix_len) if causal
            else torch.ones(n, n, dtype=torch.bool))
    p = torch.exp2((qf @ kf.T) * (scale * LOG2E) - lse[:, None] * LOG2E)
    p = torch.where(keep, p, 0.0)
    delta = (dout * out).sum(dim=1, keepdim=True)

    def parts(x, split):
        hi = _r(x)
        return hi, (_r(x - hi) if split else torch.zeros_like(x))

    do_hi, do_lo = parts(dout, split_do)
    ds = p * ((do_hi @ vf.T + do_lo @ vf.T) - delta)
    p_hi, p_lo = parts(p, split_p)
    ds_hi, ds_lo = parts(ds, split_ds)
    dv = p_hi.T @ do_hi + p_lo.T @ do_hi + p_hi.T @ do_lo
    dk = (ds_hi.T @ qf + ds_lo.T @ qf) * scale
    dq = (ds_hi @ kf + ds_lo @ kf) * scale
    return dq, dk, dv


def test_bf16_route_rounding_keeps_the_card_tolerance():
    """The argument for the bf16 route's splits, before any chip run: at S
    = 2048 and D = 128, causal, on numpy-seeded bf16 q, k, v and an f32
    dO, two query heads each over its KV head, the kernel's roundings (dO,
    P and dS split) keep every gradient within 2e-3 (half of the card's
    4e-3; the other half is the gradient's own bf16 rounding) of
    `attention_bshd_bwd_ref`'s largest magnitude.  Rounding dO once puts
    dP out of step with delta (from the f32 dO) and dS once moves dk and
    dq: each breaks 2e-3.  Rounding P once stays within it but takes more
    than a quarter of the 4e-3, on the first keys, where dv and its own
    final rounding are largest; split, it takes less than 1e-5."""
    s, d = 2048, 128
    rng = np.random.default_rng(2048)
    q, k, v = (torch.from_numpy(_normal(rng, (1, s, n, d))).to(torch.bfloat16)
               for n in (2, 1, 1))
    dout = torch.from_numpy(_normal(rng, (1, s, 2, d)))
    scale = d ** -0.5
    kw = dict(scale=scale, causal=True)
    out = ref.attention_bshd_ref(q, k, v, **kw)
    lse = _lse(q, k, **kw)
    worst = {}
    for h in range(2):
        # one query head over its KV head: this head's dq, dk and dv
        want = [g[0, :, 0] for g in ref.attention_bshd_bwd_ref(
            q[:, :, h:h + 1], k, v, out[:, :, h:h + 1], dout[:, :, h:h + 1],
            lse[:, h:h + 1], **kw)]
        args = (q[0, :, h], k[0, :, 0], v[0, :, 0], out[0, :, h],
                dout[0, :, h], lse[0, h], scale)
        for label, kwargs in (("split", {}), ("dO once", {"split_do": False}),
                              ("P once", {"split_p": False}),
                              ("dS once", {"split_ds": False})):
            got = _bf16_route_model(*args, **kwargs)
            err = max(float((g - x).abs().max()) / float(x.abs().max())
                      for g, x in zip(got, want))
            worst[label] = max(worst.get(label, 0.0), err)
    assert worst["split"] <= 1e-5, worst
    assert worst["split"] <= CARD_TOL / 2, worst
    assert worst["dO once"] > CARD_TOL / 2, worst
    assert worst["dS once"] > CARD_TOL / 2, worst
    assert CARD_TOL / 4 < worst["P once"] <= CARD_TOL / 2, worst


def full_heads(label, s, h, hk, d, dv, causal, prefix_len=0, seed=0):
    """The model at one of the card check's bf16 shapes, one batch element
    of its heads: each gradient's largest error, as a share of its largest
    magnitude, before and after its own bf16 rounding (the card compares
    the rounded gradient), with every operand split and with P rounded
    once.  Prints one line."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(_normal(rng, (1, s, n, d))).to(torch.bfloat16)
            for n in (h, hk))
    v = torch.from_numpy(_normal(rng, (1, s, hk, dv))).to(torch.bfloat16)
    dout = torch.from_numpy(_normal(rng, (1, s, h, dv)))
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal, prefix_len=prefix_len)
    out = ref.attention_bshd_ref(q, k, v, **kw)
    lse = _lse(q, k, **kw)
    grp = h // hk
    variants = {"split": {}, "P once": {"split_p": False}}
    want = [torch.zeros(s, h, d), torch.zeros(s, hk, d), torch.zeros(s, hk, dv)]
    got = {name: [torch.zeros_like(w) for w in want] for name in variants}
    for j in range(hk):
        heads = slice(j * grp, (j + 1) * grp)
        w = ref.attention_bshd_bwd_ref(
            q[:, :, heads], k[:, :, j:j + 1], v[:, :, j:j + 1],
            out[:, :, heads], dout[:, :, heads], lse[:, heads], **kw)
        want[0][:, heads] = w[0][0]
        want[1][:, j], want[2][:, j] = w[1][0, :, 0], w[2][0, :, 0]
        for i in range(j * grp, (j + 1) * grp):
            args = (q[0, :, i], k[0, :, j], v[0, :, j], out[0, :, i],
                    dout[0, :, i], lse[0, i], scale)
            for name, split in variants.items():
                g = _bf16_route_model(*args, causal=causal,
                                      prefix_len=prefix_len, **split)
                got[name][0][:, i] = g[0]
                got[name][1][:, j] += g[1]
                got[name][2][:, j] += g[2]
    line = []
    for name in variants:
        for rounded in (False, True):
            err = max(float(((_r(x) if rounded else x) - w).abs().max())
                      / float(w.abs().max())
                      for x, w in zip(got[name], want))
            line.append(f"{name}{', rounded' if rounded else ''} {err:.3g}")
    print(f"{label}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python \
    #     tests/test_torch_flash_attention_bwd.py
    torch.set_num_threads(8)
    full_heads("yi-9b (2048, 32 over 4, 128), causal", 2048, 32, 4, 128, 128,
               True)
    full_heads("MLA (2048, 16, 192 / 128), causal", 2048, 16, 16, 192, 128,
               True)
    full_heads("prefix 256 (1024, 8 over 1, 256)", 1024, 8, 1, 256, 256,
               True, prefix_len=256)
    full_heads("hubert (2048, 16, 80), non-causal", 2048, 16, 16, 80, 80,
               False)
