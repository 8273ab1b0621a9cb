"""Plain PyTorch versions of the hand-written kernels (the correctness oracles).

Each function computes what its CUDA twin computes, in the same dtype and
with the same elementwise order; the two attention versions compute the
JAX package's functions (exact softmax, and the model's 1024-key online
scan), which the flash kernel meets to f32 rounding with 64-key tiles.
The wrappers in `ops.py` run them for CPU tensors, `chip_smoke.py` holds
every kernel against them on the card, and the tests hold them against
the JAX package's `kernels/ref.py` oracles, which they mirror one for
one.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = [
    "LSH_MISS",
    "full_f32_matmul",
    "tile_sums_ref",
    "pairwise_argmin_ref",
    "d2_update_ref",
    "d2_update_tiles_ref",
    "tree_sep_update_ref",
    "tree_sep_update_tiles_ref",
    "tree_sep_update_lanes_ref",
    "tree_sep_update_tiles_lanes_ref",
    "lsh_bucket_min_ref",
    "lsh_bucket_min_penalty_ref",
    "lsh_bucket_accept_ref",
    "lsh_bucket_accept_penalty_ref",
    "lsh_bucket_accept_lanes_penalty_ref",
    "flash_attention_ref",
    "attention_bshd_ref",
    "attention_bshd_bwd_ref",
]

LSH_MISS = 3.0e38  # "no colliding center" sentinel (finite in f32)
NEG_INF = -1.0e30  # masked attention score (not -inf: no NaN on a masked row)
KV_CHUNK = 1024    # keys per step of the model's online-softmax scan


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products on the card in full float32, whatever
    the process set: TF32 keeps about three decimal digits, and the plain
    versions are the kernels' oracles.  Restores the setting on exit; has
    no effect on the CPU."""
    m = torch.backends.cuda.matmul
    try:    # the newer API; reading the legacy flag raises once it is used
        attr, saved, value = "fp32_precision", m.fp32_precision, "ieee"
    except AttributeError:
        attr, saved, value = "allow_tf32", m.allow_tf32, False
    setattr(m, attr, value)
    try:
        yield
    finally:
        setattr(m, attr, saved)


def tile_sums_ref(w: torch.Tensor, block_n: int) -> torch.Tensor:
    """Per-tile weight sums — the `_tiles` kernel's epilogue oracle."""
    return w.reshape(-1, block_n).sum(dim=1)


def pairwise_argmin_ref(x: torch.Tensor, c: torch.Tensor, count=None, *,
                        chunk: int = 16384):
    """argmin_c ||x - c||^2 per row of x: ``(min_d2 (n,) f32, argmin (n,)
    int32)``.

    The expanded form ``max((|x|^2 - 2 x.c) + |c|^2, 0)`` in f32 (f32 or
    bf16 inputs are widened first), ties to the smallest center index
    (`torch.min` returns the first minimum).  With `count` (an int or a
    one-element tensor) only the first ``min(count, K - 1) + 1`` slots
    are swept, as the kernel does.  Rows go in chunks of `chunk` so the
    (rows, k) block stays bounded at any n.
    """
    if count is not None:
        c = c[: min(max(int(count), 0), c.shape[0] - 1) + 1]
    xf = x.to(torch.float32)
    cf = c.to(torch.float32)
    c_sq = (cf * cf).sum(dim=1)
    d2_min = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    arg = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    with full_f32_matmul():
        for lo in range(0, x.shape[0], chunk):
            xs = xf[lo: lo + chunk]
            x_sq = (xs * xs).sum(dim=1)
            d2 = ((x_sq[:, None] - 2.0 * (xs @ cf.T)) + c_sq[None, :])
            vals, idx = d2.clamp_min_(0.0).min(dim=1)
            d2_min[lo: lo + chunk] = vals
            arg[lo: lo + chunk] = idx
    return d2_min, arg


def d2_update_ref(x: torch.Tensor, center: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """w <- min(w, ||x - center||^2): the D^2 maintenance step of exact
    k-means++ (direct differences, f32)."""
    diff = x.to(torch.float32) - center.to(torch.float32)[None, :]
    return torch.minimum(w.to(torch.float32), (diff * diff).sum(dim=1))


def d2_update_tiles_ref(x, center, w, *, block_n: int = 512):
    """(w' padded with zeros to a multiple of `block_n`, per-tile sums of
    it) for any n — the `d2_update_tiles` oracle."""
    out = d2_update_ref(x, center, w)
    out = torch.cat([out, out.new_zeros((-out.shape[0]) % block_n)])
    return out, tile_sums_ref(out, block_n)


def tree_sep_update_ref(
    codes_lo: torch.Tensor,   # (H, n) int32 — low 32 bits of cell codes
    codes_hi: torch.Tensor,   # (H, n) int32 — high 32 bits
    center_lo: torch.Tensor,  # (H,) int32
    center_hi: torch.Tensor,  # (H,) int32
    w: torch.Tensor,          # (n,) f32 — current MultiTreeDist(x, S)^2
    *,
    scale: float,             # 2 * sqrt(d) * max_dist
    num_levels: int,          # H (heights incl. root)
) -> torch.Tensor:
    """One tree's MULTITREEOPEN weight sweep.

    sep(y, x) = 1 (root) + #{h >= 1 : codes agree}; the closed-form tree
    distance is scale * (2^(1-sep) - 2^(1-H)); w' = min(w, dist^2).  The
    code arrays carry heights 1..H-1 (the root is implicit).  `scale`, a
    Python float against an f32 tensor, is rounded to f32 once.
    """
    eq = (codes_lo == center_lo[:, None]) & (codes_hi == center_hi[:, None])
    sep = 1 + eq.sum(dim=0, dtype=torch.int32)
    dist = scale * (torch.exp2(1.0 - sep.to(torch.float32))
                    - 2.0 ** (1.0 - num_levels))
    dist = dist.clamp_min(0.0)
    return torch.minimum(w.to(torch.float32), dist * dist)


def tree_sep_update_tiles_ref(codes_lo, codes_hi, center_lo, center_hi, w, *,
                              scale: float, num_levels: int,
                              block_n: int = 512):
    """(w', per-tile sums of w') — the `tree_sep_update_tiles` oracle."""
    out = tree_sep_update_ref(codes_lo, codes_hi, center_lo, center_hi, w,
                              scale=scale, num_levels=num_levels)
    return out, tile_sums_ref(out, block_n)


def _lane_columns(codes_lo, codes_hi, x):
    """Per lane j: its (H, n) planes and the column of its point x[j]."""
    for j, xj in enumerate(x.tolist()):
        lo, hi = codes_lo[j], codes_hi[j]
        yield j, lo, hi, lo[:, xj], hi[:, xj]


def tree_sep_update_lanes_ref(codes_lo, codes_hi, x, w, *, scale: float,
                              num_levels: int) -> torch.Tensor:
    """The lane-axis sweep: codes (B, H, n) (a stride-0 lane axis shares
    one copy), x (B,) the point each lane opens, w (B, n) -> w' (B, n),
    `tree_sep_update_ref` of each lane stacked."""
    return torch.stack([
        tree_sep_update_ref(lo, hi, clo, chi, w[j], scale=scale,
                            num_levels=num_levels)
        for j, lo, hi, clo, chi in _lane_columns(codes_lo, codes_hi, x)])


def tree_sep_update_tiles_lanes_ref(codes_lo, codes_hi, x, w, *,
                                    scale: float, num_levels: int,
                                    block_n: int = 512):
    """(w' (B, n), tile sums (B, n / block_n)): `tree_sep_update_tiles_ref`
    of each lane stacked."""
    outs = [tree_sep_update_tiles_ref(lo, hi, clo, chi, w[j], scale=scale,
                                      num_levels=num_levels, block_n=block_n)
            for j, lo, hi, clo, chi in _lane_columns(codes_lo, codes_hi, x)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([t for _, t in outs]))


def _masked_d2(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
               live: torch.Tensor) -> torch.Tensor:
    """(B, K) squared distances where a live center shares a bucket with
    the candidate, `LSH_MISS` elsewhere."""
    collide = ((q_keys_lo[:, :, None] == c_keys_lo[:, None, :])
               & (q_keys_hi[:, :, None] == c_keys_hi[:, None, :])).any(dim=0)
    qf = q.to(torch.float32)
    cf = c.to(torch.float32)
    q_sq = (qf * qf).sum(dim=1)
    c_sq = (cf * cf).sum(dim=1)
    with full_f32_matmul():
        dots = qf @ cf.T
    d2 = (q_sq[:, None] - 2.0 * dots + c_sq[None, :]).clamp_min(0.0)
    return torch.where(collide & live[None, :], d2,
                       torch.full_like(d2, LSH_MISS))


def _row_min(masked: torch.Tensor) -> torch.Tensor:
    """Row minimum of a (B, K) block, `LSH_MISS` for K == 0."""
    if masked.shape[1] == 0:
        return torch.full((masked.shape[0],), LSH_MISS, dtype=torch.float32,
                          device=masked.device)
    return masked.min(dim=1).values


def _accept_p(d2_min: torch.Tensor, mtd2: torch.Tensor,
              c2: float) -> torch.Tensor:
    """``p = d2_min / max(c^2 * mtd2, 1e-30)``, 0 where ``mtd2 == 0``."""
    mtd2 = mtd2.to(torch.float32)
    return torch.where(mtd2 > 0.0, d2_min / (c2 * mtd2).clamp_min(1e-30),
                       torch.zeros_like(mtd2))


def lsh_bucket_min_ref(
    q_keys_lo: torch.Tensor,  # (L, B) int32 — candidate bucket keys, low plane
    q_keys_hi: torch.Tensor,  # (L, B) int32
    q: torch.Tensor,          # (B, D) — candidate coordinates
    c_keys_lo: torch.Tensor,  # (L, K) int32 — opened-center bucket keys
    c_keys_hi: torch.Tensor,  # (L, K) int32
    c: torch.Tensor,          # (K, D) — opened-center coordinates
    count=None,               # only the first `count` centers are live
) -> torch.Tensor:
    """Monotone-LSH nearest-bucket query: min over centers sharing a bucket.

    Returns (B,) f32 — squared distance to the nearest colliding live
    center, or `LSH_MISS` when none shares any of the L buckets.
    """
    k = c.shape[0]
    live = torch.arange(k, device=c.device) < (k if count is None else count)
    return _row_min(_masked_d2(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi,
                               c, live))


def lsh_bucket_accept_ref(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
                          mtd2: torch.Tensor, count=None, *, c2: float):
    """(d2_min, acceptance probability) — the `lsh_bucket_accept` oracle.

    ``p = d2_min / max(c^2 * mtd2, 1e-30)`` with ``p = 0`` where
    ``mtd2 == 0``; a miss (``d2_min == LSH_MISS``) gives p >> 1, i.e. the
    sampler always accepts.
    """
    d2_min = lsh_bucket_min_ref(q_keys_lo, q_keys_hi, q,
                                c_keys_lo, c_keys_hi, c, count)
    return d2_min, _accept_p(d2_min, mtd2, c2)


def lsh_bucket_min_penalty_ref(q_keys_lo, q_keys_hi, q, c_keys_lo,
                               c_keys_hi, c,
                               penalty: torch.Tensor) -> torch.Tensor:
    """The kernel's own form of `lsh_bucket_min_ref`, on the padded inputs
    the kernel takes: liveness comes as a penalty row (0 live, `LSH_MISS`
    dead) that is max()ed into every colliding distance, exactly as the TPU
    kernel and the CUDA kernel apply it."""
    every = torch.ones(c.shape[0], dtype=torch.bool, device=c.device)
    return _row_min(torch.maximum(
        _masked_d2(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, every),
        penalty[None, :]))


def lsh_bucket_accept_penalty_ref(q_keys_lo, q_keys_hi, q, c_keys_lo,
                                  c_keys_hi, c, penalty: torch.Tensor,
                                  mtd2: torch.Tensor, *, c2: float):
    """`lsh_bucket_min_penalty_ref` plus the acceptance epilogue: the
    kernel's own form of `lsh_bucket_accept_ref`."""
    d2_min = lsh_bucket_min_penalty_ref(q_keys_lo, q_keys_hi, q, c_keys_lo,
                                        c_keys_hi, c, penalty)
    return d2_min, _accept_p(d2_min, mtd2, c2)


def lsh_bucket_accept_lanes_penalty_ref(q_keys_lo, q_keys_hi, q, lanes,
                                        c_keys_lo, c_keys_hi, c,
                                        penalty: torch.Tensor,
                                        mtd2: torch.Tensor, *, c2: float):
    """The lane-axis accept: candidate b against the slots of lane
    lanes[b], keys (lanes, L, K) and coordinates (lanes, K, D).  Each
    lane's candidates, in their order, go through
    `lsh_bucket_accept_penalty_ref` with that lane's slots, so a lane's
    results are the one-lane call's."""
    d2_min = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    p = torch.empty_like(d2_min)
    for j in range(c.shape[0]):
        sel = torch.nonzero(lanes == j).flatten()
        if len(sel):
            d2_min[sel], p[sel] = lsh_bucket_accept_penalty_ref(
                q_keys_lo[:, sel], q_keys_hi[:, sel], q[sel], c_keys_lo[j],
                c_keys_hi[j], c[j], penalty, mtd2[sel], c2=c2)
    return d2_min, p


def prefix_causal_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                       prefix_len: int) -> torch.Tensor:
    """Which keys each query sees under the causal mask with a prefix of
    full attention, the JAX package's ``(q >= k) | (q < P & k < P)``
    (`models/attention.py`): (len(q_pos), len(kv_pos)) bool."""
    keep = q_pos[:, None] >= kv_pos[None, :]
    if prefix_len:
        keep = keep | ((q_pos[:, None] < prefix_len)
                       & (kv_pos[None, :] < prefix_len))
    return keep


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True,
                        prefix_len: int = 0) -> torch.Tensor:
    """Exact softmax attention on (BH, S, D), f32 out: the oracle of the
    flash kernel, as the JAX package's `flash_attention_ref`.  q is widened
    to f32 and then scaled; masked scores are -1e30.  Causal, the first
    `prefix_len` positions also see each other."""
    qf = q.to(torch.float32) * scale
    with full_f32_matmul():
        s = qf @ k.to(torch.float32).transpose(1, 2)
        if causal:
            pos = torch.arange(q.shape[1], device=q.device)
            keep = prefix_causal_mask(pos, pos, prefix_len)
            s = torch.where(keep, s, NEG_INF)
        return torch.softmax(s, dim=-1) @ v.to(torch.float32)


def attention_bshd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool, prefix_len: int = 0,
                       chunk: int = KV_CHUNK) -> torch.Tensor:
    """The model's attention, q (B, S, H, D) over k, v (B, S, Hk, D) ->
    (B, S, H, D) f32: the online-softmax scan over key chunks of the JAX
    package's `models/attention.py:_flash_attention`.

    Query head h reads KV head h // (H // Hk), the order of
    ``q.reshape(b, s, hk, g, d)``.  Causal, the first `prefix_len`
    positions also see each other (`prefix_causal_mask`).  The last chunk
    may be short, so any S runs here; the model keeps the JAX package's
    rule on S.
    """
    b, s, h, d = q.shape
    hk, dv = k.shape[2], v.shape[3]
    g = h // hk
    qg = q.reshape(b, s, hk, g, d).to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, s, hk, g), NEG_INF, device=q.device)
    l = torch.zeros((b, s, hk, g), device=q.device)
    acc = torch.zeros((b, s, hk, g, dv), device=q.device)
    with full_f32_matmul():
        for lo in range(0, s, chunk):
            kb, vb = kf[:, lo: lo + chunk], vf[:, lo: lo + chunk]
            scores = torch.einsum("bqkgd,bskd->bqkgs", qg, kb)
            if causal:
                kv_pos = torch.arange(lo, lo + kb.shape[1], device=q.device)
                keep = prefix_causal_mask(q_pos, kv_pos, prefix_len)
                scores = torch.where(keep[None, :, None, None, :], scores,
                                     NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkgs,bskv->bqkgv",
                                                        p, vb)
            m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, s, h, dv)


def attention_bshd_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, dout: torch.Tensor,
                           lse: torch.Tensor, *, scale: float, causal: bool,
                           prefix_len: int = 0) -> tuple:
    """The gradients (dq, dk, dv) of `attention_bshd_ref`'s output, in f32:
    the plain version of the backward kernel's equations
    (`csrc/flash_attention_bwd.cu`).  q (B, S, H, D), k (B, S, Hk, D), v
    (B, S, Hk, Dv), the forward's output `out` and its gradient `dout`
    (B, S, H, Dv), and the forward's log-sum-exp `lse` (B, H, S) of the
    scaled, masked scores.  With P = exp(scale q k - lse) on the visible
    pairs and 0 elsewhere, delta = rowsum(dout * out), dS = P (dout v -
    delta): dv = P^T dout, dk = scale dS^T q, dq = scale dS k, dk and dv
    summed over each KV head's H / Hk query heads."""
    b, s, h, d = q.shape
    hk, dv = k.shape[2], v.shape[3]
    g = h // hk
    qf = q.reshape(b, s, hk, g, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    do = dout.reshape(b, s, hk, g, dv).to(torch.float32)
    o = out.reshape(b, s, hk, g, dv).to(torch.float32)
    lse_g = lse.to(torch.float32).reshape(b, hk, g, s).permute(0, 3, 1, 2)
    with full_f32_matmul():
        scores = torch.einsum("bqkgd,bskd->bqkgs", qf, kf) * scale
        p = torch.exp(scores - lse_g[..., None])
        if causal:
            pos = torch.arange(s, device=q.device)
            keep = prefix_causal_mask(pos, pos, prefix_len)
            p = torch.where(keep[None, :, None, None, :], p, 0.0)
        delta = (do * o).sum(dim=-1, keepdim=True)
        ds = p * (torch.einsum("bqkgv,bskv->bqkgs", do, vf) - delta)
        dv_ = torch.einsum("bqkgs,bqkgv->bskv", p, do)
        dk = torch.einsum("bqkgs,bqkgd->bskd", ds, qf) * scale
        dq = torch.einsum("bqkgs,bskd->bqkgd", ds, kf) * scale
    return dq.reshape(b, s, h, d), dk, dv_
