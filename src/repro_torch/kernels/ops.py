"""Public kernel wrappers: padding, dispatch and launch counts.

Dispatch follows the tensors: on the CPU a wrapper runs the plain PyTorch
version from `ref.py`; on a CUDA device it launches the hand-written kernel
(bound in the `*_cuda.py` modules beside this one) or the launch raises.
There is no fallback from one to the other, and any other device raises.

Padding is done before the dispatch, so the CPU tests run it too.  It
follows the JAX package's wrappers: points pad with weight 0 (never
sampled, nothing added to a tile sum) and query-side codes with -1;
`pairwise_argmin` pads center slots at `_PAD_FAR` (not points).  The LSH
queries pad nothing: their kernel guards both edges and reads only the
live center slots, and their plain version masks the dead ones with the
penalty row.  The TPU also padded the heights H and the tables L to a
multiple of 8 sublanes; the CUDA kernels loop over any count, so those
axes are not padded.  `d2_update_tiles` pads no input either: its kernel
treats rows at and past n as weight 0 without reading them, and it
returns w' and the tile sums padded to a multiple of the tile, as the JAX
package's does (w' = 0 past n).  On the Algorithm 4 path every pad is a
no-op: the seeders keep their buffers at block multiples.

The `_lanes` forms of `tree_sep_update`, `tree_sep_update_tiles` and
`lsh_bucket_accept` take a leading lane axis, as the JAX package's
`jax.vmap` gives its Pallas calls one: B independent solves of one shape
advance in one launch, and each lane's outputs are bit-identical to the
one-lane call's.  On the CPU their plain versions run the one-lane plain
version per lane.

Each wrapper adds one to its entry of `LAUNCHES` where it launches its
kernel, and nowhere else (a launch over B lanes counts one): a run shows it
went through the kernels by reading `launch_counts()` after
`reset_launch_counts()`.

`attention_bshd` is differentiable.  On the card, when autograd records,
it is a `torch.autograd.Function`: the forward kernel also writes each
row's log-sum-exp, and the backward is the hand-written backward kernel
(``flash_attention_bwd``, one count a backward call; it raises if it
cannot build or launch, and never gives way to the plain version).  On
the CPU autograd differentiates the plain version, `ref.attention_bshd_ref`.

`counting_on_meta()` is the dry run's context, and only the dry run
enters it.  Inside it `attention_bshd` and `flash_attention` take `meta`
tensors (and nothing else) and return `meta` outputs of the kernel's
shape, through an autograd Function whose backward gives q, k and v their
`meta` gradients; each call adds the kernel's operations and one launch to
the context's count, not to `LAUNCHES`.  The operations are the
kernel's own, as PERF.md's bounds count them: 2 (D + Dv) a visible
(query, key) pair a head forward, 2 (3 D + 2 Dv) backward (the five
products of row 8′).  Outside the context every wrapper refuses `meta`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import pairwise_argmin_cuda, ref
from repro_torch.kernels.ref import LSH_MISS

__all__ = [
    "pairwise_argmin",
    "d2_update",
    "d2_update_tiles",
    "tree_sep_update",
    "tree_sep_update_tiles",
    "tree_sep_update_lanes",
    "tree_sep_update_tiles_lanes",
    "lsh_bucket_min",
    "lsh_bucket_accept",
    "lsh_bucket_accept_lanes",
    "flash_attention",
    "attention_bshd",
    "split_codes_u64",
    "penalty_row",
    "launch_counts",
    "reset_launch_counts",
    "counting_on_meta",
    "attention_pairs",
    "LAUNCHES",
    "LSH_MISS",
]

_PAD_FAR = 1.0e17      # per-coordinate "far away" (distance^2 stays f32-finite)
_QUERY_CODE_PAD = -1   # query-side (points) code pad

LAUNCHES = {"tree_sep_update": 0, "tree_sep_update_tiles": 0,
            "lsh_bucket_accept": 0, "lsh_bucket_min": 0, "pairwise_argmin": 0,
            "d2_update": 0, "d2_update_tiles": 0, "flash_attention": 0,
            "flash_attention_bwd": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the open `counting_on_meta` count, or None
_META_COUNT = None


@contextlib.contextmanager
def counting_on_meta():
    """The dry run's counting context: yields ``{name: {"launches": n,
    "operations": x}}`` for ``flash_attention`` and
    ``flash_attention_bwd``, filled by the attention wrappers' `meta`
    calls made inside it.  It does not nest."""
    global _META_COUNT
    if _META_COUNT is not None:
        raise RuntimeError("counting_on_meta does not nest")
    _META_COUNT = {name: {"launches": 0, "operations": 0}
                   for name in ("flash_attention", "flash_attention_bwd")}
    try:
        yield _META_COUNT
    finally:
        _META_COUNT = None


def attention_pairs(s: int, causal: bool, prefix_len: int = 0) -> int:
    """The (query, key) pairs a head that the flash kernel computes over a
    sequence of `s`: all of them, or the causal triangle plus the prefix's
    upper one."""
    if not causal:
        return s * s
    return s * (s + 1) // 2 + prefix_len * (prefix_len - 1) // 2


def _count_meta(name: str, q: torch.Tensor, dv: int, causal: bool,
                prefix_len: int) -> None:
    b, s, h, d = q.shape
    per_pair = 2 * (d + dv) if name == "flash_attention" else \
        2 * (3 * d + 2 * dv)
    entry = _META_COUNT[name]
    entry["launches"] += 1
    entry["operations"] += per_pair * attention_pairs(s, causal,
                                                      prefix_len) * b * h


def _meta_attention(q, k, v, scale, causal, prefix_len):
    for t in (q, k, v):
        if t.device.type != "meta":
            raise ValueError(f"counting_on_meta takes meta tensors only, "
                             f"not {t.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MetaFlashAttention.apply(q, k, v, scale, causal, prefix_len)
    _count_meta("flash_attention", q, v.shape[-1], causal, prefix_len)
    return q.new_empty(q.shape[:-1] + v.shape[-1:], dtype=torch.float32)


class _MetaFlashAttention(torch.autograd.Function):
    """`_FlashAttention`'s shapes and counts on `meta`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, prefix_len):
        _count_meta("flash_attention", q, v.shape[-1], causal, prefix_len)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, prefix_len)
        return q.new_empty(q.shape[:-1] + v.shape[-1:], dtype=torch.float32)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, prefix_len = ctx.args
        _count_meta("flash_attention_bwd", q, v.shape[-1], causal,
                    prefix_len)
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None, None)


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {t.device}")


def _pad_to(a: torch.Tensor, axis: int, multiple: int, value) -> torch.Tensor:
    """Pad `axis` of `a` up to a multiple of `multiple` with `value`."""
    pad = (-a.shape[axis]) % multiple
    if pad == 0:
        return a
    widths = [0, 0] * a.dim()
    widths[2 * (a.dim() - 1 - axis) + 1] = pad   # F.pad lists last axis first
    return F.pad(a, widths, value=value)


def penalty_row(k_pad: int, count, device) -> torch.Tensor:
    """(k_pad,) f32: 0 for the first `count` (live) center slots, `LSH_MISS`
    for slots not yet opened or padded; the kernel max()es it in."""
    live = torch.arange(k_pad, device=device) < count
    return torch.where(live, 0.0, LSH_MISS).to(torch.float32)


def pairwise_argmin(x: torch.Tensor, c: torch.Tensor, count=None):
    """(min squared distance (n,) f32, argmin center index (n,) int32) per
    point, for any (n, d) x (k, d) with k >= 1, f32 or bf16.

    Center slots pad to a multiple of the kernel's `BLOCK_K` with every
    coordinate at `_PAD_FAR`, so a padded slot never wins while a real one
    is nearer and its distance stays f32-finite; points are not padded
    (the kernel guards its ragged edge).  `count` (None, an int, or one
    int32 on x's device) sweeps only slots 0 .. min(count, k_pad - 1): the
    live slots and the first dead one.  Where every slot from `count` on
    is the same far row, as the k-means|| picks leave them, that equals
    the full sweep bit for bit.  The kernel reads a device count itself,
    so nothing syncs.
    """
    if c.shape[0] == 0:
        raise ValueError("pairwise_argmin needs at least one center")
    cp = _pad_to(c, 0, pairwise_argmin_cuda.BLOCK_K, _PAD_FAR)
    if not _on_card(x):
        return ref.pairwise_argmin_ref(x, cp, count)
    if count is not None and not isinstance(count, torch.Tensor):
        count = torch.full((), min(int(count), cp.shape[0]),
                           dtype=torch.int32, device=x.device)
    out = pairwise_argmin_cuda.launch(x, cp, count)
    LAUNCHES["pairwise_argmin"] += 1
    return out


def d2_update(x: torch.Tensor, center: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """w <- min(w, ||x - center||^2) for any n (the kernel guards its
    ragged edge, so nothing pads)."""
    if not _on_card(w):
        return ref.d2_update_ref(x, center, w)
    from repro_torch.kernels import d2_update_cuda as binding

    out = binding.launch(x, center, w)
    LAUNCHES["d2_update"] += 1
    return out


def d2_update_tiles(x: torch.Tensor, center: torch.Tensor, w: torch.Tensor,
                    *, block_n: int = 512):
    """`d2_update` plus per-tile sums, for any n; nothing pads x or w.

    Returns the *padded* ``(w' (n_pad,), tile_sums (n_pad // block_n,))``,
    as `tree_sep_update_tiles` does, n_pad = ceil(n / block_n) * block_n:
    lanes past n hold w' = 0 and add nothing to a tile sum.
    """
    if not _on_card(w):
        return ref.d2_update_tiles_ref(x, center, w, block_n=block_n)
    from repro_torch.kernels import d2_update_cuda as binding

    out = binding.launch_tiles(x, center, w, tile=block_n)
    LAUNCHES["d2_update_tiles"] += 1
    return out


def tree_sep_update(codes_lo, codes_hi, center_lo, center_hi, w, *,
                    scale: float, num_levels: int) -> torch.Tensor:
    """One tree's open-center weight sweep over (H, n) code planes.

    Returns w' (n,).  The kernel guards its ragged edge, so nothing pads.
    """
    if not _on_card(w):
        return ref.tree_sep_update_ref(codes_lo, codes_hi, center_lo,
                                       center_hi, w, scale=scale,
                                       num_levels=num_levels)
    from repro_torch.kernels import tree_sep_update_cuda as binding

    out = binding.launch(codes_lo, codes_hi, center_lo, center_hi, w,
                         scale=scale, num_levels=num_levels)
    LAUNCHES["tree_sep_update"] += 1
    return out


def tree_sep_update_tiles(codes_lo, codes_hi, center_lo, center_hi, w, *,
                          scale: float, num_levels: int, block_n: int = 512):
    """One tree's open-center sweep plus per-tile sums; pads n to `block_n`.

    Returns the *padded* ``(w' (n_pad,), tile_sums (n_pad // block_n,))``:
    the seeders carry the padded weights across centers and feed the sums
    straight into `TiledSampleTree.refresh`.  Padded lanes carry w = 0.
    """
    lo = _pad_to(codes_lo, 1, block_n, _QUERY_CODE_PAD)
    hi = _pad_to(codes_hi, 1, block_n, _QUERY_CODE_PAD)
    wp = _pad_to(w, 0, block_n, 0.0)
    if not _on_card(w):
        return ref.tree_sep_update_tiles_ref(lo, hi, center_lo, center_hi,
                                             wp, scale=scale,
                                             num_levels=num_levels,
                                             block_n=block_n)
    from repro_torch.kernels import tree_sep_update_cuda as binding

    out = binding.launch_tiles(lo, hi, center_lo, center_hi, wp, scale=scale,
                               num_levels=num_levels, tile=block_n)
    LAUNCHES["tree_sep_update_tiles"] += 1
    return out


def tree_sep_update_lanes(codes_lo, codes_hi, x, w, *, scale: float,
                          num_levels: int) -> torch.Tensor:
    """The sweep of B lanes in one launch: codes (B, H, n) with contiguous
    rows (a stride-0 lane axis, from `expand`, shares one copy of the
    codes), x (B,) int64 the point each lane opens (its own column is the
    center: nothing is gathered, nothing syncs), w (B, n).  Returns w'
    (B, n); nothing pads."""
    if not _on_card(w):
        return ref.tree_sep_update_lanes_ref(codes_lo, codes_hi, x, w,
                                             scale=scale,
                                             num_levels=num_levels)
    from repro_torch.kernels import tree_sep_update_cuda as binding

    out = binding.launch_lanes(codes_lo, codes_hi, x, w, scale=scale,
                               num_levels=num_levels)
    LAUNCHES["tree_sep_update"] += 1
    return out


def tree_sep_update_tiles_lanes(codes_lo, codes_hi, x, w, *, scale: float,
                                num_levels: int, block_n: int = 512):
    """`tree_sep_update_lanes` plus per-tile sums: ``(w' (B, n),
    tile_sums (B, n // block_n))``; n must be a multiple of `block_n` (the
    seeders keep their buffers padded to the tile)."""
    if codes_lo.shape[-1] % block_n:
        raise ValueError(f"n = {codes_lo.shape[-1]} is not a multiple of "
                         f"the tile {block_n}")
    if not _on_card(w):
        return ref.tree_sep_update_tiles_lanes_ref(
            codes_lo, codes_hi, x, w, scale=scale, num_levels=num_levels,
            block_n=block_n)
    from repro_torch.kernels import tree_sep_update_cuda as binding

    out = binding.launch_tiles_lanes(codes_lo, codes_hi, x, w, scale=scale,
                                     num_levels=num_levels, tile=block_n)
    LAUNCHES["tree_sep_update_tiles"] += 1
    return out


def _live_slots(c: torch.Tensor, count) -> int:
    """The number of live center slots: the first `count` (`None`: all K),
    clamped to 0..K as the plain version's mask clamps it."""
    k = c.shape[0]
    return k if count is None else min(max(int(count), 0), k)


def lsh_bucket_min(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
                   count=None) -> torch.Tensor:
    """Nearest colliding-bucket center per candidate: d2_min (B,), or
    `LSH_MISS` where no live center shares a bucket.

    Keys are (L, B) / (L, K) int32 planes of the uint64 bucket keys.  Only
    the first `count` center slots are live (`None`: all K).  The kernel
    takes the count and reads no slot past it; the plain version masks the
    dead slots with the penalty row, the TPU kernel's interface.
    """
    live = _live_slots(c, count)
    if not _on_card(q):
        return ref.lsh_bucket_min_penalty_ref(
            q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
            penalty_row(c.shape[0], live, q.device))
    from repro_torch.kernels import lsh_bucket_accept_cuda as binding

    d2_min = binding.launch_min(q_keys_lo, q_keys_hi, q, c_keys_lo,
                                c_keys_hi, c, count=live)
    LAUNCHES["lsh_bucket_min"] += 1
    return d2_min


def lsh_bucket_accept(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, mtd2,
                      count=None, *, c2: float):
    """`lsh_bucket_min` plus the Algorithm-4 acceptance probability, per
    candidate: ``(d2_min (B,), p_accept (B,))``, with p = 0 where
    mtd2 = 0."""
    live = _live_slots(c, count)
    if not _on_card(q):
        return ref.lsh_bucket_accept_penalty_ref(
            q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
            penalty_row(c.shape[0], live, q.device), mtd2, c2=c2)
    from repro_torch.kernels import lsh_bucket_accept_cuda as binding

    d2_min, p = binding.launch(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi,
                               c, mtd2, count=live, c2=c2)
    LAUNCHES["lsh_bucket_accept"] += 1
    return d2_min, p


def lsh_bucket_accept_lanes(q_keys_lo, q_keys_hi, q, lanes, c_keys_lo,
                            c_keys_hi, c, mtd2, count=None, *, c2: float):
    """`lsh_bucket_accept` over the candidates of B lanes in one launch:
    candidate b (keys (L, S), coordinates (S, D), mtd2 (S,)) is scored
    against the center slots of lane ``lanes[b]`` (int64 in 0..B-1), keys
    (B, L, K) and coordinates (B, K, D), the first `count` live in every
    lane.  Lanes may hold blocks of any sizes, in any order.  Returns
    ``(d2_min (S,), p_accept (S,))``."""
    live = _live_slots(c[0], count)
    if not _on_card(q):
        return ref.lsh_bucket_accept_lanes_penalty_ref(
            q_keys_lo, q_keys_hi, q, lanes, c_keys_lo, c_keys_hi, c,
            penalty_row(c.shape[1], live, q.device), mtd2, c2=c2)
    from repro_torch.kernels import lsh_bucket_accept_cuda as binding

    out = binding.launch_lanes(q_keys_lo, q_keys_hi, q, lanes, c_keys_lo,
                               c_keys_hi, c, mtd2, count=live, c2=c2)
    LAUNCHES["lsh_bucket_accept"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """Exact softmax attention on q, k (BH, S, D) and v (BH, S, Dv), f32
    out (BH, S, Dv): the TPU kernel's signature.  Any S (the kernel guards
    its ragged edge), Dv <= D <= 256."""
    if _META_COUNT is not None:
        return _meta_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               scale, causal, 0)[:, :, 0]
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal)
    from repro_torch.kernels import flash_attention_cuda as binding

    out = binding.launch(q[:, :, None], k[:, :, None], v[:, :, None],
                         scale=scale, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out[:, :, 0]


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool,
                   prefix_len: int = 0) -> torch.Tensor:
    """The model's attention: q (B, S, H, D) over k (B, S, Hk, D) and v
    (B, S, Hk, Dv), Dv <= D (MLA's v is narrower than its q and k), GQA
    head h reading KV head h // (H // Hk); (B, S, H, Dv) f32 out.  Causal,
    the first `prefix_len` positions (the vlm prefix) also see each other,
    as the JAX package masks them; `prefix_len` does nothing non-causal.

    The CUDA kernel reads all three through their strides, so nothing is
    copied.  Where autograd records a gradient for any of them, the launch
    goes through `_FlashAttention`, whose backward is the backward kernel.
    """
    if _META_COUNT is not None:
        return _meta_attention(q, k, v, scale, causal, prefix_len)
    if not _on_card(q):
        return ref.attention_bshd_ref(q, k, v, scale=scale, causal=causal,
                                      prefix_len=prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, causal, prefix_len)
    from repro_torch.kernels import flash_attention_cuda as binding

    out = binding.launch(q, k, v, scale=scale, causal=causal,
                         prefix_len=prefix_len)
    LAUNCHES["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """`attention_bshd` on the card with its gradient: the forward kernel
    with its log-sum-exp, saved with q, k, v and the output; the backward
    kernel for dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, prefix_len):
        from repro_torch.kernels import flash_attention_cuda as binding

        out, lse = binding.launch(q, k, v, scale=scale, causal=causal,
                                  prefix_len=prefix_len, with_lse=True)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import flash_attention_cuda as binding

        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, prefix_len = ctx.args
        dq, dk, dv = binding.launch_backward(q, k, v, out, dout, lse,
                                             scale=scale, causal=causal,
                                             prefix_len=prefix_len)
        LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


def split_codes_u64(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 cell codes -> two int32 planes (low, high)."""
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    hi = (codes >> np.uint64(32)).astype(np.int64).astype(np.int32)
    return lo, hi
