"""Binding of `csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`:
argument checks and the launches.

`launch` takes CUDA tensors in the model's layout, q and k (B, S, H, D)
and (B, S, Hk, D) and v (B, S, Hk, Dv), read through their strides (the
head dimension must be contiguous, nothing else: any S, any D in 1..256,
any Dv in 1..D, any alignment), allocates the f32 output (B, S, H, Dv)
with `torch.empty`, launches on the current stream of q's
device (made current for the launch) and raises on a CUDA error.  bf16
runs on the tensor cores, f32 on the SIMT kernel; the source chooses
16-byte `cp.async` or element loads from the strides and pointers it is
given.  With ``with_lse=True`` it also returns each row's log-sum-exp,
(B, H, S) f32, and `out` keeps its bits.

`launch_backward` takes the forward's inputs, its f32 output and that
log-sum-exp, and the output's gradient, and returns dq, dk and dv in the
inputs' dtype (three launches of the backward source: delta, dK and dV,
dQ; no atomics, so a second call gives the same bits).  The wrappers that
count launches are `ops.flash_attention` and `ops.attention_bshd` (and its
gradient, ``flash_attention_bwd``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, launch_on

__all__ = ["launch", "launch_backward", "MAX_D", "DTYPES", "BWD_DTYPES"]

MAX_D = 256     # the TPU kernel's stated limit; the bf16 route pads D to 256
DTYPES = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_bf16_launch"}
BWD_DTYPES = {torch.float32: "flash_attention_bwd_f32_launch",
              torch.bfloat16: "flash_attention_bwd_bf16_launch"}

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("flash_attention"), name)
        fn.argtypes = [_P] * 4 + [ctypes.c_int] * 6 + [
            _P, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P, _P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _bwd_fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("flash_attention_bwd"), name)
        fn.argtypes = [_P] * 10 + [ctypes.c_int] * 6 + [
            _P, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(name: str, t, dtype, shape) -> None:
    """`check_tensor` with any strides but a contiguous head dimension."""
    check_tensor(name, t, dtype, 4, shape=shape, contiguous=False)
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head dimension must be contiguous")


def _check_qkv(q, k, v, prefix_len: int) -> tuple:
    """Raise unless q, k, v and `prefix_len` are what the kernels take;
    returns (B, S, H, Hk, D, Dv)."""
    if not isinstance(q, torch.Tensor) or q.dtype not in DTYPES:
        raise TypeError(f"q must be a tensor of one of "
                        f"{sorted(map(str, DTYPES))}, got "
                        f"{getattr(q, 'dtype', type(q))}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    b, s, h, d = q.shape
    _check("q", q, q.dtype, (b, s, h, d))
    _check("k", k, q.dtype, (b, s, None, d))
    hk = k.shape[2]
    _check("v", v, q.dtype, (b, s, hk, None))
    dv = v.shape[3]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"head dimension {d} outside 1..{MAX_D}")
    if not 1 <= dv <= d:
        raise ValueError(f"v's head dimension {dv} outside 1..{d} (q's)")
    if hk < 1 or h % hk:
        raise ValueError(f"{hk} KV heads do not divide {h} query heads")
    if prefix_len < 0:
        raise ValueError(f"prefix_len {prefix_len} is negative")
    return b, s, h, hk, d, dv


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool, prefix_len: int = 0,
           with_lse: bool = False):
    """Attention of q (B, S, H, D) over k (B, S, Hk, D) and v
    (B, S, Hk, Dv): (B, S, H, Dv) f32.  Causal, the first `prefix_len`
    positions also see each other (the vlm prefix).  With `with_lse`,
    returns (out, lse), lse (B, H, S) f32 each row's log-sum-exp of its
    scaled scores.

    q, k and v are all f32 or all bf16; 1 <= Dv <= D <= `MAX_D`; Hk
    divides H; `prefix_len` >= 0.
    """
    b, s, h, hk, d, dv = _check_qkv(q, k, v, prefix_len)
    check_cuda(q, k, v)
    out = torch.empty((b, s, h, dv), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = _strides(q, k, v)
    launch_on("flash_attention", q.device, _fn(DTYPES[q.dtype]),
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
              h, hk, d, dv, ctypes.cast(strides, _P), float(scale),
              int(bool(causal)), min(int(prefix_len), s),
              lse.data_ptr() if with_lse else None)
    return (out, lse) if with_lse else out


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                    *, scale: float, causal: bool,
                    prefix_len: int = 0) -> tuple:
    """The gradients (dq, dk, dv) of `launch`'s output: q, k, v, the
    forward's f32 `out` and `lse` (``with_lse=True``) and the output's
    gradient `dout` (B, S, H, Dv), any dtype and strides (made a
    contiguous f32 here).  dq (B, S, H, D), dk (B, S, Hk, D) and dv
    (B, S, Hk, Dv) are contiguous, of q's dtype."""
    b, s, h, hk, d, dv = _check_qkv(q, k, v, prefix_len)
    check_tensor("out", out, torch.float32, 4, shape=(b, s, h, dv))
    check_tensor("lse", lse, torch.float32, 3, shape=(b, h, s))
    if tuple(dout.shape) != (b, s, h, dv):
        raise ValueError(f"dout must have shape {(b, s, h, dv)}, got "
                         f"{tuple(dout.shape)}")
    dout = dout.to(torch.float32).contiguous()
    check_cuda(q, k, v, out, dout, lse)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hk, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, s, hk, dv), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v)
    launch_on("flash_attention_bwd", q.device, _bwd_fn(BWD_DTYPES[q.dtype]),
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, s, h, hk, d,
              dv, ctypes.cast(strides, _P), float(scale), int(bool(causal)),
              min(int(prefix_len), s))
    return dq, dk, dvv
