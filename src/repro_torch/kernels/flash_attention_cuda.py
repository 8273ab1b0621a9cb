"""Binding of `csrc/flash_attention.cu`: argument checks and the launch.

`launch` takes CUDA tensors in the model's layout, q and k (B, S, H, D)
and (B, S, Hk, D) and v (B, S, Hk, Dv), read through their strides (the
head dimension must be contiguous, nothing else: any S, any D in 1..256,
any Dv in 1..D, any alignment), allocates the f32 output (B, S, H, Dv)
with `torch.empty`, launches on the current stream of q's
device (made current for the launch) and raises on a CUDA error.  bf16
runs on the tensor cores, f32 on the SIMT kernel; the source chooses
16-byte `cp.async` or element loads from the strides and pointers it is
given.  The wrappers that count launches are
`ops.flash_attention` and `ops.attention_bshd`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, launch_on

__all__ = ["launch", "MAX_D", "DTYPES"]

MAX_D = 256     # the TPU kernel's stated limit; the bf16 route pads D to 256
DTYPES = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_bf16_launch"}

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("flash_attention"), name)
        fn.argtypes = [_P] * 4 + [ctypes.c_int] * 6 + [
            _P, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(name: str, t, dtype, shape) -> None:
    """`check_tensor` with any strides but a contiguous head dimension."""
    check_tensor(name, t, dtype, 4, shape=shape, contiguous=False)
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head dimension must be contiguous")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool, prefix_len: int = 0) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k (B, S, Hk, D) and v
    (B, S, Hk, Dv): (B, S, H, Dv) f32.  Causal, the first `prefix_len`
    positions also see each other (the vlm prefix).

    q, k and v are all f32 or all bf16; 1 <= Dv <= D <= `MAX_D`; Hk
    divides H; `prefix_len` >= 0.
    """
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
    check_cuda(q, k, v)
    out = torch.empty((b, s, h, dv), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    launch_on("flash_attention", q.device, _fn(DTYPES[q.dtype]),
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
              h, hk, d, dv, ctypes.cast(strides, _P), float(scale),
              int(bool(causal)), min(int(prefix_len), s))
    return out
