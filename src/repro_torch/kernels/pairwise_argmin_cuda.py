"""Binding of `csrc/pairwise_argmin.cu`: argument checks and the launch.

`launch` takes padded CUDA tensors (the padding, dispatch and launch-count
wrapper is `ops.pairwise_argmin`), allocates the two outputs with
`torch.empty`, launches on the current stream and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, raise_on_error

__all__ = ["launch", "BLOCK_N", "BLOCK_K", "DTYPES"]

BLOCK_N = 128   # points per block (kTileN in the source)
BLOCK_K = 128   # center slots per tile (kTileK in the source)
DTYPES = {torch.float32: "pairwise_argmin_f32_launch",
          torch.bfloat16: "pairwise_argmin_bf16_launch"}

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("pairwise_argmin"), name)
        fn.argtypes = [_P] * 4 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def launch(x: torch.Tensor, c: torch.Tensor):
    """(min_d2 (n,) f32, argmin (n,) int32) of points against center slots.

    Shapes: x (n, d) and c (k, d), both f32 or both bf16, with
    n % BLOCK_N == 0 and k a positive multiple of BLOCK_K.
    """
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {sorted(map(str, DTYPES))}, got "
                        f"{x.dtype}")
    n, d = check_tensor("x", x, x.dtype, 2)
    k, _ = check_tensor("c", c, x.dtype, 2, shape=(None, d))
    if n % BLOCK_N or k % BLOCK_K or k == 0:
        raise ValueError(f"n must be a multiple of {BLOCK_N} and k a "
                         f"positive multiple of {BLOCK_K}; got n={n}, k={k}")
    check_cuda(x, c)
    d2_min = torch.empty(n, dtype=torch.float32, device=x.device)
    arg = torch.empty(n, dtype=torch.int32, device=x.device)
    err = _fn(DTYPES[x.dtype])(
        x.data_ptr(), c.data_ptr(), d2_min.data_ptr(), arg.data_ptr(), n, k,
        d, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("pairwise_argmin", err)
    return d2_min, arg
