"""Binding of `csrc/pairwise_argmin.cu`: argument checks and the launch.

`launch` takes CUDA tensors with the center slots padded to `BLOCK_K` (the
padding, dispatch and launch-count wrapper is `ops.pairwise_argmin`),
allocates the outputs and the kernel's scratch (the center rows padded to
`PANEL_BYTES` and their |c|^2) with `torch.empty`, launches on the current
stream of x's device (made current for the launch) and raises on a CUDA
error.  Points are read in place: any n, any
row alignment.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, launch_on

__all__ = ["launch", "BLOCK_K", "MAX_D", "DTYPES"]

BLOCK_K = 128       # center slots per tile (kTileK in the source)
PANEL_BYTES = 128   # a center row pads to a multiple of this (kPanelBytes)
# The largest d whose point tile of 32 rows fits in shared memory beside
# the ring (smem_bytes<kF32, 1> in the source).
MAX_D = {torch.float32: 656, torch.bfloat16: 2624}
DTYPES = {torch.float32: "pairwise_argmin_f32_launch",
          torch.bfloat16: "pairwise_argmin_bf16_launch"}

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("pairwise_argmin"), name)
        fn.argtypes = [_P] * 7 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def launch(x: torch.Tensor, c: torch.Tensor,
           count: torch.Tensor | None = None):
    """(min_d2 (n,) f32, argmin (n,) int32) of points against center slots.

    Shapes: x (n, d) and c (k, d), both f32 or both bf16, with
    1 <= d <= `MAX_D` and k a positive multiple of `BLOCK_K`.  `count`,
    one int32 on x's device or None, limits the sweep to slots
    0 .. min(count, k - 1); the kernel reads it, so nothing syncs.
    """
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {sorted(map(str, DTYPES))}, got "
                        f"{x.dtype}")
    n, d = check_tensor("x", x, x.dtype, 2)
    k, _ = check_tensor("c", c, x.dtype, 2, shape=(None, d))
    if k % BLOCK_K or k == 0:
        raise ValueError(f"k must be a positive multiple of {BLOCK_K}; got "
                         f"k={k}")
    if not 1 <= d <= MAX_D[x.dtype]:
        raise ValueError(f"d must be in 1..{MAX_D[x.dtype]} for {x.dtype}, "
                         f"got {d}")
    if count is not None:
        check_tensor("count", count.reshape(-1), torch.int32, 1, shape=(1,))
        check_cuda(x, c, count)
    else:
        check_cuda(x, c)
    step = PANEL_BYTES // x.element_size()
    c_pad = torch.empty((k, -(-d // step) * step), dtype=x.dtype,
                        device=x.device)
    c_sq = torch.empty(k, dtype=torch.float32, device=x.device)
    d2_min = torch.empty(n, dtype=torch.float32, device=x.device)
    arg = torch.empty(n, dtype=torch.int32, device=x.device)
    launch_on("pairwise_argmin", x.device, _fn(DTYPES[x.dtype]),
              x.data_ptr(), c.data_ptr(), c_pad.data_ptr(), c_sq.data_ptr(),
              None if count is None else count.data_ptr(), d2_min.data_ptr(),
              arg.data_ptr(), n, k, d)
    return d2_min, arg
