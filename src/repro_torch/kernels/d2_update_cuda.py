"""Binding of `csrc/d2_update.cu`: argument checks and launches.

`launch` and `launch_tiles` take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the outputs (and the tiles entry's
scratch of one float per 32 rows) with `torch.empty`, launch on the
current stream of w's device (made current for the launch) and raise
when the launch returns a CUDA error.  Any n,
any d and any alignment of x and w: the kernel guards them, and nothing
here pads or copies x.  The public wrappers, with dispatch and launch
counts, are `ops.d2_update` and `ops.d2_update_tiles`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, launch_on

__all__ = ["launch", "launch_tiles", "DTYPES"]

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("d2_update"), name)
        if "_tiles_" in name:
            fn.argtypes = [_P] * 6 + [ctypes.c_int] * 3 + [_P]
        else:
            fn.argtypes = [_P] * 4 + [ctypes.c_int] * 2 + [_P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(x, center, w):
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {sorted(map(str, DTYPES))}, got "
                        f"{x.dtype}")
    n, d = check_tensor("x", x, x.dtype, 2)
    check_tensor("center", center, x.dtype, 1, shape=(d,))
    check_tensor("w", w, torch.float32, 1, shape=(n,))
    return n, d


def launch(x, center, w) -> torch.Tensor:
    """w' = min(w, ||x - center||^2) for every point; (n,) f32."""
    n, d = _check(x, center, w)
    check_cuda(x, center, w)
    out = torch.empty_like(w)
    launch_on("d2_update", w.device,
              _fn(f"d2_update_{DTYPES[x.dtype]}_launch"), x.data_ptr(),
              center.data_ptr(), w.data_ptr(), out.data_ptr(), n, d)
    return out


def launch_tiles(x, center, w, *, tile: int):
    """(w' (n_pad,) with zeros past n, per-tile sums of w' (n_pad // tile,))
    for any n; n_pad = ceil(n / tile) * tile."""
    n, d = _check(x, center, w)
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"tile must be a multiple of 32 in [32, 1024]; got "
                         f"tile={tile}")
    check_cuda(x, center, w)
    n_pad = -(-n // tile) * tile
    out = torch.empty(n_pad, dtype=torch.float32, device=w.device)
    sums = torch.empty(n_pad // tile, dtype=torch.float32, device=w.device)
    units = torch.empty(-(-n // 32), dtype=torch.float32, device=w.device)
    launch_on("d2_update_tiles", w.device,
              _fn(f"d2_update_tiles_{DTYPES[x.dtype]}_launch"),
              x.data_ptr(), center.data_ptr(), w.data_ptr(), out.data_ptr(),
              units.data_ptr(), sums.data_ptr(), n, d, tile)
    return out, sums
