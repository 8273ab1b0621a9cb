"""Binding of `csrc/tree_sep_update.cu`: argument checks and launches.

`launch` and `launch_tiles` take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the outputs with `torch.empty`, launch
on the current stream and raise when the launch returns a CUDA error.  The
public wrappers, with padding, dispatch and launch counts, are
`ops.tree_sep_update` and `ops.tree_sep_update_tiles`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, raise_on_error

__all__ = ["launch", "launch_tiles", "MAX_ROWS"]

MAX_ROWS = 64      # the kernel stages at most 64 center code rows

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("tree_sep_update"), name)
        common = [_P, _P, _P, _P, ctypes.c_longlong, _P, _P]
        if name == "tree_sep_update_launch":
            fn.argtypes = common + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_float, _P]
        else:
            fn.argtypes = common + [_P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float,
                                    ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(codes_lo, codes_hi, center_lo, center_hi, w):
    h, n = check_tensor("codes_lo", codes_lo, torch.int32, 2)
    check_tensor("codes_hi", codes_hi, torch.int32, 2, shape=(h, n))
    check_tensor("w", w, torch.float32, 1, shape=(n,))
    for name, col in (("center_lo", center_lo), ("center_hi", center_hi)):
        # The center column may be a strided view into the code planes.
        check_tensor(name, col, torch.int32, 1, shape=(h,), contiguous=False)
    if center_lo.stride() != center_hi.stride():
        raise ValueError("center_lo and center_hi need the same stride, got "
                         f"{center_lo.stride()} and {center_hi.stride()}")
    if h > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} code rows, got {h}")
    return h, n


def launch(codes_lo, codes_hi, center_lo, center_hi, w, *, scale: float,
           num_levels: int) -> torch.Tensor:
    """w' = min(w, tree_dist(center)^2) for every point; (n,) f32."""
    h, n = _check(codes_lo, codes_hi, center_lo, center_hi, w)
    check_cuda(codes_lo, codes_hi, center_lo, center_hi, w)
    out = torch.empty_like(w)
    err = _fn("tree_sep_update_launch")(
        codes_lo.data_ptr(), codes_hi.data_ptr(), center_lo.data_ptr(),
        center_hi.data_ptr(), center_lo.stride(0), w.data_ptr(),
        out.data_ptr(), h, n, scale, 2.0 ** (1.0 - num_levels),
        torch.cuda.current_stream(w.device).cuda_stream)
    raise_on_error("tree_sep_update", err)
    return out


def launch_tiles(codes_lo, codes_hi, center_lo, center_hi, w, *,
                 scale: float, num_levels: int, tile: int):
    """(w' (n,), per-tile sums of w' (n // tile,)); n % tile == 0."""
    h, n = _check(codes_lo, codes_hi, center_lo, center_hi, w)
    if tile % 32 or not 32 <= tile <= 1024 or n % tile:
        raise ValueError(f"tile must be a multiple of 32 in [32, 1024] that "
                         f"divides n; got tile={tile}, n={n}")
    check_cuda(codes_lo, codes_hi, center_lo, center_hi, w)
    out = torch.empty_like(w)
    sums = torch.empty(n // tile, dtype=torch.float32, device=w.device)
    err = _fn("tree_sep_update_tiles_launch")(
        codes_lo.data_ptr(), codes_hi.data_ptr(), center_lo.data_ptr(),
        center_hi.data_ptr(), center_lo.stride(0), w.data_ptr(),
        out.data_ptr(), sums.data_ptr(), h, n, tile, scale,
        2.0 ** (1.0 - num_levels),
        torch.cuda.current_stream(w.device).cuda_stream)
    raise_on_error("tree_sep_update_tiles", err)
    return out, sums
