"""Binding of `csrc/tree_sep_update.cu`: argument checks and launches.

`launch` and `launch_tiles` (one lane, a given center column) and
`launch_lanes` and `launch_tiles_lanes` (B lanes in one launch, each
opening its own point) take CUDA tensors only: they check device, dtype,
shape and strides, allocate the outputs with `torch.empty`, launch on the
current stream of w's device (made current for the launch) and raise
when the launch returns a CUDA error.  All four run the same two kernels.
The public wrappers, with padding, dispatch and launch counts, are
`ops.tree_sep_update`, `ops.tree_sep_update_tiles` and their `_lanes`
forms.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, launch_on

__all__ = ["launch", "launch_tiles", "launch_lanes", "launch_tiles_lanes",
           "MAX_ROWS", "MAX_LANES"]

MAX_ROWS = 64      # the kernel stages at most 64 center code rows
MAX_LANES = 65535  # the grid's second axis

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("tree_sep_update"), name)
        head = [_P, _P, _I64, _P, _P, _I64, _I64, _P, _P, _P]
        if name == "tree_sep_update_launch":
            fn.argtypes = head + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 \
                + [_P]
        else:
            fn.argtypes = head + [_P] + [ctypes.c_int] * 4 \
                + [ctypes.c_float] * 2 + [_P]
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
    # One lane: the given column, no lane strides, no point indices.
    return (h, n, 1, (codes_lo, codes_hi, center_lo, center_hi, w),
            (codes_lo.data_ptr(), codes_hi.data_ptr(), 0,
             center_lo.data_ptr(), center_hi.data_ptr(), 0,
             center_lo.stride(0), None))


def _check_lanes(codes_lo, codes_hi, x, w):
    """Codes (B, H, n) with contiguous rows and any lane stride (0 shares
    one copy), x (B,) int64, w (B, n): the lane j column is x[j]'s."""
    b, h, n = check_tensor("codes_lo", codes_lo, torch.int32, 3,
                           contiguous=False)
    check_tensor("codes_hi", codes_hi, torch.int32, 3, shape=(b, h, n),
                 contiguous=False)
    check_tensor("x", x, torch.int64, 1, shape=(b,))
    check_tensor("w", w, torch.float32, 2, shape=(b, n))
    lane_stride = codes_lo.stride(0)
    for name, t in (("codes_lo", codes_lo), ("codes_hi", codes_hi)):
        if t.stride()[1:] != (n, 1) or t.stride(0) != lane_stride:
            raise ValueError(f"{name} needs contiguous (H, n) planes and one "
                             f"lane stride, got strides {t.stride()}")
    if h > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} code rows, got {h}")
    if not 1 <= b <= MAX_LANES:
        raise ValueError(f"1 to {MAX_LANES} lanes, got {b}")
    return (h, n, b, (codes_lo, codes_hi, x, w),
            (codes_lo.data_ptr(), codes_hi.data_ptr(), lane_stride,
             codes_lo.data_ptr(), codes_hi.data_ptr(), lane_stride, n,
             x.data_ptr()))


def _sweep(checked, w, scale, num_levels):
    h, n, b, tensors, ptrs = checked
    check_cuda(*tensors)
    out = torch.empty_like(w)
    launch_on("tree_sep_update", w.device, _fn("tree_sep_update_launch"),
              *ptrs, w.data_ptr(), out.data_ptr(), h, n, b, scale,
              2.0 ** (1.0 - num_levels))
    return out


def _sweep_tiles(checked, w, scale, num_levels, tile):
    h, n, b, tensors, ptrs = checked
    if tile % 32 or not 32 <= tile <= 1024 or n % tile:
        raise ValueError(f"tile must be a multiple of 32 in [32, 1024] that "
                         f"divides n; got tile={tile}, n={n}")
    check_cuda(*tensors)
    out = torch.empty_like(w)
    sums = torch.empty(w.shape[:-1] + (n // tile,), dtype=torch.float32,
                       device=w.device)
    launch_on("tree_sep_update_tiles", w.device,
              _fn("tree_sep_update_tiles_launch"), *ptrs, w.data_ptr(),
              out.data_ptr(), sums.data_ptr(), h, n, tile, b, scale,
              2.0 ** (1.0 - num_levels))
    return out, sums


def launch(codes_lo, codes_hi, center_lo, center_hi, w, *, scale: float,
           num_levels: int) -> torch.Tensor:
    """w' = min(w, tree_dist(center)^2) for every point; (n,) f32."""
    return _sweep(_check(codes_lo, codes_hi, center_lo, center_hi, w), w,
                  scale, num_levels)


def launch_tiles(codes_lo, codes_hi, center_lo, center_hi, w, *,
                 scale: float, num_levels: int, tile: int):
    """(w' (n,), per-tile sums of w' (n // tile,)); n % tile == 0."""
    return _sweep_tiles(_check(codes_lo, codes_hi, center_lo, center_hi, w),
                        w, scale, num_levels, tile)


def launch_lanes(codes_lo, codes_hi, x, w, *, scale: float,
                 num_levels: int) -> torch.Tensor:
    """The sweep of B lanes in one launch, lane j opening point x[j] of its
    own planes: (B, n) f32."""
    return _sweep(_check_lanes(codes_lo, codes_hi, x, w), w, scale,
                  num_levels)


def launch_tiles_lanes(codes_lo, codes_hi, x, w, *, scale: float,
                       num_levels: int, tile: int):
    """`launch_lanes` plus per-tile sums: (w' (B, n), sums (B, n // tile));
    n % tile == 0."""
    return _sweep_tiles(_check_lanes(codes_lo, codes_hi, x, w), w, scale,
                        num_levels, tile)
