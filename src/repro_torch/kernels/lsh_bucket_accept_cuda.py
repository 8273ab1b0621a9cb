"""Binding of `csrc/lsh_bucket_accept.cu`: argument checks and the launches.

`launch` (the query with its acceptance epilogue), `launch_lanes` (the
same over the candidates of B lanes, each reading its own lane's center
slots) and `launch_min` (the query alone) take CUDA tensors of any B and K
and the number of live center slots, `count` (the dispatch and
launch-count wrappers are `ops.lsh_bucket_accept`, its `_lanes` form and
`ops.lsh_bucket_min`), allocate the outputs and the kernel's scratch with
`torch.empty`, launch on the current stream of q's device (made current
for the launch) and raise on a CUDA error.  The kernel guards both edges
and reads no slot at or past `count`, so nothing is padded and no penalty
row is built.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, launch_on

__all__ = ["launch", "launch_lanes", "launch_min"]

_SLOT_CHUNK = 32   # slots a warp takes per step: the scratch's row bound

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("lsh_bucket_accept"), name)
        if name == "lsh_bucket_accept_launch":
            fn.argtypes = [_P] * 7 + [ctypes.c_longlong] * 2 + [_P] * 4 \
                + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
        else:
            fn.argtypes = [_P] * 8 + [ctypes.c_int] * 5 + [_P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, count):
    """Shapes: keys (L, B) / (L, K) int32, q (B, D) and c (K, D) f32, and
    0 <= count <= K live slots; returns (L, B, K, D, count)."""
    l, b = check_tensor("q_keys_lo", q_keys_lo, torch.int32, 2)
    check_tensor("q_keys_hi", q_keys_hi, torch.int32, 2, shape=(l, b))
    _, d = check_tensor("q", q, torch.float32, 2, shape=(b, None))
    k, _ = check_tensor("c", c, torch.float32, 2, shape=(None, d))
    check_tensor("c_keys_lo", c_keys_lo, torch.int32, 2, shape=(l, k))
    check_tensor("c_keys_hi", c_keys_hi, torch.int32, 2, shape=(l, k))
    count = int(count)
    if not 0 <= count <= k:
        raise ValueError(f"count must be in 0..{k} (the center slots), "
                         f"got {count}")
    return l, b, k, d, count


def _scratch(b: int, count: int, device) -> torch.Tensor:
    """The kernel's per-chunk partial minima: ceil(count / 32) x B f32."""
    return torch.empty((max(1, -(-count // _SLOT_CHUNK)), b),
                       dtype=torch.float32, device=device)


def _accept(q_keys_lo, q_keys_hi, q, lanes, c_keys_lo, c_keys_hi, c, mtd2,
            dims, c2):
    """The accept launch; `lanes` None reads lane 0's slots only."""
    l, b, k, d, count = dims
    check_tensor("mtd2", mtd2, torch.float32, 1, shape=(b,))
    tensors = (q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, mtd2)
    check_cuda(*tensors, *(() if lanes is None else (lanes,)))
    d2_min = torch.empty(b, dtype=torch.float32, device=q.device)
    p = torch.empty_like(d2_min)
    launch_on(
        "lsh_bucket_accept", q.device, _fn("lsh_bucket_accept_launch"),
        q_keys_lo.data_ptr(), q_keys_hi.data_ptr(), q.data_ptr(),
        None if lanes is None else lanes.data_ptr(), c_keys_lo.data_ptr(),
        c_keys_hi.data_ptr(), c.data_ptr(), l * k, k * d, mtd2.data_ptr(),
        _scratch(b, count, q.device).data_ptr(), d2_min.data_ptr(),
        p.data_ptr(), l, b, k, d, count, c2)
    return d2_min, p


def launch(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, mtd2, *,
           count: int, c2: float):
    """(d2_min (B,), p_accept (B,)) for candidates against the first
    `count` center slots; shapes as in `_check`, plus mtd2 (B,) f32."""
    dims = _check(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, count)
    return _accept(q_keys_lo, q_keys_hi, q, None, c_keys_lo, c_keys_hi, c,
                   mtd2, dims, c2)


def launch_lanes(q_keys_lo, q_keys_hi, q, lanes, c_keys_lo, c_keys_hi, c,
                 mtd2, *, count: int, c2: float):
    """`launch` over the candidates of several lanes: candidate b reads the
    slots of lane lanes[b] (int64, (B,)), keys (lanes, L, K) and
    coordinates (lanes, K, D), the first `count` of them live."""
    n_lanes = check_tensor("c", c, torch.float32, 3)[0]
    check_tensor("c_keys_lo", c_keys_lo, torch.int32, 3)
    check_tensor("c_keys_hi", c_keys_hi, torch.int32, 3,
                 shape=tuple(c_keys_lo.shape))
    if c_keys_lo.shape[0] != n_lanes:
        raise ValueError(f"center keys of {c_keys_lo.shape[0]} lanes and "
                         f"coordinates of {n_lanes}")
    dims = _check(q_keys_lo, q_keys_hi, q, c_keys_lo[0], c_keys_hi[0], c[0],
                  count)
    check_tensor("lanes", lanes, torch.int64, 1, shape=(dims[1],))
    return _accept(q_keys_lo, q_keys_hi, q, lanes, c_keys_lo, c_keys_hi, c,
                   mtd2, dims, c2)


def launch_min(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, *,
               count: int):
    """d2_min (B,) for candidates against the first `count` center slots:
    the query without the acceptance epilogue; shapes as in `_check`."""
    l, b, k, d, count = _check(q_keys_lo, q_keys_hi, q, c_keys_lo,
                               c_keys_hi, c, count)
    check_cuda(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c)
    d2_min = torch.empty(b, dtype=torch.float32, device=q.device)
    launch_on(
        "lsh_bucket_min", q.device, _fn("lsh_bucket_min_launch"),
        q_keys_lo.data_ptr(), q_keys_hi.data_ptr(), q.data_ptr(),
        c_keys_lo.data_ptr(), c_keys_hi.data_ptr(), c.data_ptr(),
        _scratch(b, count, q.device).data_ptr(), d2_min.data_ptr(), l, b, k,
        d, count)
    return d2_min
