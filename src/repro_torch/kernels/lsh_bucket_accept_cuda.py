"""Binding of `csrc/lsh_bucket_accept.cu`: argument checks and the launches.

`launch` (the query with its acceptance epilogue) and `launch_min` (the
query alone) take padded CUDA tensors (the padding, dispatch and
launch-count wrappers are `ops.lsh_bucket_accept` and `ops.lsh_bucket_min`),
allocate the outputs with `torch.empty`, launch on the current stream and
raise on a CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, raise_on_error

__all__ = ["launch", "launch_min", "BLOCK_B", "BLOCK_K"]

BLOCK_B = 8    # candidates per block (kWarps in the source)
BLOCK_K = 32   # center slots per shared-memory tile (kTile in the source)

_P = ctypes.c_void_p
_bound: dict[str, object] = {}


def _fn(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.library("lsh_bucket_accept"), name)
        if name == "lsh_bucket_accept_launch":
            fn.argtypes = [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                             _P]
        else:
            fn.argtypes = [_P] * 8 + [ctypes.c_int] * 4 + [_P]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty):
    """Shapes: keys (L, B) / (L, K) int32, q (B, D) and c (K, D) f32,
    penalty (K,) f32 (0 live, `LSH_MISS` dead), with B % BLOCK_B == 0 and
    K % BLOCK_K == 0; returns (L, B, K, D)."""
    l, b = check_tensor("q_keys_lo", q_keys_lo, torch.int32, 2)
    check_tensor("q_keys_hi", q_keys_hi, torch.int32, 2, shape=(l, b))
    _, d = check_tensor("q", q, torch.float32, 2, shape=(b, None))
    k, _ = check_tensor("c", c, torch.float32, 2, shape=(None, d))
    check_tensor("c_keys_lo", c_keys_lo, torch.int32, 2, shape=(l, k))
    check_tensor("c_keys_hi", c_keys_hi, torch.int32, 2, shape=(l, k))
    check_tensor("penalty", penalty, torch.float32, 1, shape=(k,))
    if b % BLOCK_B or k % BLOCK_K:
        raise ValueError(f"B must be a multiple of {BLOCK_B} and K of "
                         f"{BLOCK_K}; got B={b}, K={k}")
    return l, b, k, d


def launch(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty, mtd2,
           *, c2: float):
    """(d2_min (B,), p_accept (B,)) for candidates against center slots;
    shapes as in `_check`, plus mtd2 (B,) f32."""
    l, b, k, d = _check(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
                        penalty)
    check_tensor("mtd2", mtd2, torch.float32, 1, shape=(b,))
    check_cuda(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty,
               mtd2)
    d2_min = torch.empty(b, dtype=torch.float32, device=q.device)
    p = torch.empty_like(d2_min)
    err = _fn("lsh_bucket_accept_launch")(
        q_keys_lo.data_ptr(), q_keys_hi.data_ptr(), q.data_ptr(),
        c_keys_lo.data_ptr(), c_keys_hi.data_ptr(), c.data_ptr(),
        penalty.data_ptr(), mtd2.data_ptr(), d2_min.data_ptr(), p.data_ptr(),
        l, b, k, d, c2, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("lsh_bucket_accept", err)
    return d2_min, p


def launch_min(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty):
    """d2_min (B,) for candidates against center slots: the query without
    the acceptance epilogue; shapes as in `_check`."""
    l, b, k, d = _check(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c,
                        penalty)
    check_cuda(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty)
    d2_min = torch.empty(b, dtype=torch.float32, device=q.device)
    err = _fn("lsh_bucket_min_launch")(
        q_keys_lo.data_ptr(), q_keys_hi.data_ptr(), q.data_ptr(),
        c_keys_lo.data_ptr(), c_keys_hi.data_ptr(), c.data_ptr(),
        penalty.data_ptr(), d2_min.data_ptr(), l, b, k, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("lsh_bucket_min", err)
    return d2_min
