"""Binding of `csrc/lsh_bucket_accept.cu`: argument checks and the launch.

`launch` takes padded CUDA tensors (the padding, dispatch and launch-count
wrapper is `ops.lsh_bucket_accept`), allocates the two outputs with
`torch.empty`, launches on the current stream and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check_cuda, check_tensor, raise_on_error

__all__ = ["launch", "BLOCK_B", "BLOCK_K"]

BLOCK_B = 8    # candidates per block (kWarps in the source)
BLOCK_K = 32   # center slots per shared-memory tile (kTile in the source)

_P = ctypes.c_void_p
_bound: list = []


def _fn():
    if not _bound:
        fn = _build.library("lsh_bucket_accept").lsh_bucket_accept_launch
        fn.argtypes = [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _bound.append(fn)
    return _bound[0]


def launch(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty, mtd2,
           *, c2: float):
    """(d2_min (B,), p_accept (B,)) for candidates against center slots.

    Shapes: keys (L, B) / (L, K) int32, q (B, D) and c (K, D) f32,
    penalty (K,) f32 (0 live, `LSH_MISS` dead), mtd2 (B,) f32, with
    B % BLOCK_B == 0 and K % BLOCK_K == 0.
    """
    l, b = check_tensor("q_keys_lo", q_keys_lo, torch.int32, 2)
    check_tensor("q_keys_hi", q_keys_hi, torch.int32, 2, shape=(l, b))
    _, d = check_tensor("q", q, torch.float32, 2, shape=(b, None))
    k, _ = check_tensor("c", c, torch.float32, 2, shape=(None, d))
    check_tensor("c_keys_lo", c_keys_lo, torch.int32, 2, shape=(l, k))
    check_tensor("c_keys_hi", c_keys_hi, torch.int32, 2, shape=(l, k))
    check_tensor("penalty", penalty, torch.float32, 1, shape=(k,))
    check_tensor("mtd2", mtd2, torch.float32, 1, shape=(b,))
    if b % BLOCK_B or k % BLOCK_K:
        raise ValueError(f"B must be a multiple of {BLOCK_B} and K of "
                         f"{BLOCK_K}; got B={b}, K={k}")
    check_cuda(q_keys_lo, q_keys_hi, q, c_keys_lo, c_keys_hi, c, penalty,
               mtd2)
    d2_min = torch.empty(b, dtype=torch.float32, device=q.device)
    p = torch.empty_like(d2_min)
    err = _fn()(
        q_keys_lo.data_ptr(), q_keys_hi.data_ptr(), q.data_ptr(),
        c_keys_lo.data_ptr(), c_keys_hi.data_ptr(), c.data_ptr(),
        penalty.data_ptr(), mtd2.data_ptr(), d2_min.data_ptr(), p.data_ptr(),
        l, b, k, d, c2, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("lsh_bucket_accept", err)
    return d2_min, p
