"""Argument checks shared by the kernel bindings.

A binding hands raw pointers to CUDA code, so every tensor is checked in
Python first: dtype, rank and shape, contiguity, and — last — that all of
them lie on one CUDA device.  Checks raise; nothing falls back.  The launch
itself goes through `launch_on`, which makes the tensors' device current.
"""

from __future__ import annotations

import torch

__all__ = ["CudaLaunchError", "check_tensor", "check_cuda", "raise_on_error",
           "launch_on"]


class CudaLaunchError(RuntimeError):
    """A kernel launch that returned a non-zero ``cudaError_t``: `kernel`
    names the binding and `code` is the error's number."""

    def __init__(self, kernel: str, code: int):
        super().__init__(f"{kernel}: CUDA launch failed with cudaError_t "
                         f"{code}")
        self.kernel = kernel
        self.code = int(code)

    def __reduce__(self):
        return type(self), (self.kernel, self.code)


def check_tensor(name: str, t, dtype: torch.dtype, ndim: int, *,
                 shape: tuple | None = None,
                 contiguous: bool = True) -> tuple:
    """Raise unless `t` is a tensor of `dtype`, rank `ndim`, the given
    shape (``None`` entries match any size) and (by default) C-contiguous;
    returns its shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if shape is not None and any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return tuple(t.shape)


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"a CUDA kernel got a tensor on {t.device}; "
                             "CPU tensors take the plain version in ops")
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}: one device")


def raise_on_error(kernel: str, err: int) -> None:
    """Raise `CudaLaunchError` when a launch returned a non-zero
    cudaError_t."""
    if err != 0:
        raise CudaLaunchError(kernel, err)


def launch_on(kernel: str, device: torch.device, fn, *args) -> None:
    """Call the C launch ``fn(*args, stream)`` with `device` current, on
    that device's current stream, and raise when it returns a non-zero
    cudaError_t.

    A launch, and the `cudaFuncSetAttribute` and `cudaGetDevice` calls
    inside it, act on the thread's current device, not on the device of
    the pointers they are given: without the guard a tensor on cuda:1
    would be swept by a kernel launched on cuda:0.
    """
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    raise_on_error(kernel, err)
