"""PyTorch/CUDA port of the fast k-means++ seeding library.

The package mirrors the JAX reference package module by module
(`repro_torch.core.plan`, `repro_torch.kernels.ops`, ...).  Plain tensor code
is PyTorch; every kernel on the main path is a hand-written CUDA C++ kernel
for Hopper (`sm_90a`) under `repro_torch/csrc/`, compiled with `nvcc` on
first use and bound with `ctypes`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""
