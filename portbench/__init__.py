"""The benchmark of `repro_torch`, the PyTorch and CUDA port (`run.py`).

It imports nothing of the JAX package, nor JAX, nor `benchmarks/`.
"""
