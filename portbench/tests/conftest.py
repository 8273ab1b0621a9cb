"""Fixtures of the benchmark's tests.

Run from the repository's root: ``python -m pytest -q portbench/tests``
(the card's tests: add ``-m cuda``; they skip where there is no card).
"""

from __future__ import annotations

from pathlib import Path

import pytest

from _portbench_tiny import make_root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)


@pytest.fixture
def cuda_device():
    """'cuda', or a skip where this machine has no card (decided here, not
    when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
