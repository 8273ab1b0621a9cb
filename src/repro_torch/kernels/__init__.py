"""Kernel layer: hand-written CUDA kernels (`csrc/`), their plain PyTorch
versions (`ref.py`) and the padding/dispatch wrappers (`ops.py`)."""

from repro_torch.kernels.ops import (  # noqa: F401
    LSH_MISS,
    attention_bshd,
    d2_update,
    d2_update_tiles,
    flash_attention,
    launch_counts,
    lsh_bucket_accept,
    lsh_bucket_min,
    pairwise_argmin,
    reset_launch_counts,
    split_codes_u64,
    tree_sep_update,
    tree_sep_update_tiles,
)
