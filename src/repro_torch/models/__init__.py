"""Model stack: layers, GQA and MLA attention, the clustered KV cache,
MoE, Mamba, RWKV-6, the audio and vlm inputs, composition; the serving
entries and `loss_fn` for training."""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    empty_cache,
    forward,
    loss_fn,
    make_batch_specs,
    make_cache_specs,
    num_text_tokens,
    param_specs,
)
from repro_torch.models.params import (  # noqa: F401
    ParamSpec,
    init_params,
    params_from_numpy,
    spec_bytes,
)
