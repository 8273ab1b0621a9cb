"""Mamba-1 block (Jamba's SSM layer): the selective state-space scan.

The counterpart of the JAX package's `models/mamba.py`.
The scan is plain PyTorch on the device (no TPU kernel exists for it: the
JAX package runs it as a `lax.scan`).  `mamba_forward` keeps the JAX
package's chunks of `CHUNK` steps and its rule that the length is a
multiple of ``min(CHUNK, L)``: within a chunk the per-step decays
exp(dt a) and inputs dt x B are formed at once, (B, chunk, d_inner,
d_state) f32, and the recurrence h_t = decay_t h_{t-1} + input_t is one
fused multiply-add a step (written into one buffer, or stacked where
autograd records); the outputs y_t = h_t . C_t then come from all
the chunk's states in one product.  The step math is f32 in both
packages; the storage type of the per-step inputs follows
`cfg.mamba_lowp_scan` (bf16 under it) as in the JAX package.

`mamba_decode` takes one token and writes the new ``ssm`` and ``conv``
states into the cache tensors it was given (`copy_`), where the JAX
package returns new ones: the model's decode hands it views of the
stacked cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import matmul
from repro_torch.models.params import ParamSpec, TensorSpec

__all__ = ["mamba_specs", "mamba_forward", "mamba_decode", "mamba_state_spec",
           "CHUNK"]

CHUNK = 64


def _dims(cfg: ModelConfig) -> tuple:
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, dt_rank = _dims(cfg)
    n = cfg.mamba_d_state
    return {
        "in_proj": ParamSpec((d, 2 * d_inner), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.mamba_d_conv, d_inner), ("conv", "mlp"),
                            scale=0.5),
        "conv_b": ParamSpec((d_inner,), ("mlp",), init="zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * n), ("mlp", None)),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "mlp")),
        "dt_bias": ParamSpec((d_inner,), ("mlp",), init="zeros"),
        "a_log": ParamSpec((d_inner, n), ("mlp", "state"), init="ones"),
        "d_skip": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def mamba_state_spec(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype) -> dict:
    d_inner, _ = _dims(cfg)
    return {
        "ssm": TensorSpec((batch, d_inner, cfg.mamba_d_state),
                          torch.float32),
        "conv": TensorSpec((batch, cfg.mamba_d_conv - 1, d_inner), dtype),
    }


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, prev=None) -> tuple:
    """Depthwise causal conv along seq, x (B, L, C) and conv_w (K, C), with
    the K - 1 rows before x from `prev` (zeros without).  Returns (out, the
    last K - 1 rows of the padded input: the next call's `prev`).  The
    taps are summed in the JAX package's order."""
    k = conv_w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    length = x.shape[1]
    out = xp[:, :length] * conv_w[0]
    for i in range(1, k):
        out = out + xp[:, i: i + length] * conv_w[i]
    return out + conv_b, xp[:, -(k - 1):]


def _ssm_params(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """dt (f32, ..., d_inner), B and C (f32, ..., d_state) of the conv's
    output x, and A = -exp(a_log) (f32, d_inner x d_state)."""
    _, dt_rank = _dims(cfg)
    n = cfg.mamba_d_state
    proj = matmul(x, params["x_proj"])
    dt = F.softplus(matmul(proj[..., :dt_rank], params["dt_proj"])
                    + params["dt_bias"]).to(torch.float32)
    bmat = proj[..., dt_rank: dt_rank + n].to(torch.float32)
    cmat = proj[..., dt_rank + n:].to(torch.float32)
    a = -torch.exp(params["a_log"].to(torch.float32))
    return dt, bmat, cmat, a


def _finish(params: dict, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """y + D x, gated by silu(z), projected out."""
    y = y + x.to(torch.float32) * params["d_skip"].to(torch.float32)
    return matmul(y.to(dtype) * F.silu(z), params["out_proj"])


def _chunk_states(inp: torch.Tensor, decay: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """The states h_t = decay_t h_{t-1} + inp_t of one chunk, (c, B, d, N),
    from the state `h` before it: one fused multiply-add a step, written
    into one buffer, or stacked where autograd records (`addcmul(out=)`
    cannot be differentiated).  `launch/dryrun.py` swaps in a shape-only
    stand-in for this loop while it counts on `meta`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (inp, decay, h)):
        steps = []
        for t in range(decay.shape[0]):
            h = torch.addcmul(inp[t], decay[t], h)
            steps.append(h)
        return torch.stack(steps)
    hs = torch.empty_like(decay)
    for t in range(decay.shape[0]):
        h = torch.addcmul(inp[t], decay[t], h, out=hs[t])
    return hs


def mamba_forward(params: dict, x_in: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x_in (B, L, D) -> (B, L, D): the chunked selective scan from a zero
    state."""
    b, length, _ = x_in.shape
    d_inner, _ = _dims(cfg)
    chunk = min(CHUNK, length)
    if length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"{chunk}")
    x, z = matmul(x_in, params["in_proj"]).chunk(2, dim=-1)
    x, _ = _causal_conv(x, params["conv_w"], params["conv_b"])
    x = F.silu(x)
    dt, bmat, cmat, a = _ssm_params(params, x, cfg)

    # the scan inputs' storage type (the JAX package's `mamba_lowp_scan`);
    # the recurrence's math is f32
    sdt = torch.bfloat16 if cfg.mamba_lowp_scan else torch.float32

    def stored(t):
        return t.to(sdt).to(torch.float32)

    xs, dts, bs, cs = stored(x), stored(dt), stored(bmat), stored(cmat)
    h = torch.zeros((b, d_inner, cfg.mamba_d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for lo in range(0, length, chunk):
        dtc = dts[:, lo: lo + chunk].transpose(0, 1)           # (c, B, d)
        decay = torch.exp(dtc[..., None] * a)                  # (c, B, d, N)
        inp = (dtc * xs[:, lo: lo + chunk].transpose(0, 1))[..., None] * \
            bs[:, lo: lo + chunk].transpose(0, 1)[:, :, None, :]
        hs = _chunk_states(inp, decay, h)
        h = hs[-1]
        ys.append(torch.einsum("cbdn,bcn->bcd", hs, cs[:, lo: lo + chunk]))
    y = torch.cat(ys, dim=1)
    return _finish(params, y, x, z, x_in.dtype)


def mamba_decode(params: dict, x_in: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> tuple:
    """One token, x_in (B, 1, D), against `state` {ssm, conv}.  Returns
    (out (B, 1, D), state): the new states are written into the state's
    tensors in place."""
    x, z = matmul(x_in, params["in_proj"]).chunk(2, dim=-1)
    x, conv_state = _causal_conv(x, params["conv_w"], params["conv_b"],
                                 prev=state["conv"])
    x = F.silu(x)[:, 0]                                        # (B, d)
    dt, bvec, cvec, a = _ssm_params(params, x, cfg)
    decay = torch.exp(dt[:, :, None] * a)
    h = decay * state["ssm"] + \
        (dt * x.to(torch.float32))[:, :, None] * bvec[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cvec)
    out = _finish(params, y, x, z[:, 0], x_in.dtype)[:, None, :]
    state["ssm"].copy_(h)
    state["conv"].copy_(conv_state)
    return out, state
