"""RWKV-6 "Finch" block: data-dependent-decay linear attention.

The counterpart of the JAX package's `models/rwkv6.py`, for inference.
Time mixing follows the RWKV-6 recurrence with per-channel
data-dependent decay w_t and bonus u:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

`rwkv_time_forward` computes the JAX package's *chunked* form, in plain
PyTorch on the device (no TPU kernel exists for it): within a chunk of
`CHUNK` steps the decays telescope, so the intra-chunk interactions are an
(L, L) masked product with per-channel factors exp(a_i) exp(-b_j) (the
log-decay clamped to `MIN_LOG_W`, so exp(-b) stays inside f32), all f32.
Every chunk's intra-chunk part is formed at once; only the state carried
between chunks, S <- exp(total) S + K2^T V, is a loop, three products a
chunk.  The decode functions take one token and write the new ``wkv``,
``x_prev_time`` and ``x_prev_chan`` into the cache tensors they were given
(`copy_`), where the JAX package returns a merged dict.

Channel mixing is the RWKV squared-ReLU FFN with token shift.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import einsum, matmul
from repro_torch.models.params import ParamSpec, TensorSpec

__all__ = [
    "rwkv_time_specs",
    "rwkv_channel_specs",
    "rwkv_time_forward",
    "rwkv_channel_forward",
    "rwkv_time_decode",
    "rwkv_channel_decode",
    "rwkv_state_spec",
    "CHUNK",
]

CHUNK = 16
LORA_RANK = 32
MIN_LOG_W = -2.5  # per-step decay floor (the JAX package's stability clamp)


def _heads(cfg: ModelConfig) -> tuple:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def rwkv_time_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, hd = _heads(cfg)
    r = LORA_RANK
    return {
        "mu_x": ParamSpec((d,), ("embed",), init="zeros"),
        "mu": ParamSpec((5, d), (None, "embed"), init="zeros"),  # r,k,v,w,g
        "lora_a": ParamSpec((5, d, r), (None, "embed", None), scale=0.02),
        "lora_b": ParamSpec((5, r, d), (None, None, "embed"), scale=0.02),
        "w0": ParamSpec((d,), ("embed",), init="zeros"),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "u": ParamSpec((h, hd), ("heads", None), init="zeros"),
        "ln_scale": ParamSpec((d,), ("embed",), init="ones"),
        "wo": ParamSpec((d, d), ("heads", "embed")),
    }


def rwkv_channel_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "mu_k": ParamSpec((d,), ("embed",), init="zeros"),
        "mu_r": ParamSpec((d,), ("embed",), init="zeros"),
        "wk": ParamSpec((d, cfg.d_ff), ("embed", "mlp")),
        "wv": ParamSpec((cfg.d_ff, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", None)),
    }


def rwkv_state_spec(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype) -> dict:
    h, hd = _heads(cfg)
    return {
        "wkv": TensorSpec((batch, h, hd, hd), torch.float32),
        "x_prev_time": TensorSpec((batch, cfg.d_model), dtype),
        "x_prev_chan": TensorSpec((batch, cfg.d_model), dtype),
    }


def _token_shift(x: torch.Tensor, x_prev=None) -> torch.Tensor:
    """x_{t-1} along seq; the first position gets `x_prev` (or zeros)."""
    if x.shape[1] == 1:
        return torch.zeros_like(x) if x_prev is None else x_prev[:, None, :]
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x_prev is not None:
        shifted[:, 0] = x_prev
    return shifted


def _ddlerp(params: dict, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp (RWKV-6 token shift): one mix per {r,k,v,w,g},
    (B, S, 5, D)."""
    dx = xs - x
    base = x + dx * params["mu_x"]
    lora = einsum("bsd,cdr->bscr", torch.tanh(base), params["lora_a"])
    delta = einsum("bscr,crd->bscd", lora, params["lora_b"])
    mix = params["mu"][None, None] + delta
    return x[:, :, None, :] + dx[:, :, None, :] * mix


def _time_projections(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      x_prev=None) -> tuple:
    """r, k, v (B, S, H, hd), g (B, S, D) and the clamped log-decay logw
    (B, S, H, hd) f32."""
    h, hd = _heads(cfg)
    b, s, _ = x.shape
    mixed = _ddlerp(params, x, _token_shift(x, x_prev))
    xr, xk, xv, xw, xg = mixed.unbind(dim=2)
    r = matmul(xr, params["wr"]).reshape(b, s, h, hd)
    k = matmul(xk, params["wk"]).reshape(b, s, h, hd)
    v = matmul(xv, params["wv"]).reshape(b, s, h, hd)
    g = matmul(xg, params["wg"])
    # data-dependent decay: w0 + a rank-LORA_RANK lora over xw
    wlo = einsum("bsd,dr->bsr", torch.tanh(xw), params["lora_a"][3])
    wdd = einsum("bsr,rd->bsd", wlo, params["lora_b"][3])
    logw = -torch.exp(params["w0"][None, None] + wdd)
    logw = logw.clamp(MIN_LOG_W, -1e-4).reshape(b, s, h, hd)
    return r, k, v, g, logw.to(torch.float32)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, hd: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm on the wkv output (RWKV's GroupNorm)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, h, hd).to(torch.float32)
    mu = xh.mean(dim=-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, d) * scale).to(x.dtype)


def _time_output(params: dict, y: torch.Tensor, g: torch.Tensor,
                 cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """The wkv output y (B, S, D) f32: group norm, gated by silu(g),
    projected out."""
    h, hd = _heads(cfg)
    y = _group_norm(y.to(dtype), params["ln_scale"], h, hd)
    return matmul(y * F.silu(g), params["wo"])


def _inter_chunk(r_dec: torch.Tensor, decay: torch.Tensor,
                 kv: torch.Tensor) -> torch.Tensor:
    """Each chunk's decayed receptances r_dec (B, nc, L, H, hd) against the
    state carried into it, S <- decay S + kv from a zero state: one loop
    step a chunk.  `launch/dryrun.py` swaps in a shape-only stand-in for
    this loop while it counts on `meta`."""
    b, nc, _, h, hd = r_dec.shape
    state = r_dec.new_zeros((b, h, hd, hd))
    inter = torch.empty_like(r_dec)
    for c in range(nc):
        inter[:, c] = torch.einsum("bihd,bhde->bihe", r_dec[:, c], state)
        state = decay[:, c] * state + kv[:, c]
    return inter


def rwkv_time_forward(params: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """(B, S, D) -> (B, S, D); the chunked wkv linear attention from a zero
    state."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    chunk = min(CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of {chunk}")
    nc = s // chunk
    r, k, v, g, logw = _time_projections(params, x, cfg)
    u = params["u"].to(torch.float32)
    f32 = torch.float32
    rc, kc, vc = (t.to(f32).reshape(b, nc, chunk, h, hd) for t in (r, k, v))
    wc = logw.reshape(b, nc, chunk, h, hd)

    cum = torch.cumsum(wc, dim=2)            # b_j = sum_{l <= j} logw_l
    r_dec = rc * torch.exp(cum - wc)         # a_i = sum_{l < i}: exponents <= 0
    k_dec = kc * torch.exp(-cum)             # grows, bounded by the clamp
    scores = torch.einsum("bcihd,bcjhd->bchij", r_dec, k_dec)
    il = torch.arange(chunk, device=x.device)
    scores = torch.where(il[:, None] > il[None, :], scores, 0.0)
    bonus = torch.einsum("bcihd,bcihd->bcih", rc * u, kc)
    y = torch.einsum("bchij,bcjhd->bcihd", scores, vc)
    y = y + bonus[..., None] * vc
    total = cum[:, :, -1]                    # (B, nc, H, hd)
    k2 = kc * torch.exp(total[:, :, None] - cum)
    kv = torch.einsum("bcjhd,bcjhe->bchde", k2, vc)
    decay = torch.exp(total)[..., None]

    y = (y + _inter_chunk(r_dec, decay, kv)).reshape(b, s, d)
    return _time_output(params, y, g, cfg, x.dtype)


def rwkv_time_decode(params: dict, x: torch.Tensor, state: dict,
                     cfg: ModelConfig) -> tuple:
    """One wkv step, x (B, 1, D).  Returns (out, state): ``wkv`` and
    ``x_prev_time`` are written in place."""
    b, _, d = x.shape
    r, k, v, g, logw = _time_projections(params, x, cfg,
                                         x_prev=state["x_prev_time"])
    u = params["u"].to(torch.float32)
    rf, kf, vf = (t.to(torch.float32)[:, 0] for t in (r, k, v))
    wkv = state["wkv"]
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    y = torch.einsum("bhd,bhde->bhe", rf, wkv + u[None, :, :, None] * kv)
    new = torch.exp(logw[:, 0])[..., None] * wkv + kv
    out = _time_output(params, y.reshape(b, 1, d), g, cfg, x.dtype)
    wkv.copy_(new)
    state["x_prev_time"].copy_(x[:, 0])
    return out, state


def rwkv_channel_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                         x_prev=None) -> torch.Tensor:
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * params["mu_k"]
    xr = x + (xs - x) * params["mu_r"]
    hidden = torch.square(torch.relu(matmul(xk, params["wk"])))
    out = matmul(hidden, params["wv"])
    return torch.sigmoid(matmul(xr, params["wr"])) * out


def rwkv_channel_decode(params: dict, x: torch.Tensor, state: dict,
                        cfg: ModelConfig) -> tuple:
    """One token; ``x_prev_chan`` is written in place."""
    y = rwkv_channel_forward(params, x, cfg, x_prev=state["x_prev_chan"])
    state["x_prev_chan"].copy_(x[:, 0])
    return y, state
