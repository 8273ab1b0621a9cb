"""The vlm prefix and the audio and vlm inputs against the JAX package, on
the CPU.

The prefix mask: `attention_bshd_ref` (the flash kernel's plain version)
with `prefix_len` against the JAX package's `_flash_attention` over
prefixes of 0, 1, one below and one above a chunk edge, and the whole
sequence, on numpy-seeded f32 inputs, to 2e-5 (f32 sums in other orders
over 64 keys).  The inputs: `make_batch_specs`, `num_text_tokens`,
`embed_specs` and the first hidden states of reduced paligemma-3b and
hubert-xlarge against the JAX package's, and paligemma's `prefill` of
patches and text then decode steps against the JAX package's, with its
weights carried across, at the model tolerance of
`tests/test_torch_models.py` (1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models.attention import _flash_attention
from repro.models.model import _embed_inputs as jax_embed_inputs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import make_batch_specs as jax_batch_specs
from repro.models.model import num_text_tokens as jax_num_text_tokens
from repro.serving.prefill import prefill as jax_prefill
from repro_torch.configs import SHAPES, get_config, reduce_for_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import (decode_step, make_batch_specs,
                                num_text_tokens, params_from_numpy)
from repro_torch.models.model import _embed_inputs
from repro_torch.serving.prefill import prefill

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's tensors here are small, so its ops run on one thread:
    when the suite's workers share the cores, OpenMP teams spun up for
    each small op stall one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(arch):
    jcfg = jax_reduce(jax_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    jparams = jax_init_params(jax_param_specs(jcfg), jax.random.key(0),
                              jnp.float32)
    return jcfg, cfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("prefix", [0, 1, 15, 17, 64])
@pytest.mark.parametrize("h,hk", [(4, 4), (4, 1)])
def test_prefix_mask_matches_jax_flash_attention(prefix, h, hk):
    """S = 64 over key chunks of 16: prefixes of 0, 1, one below and one
    above the first chunk edge, and all of S; g = 1 and paligemma's 4
    query heads over 1 KV head."""
    rng = np.random.default_rng(prefix + 10 * h + hk)
    q = _normal(rng, (2, 64, h, 32))
    k, v = _normal(rng, (2, 64, hk, 32)), _normal(rng, (2, 64, hk, 32))
    want = _flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, prefix_len=prefix, chunk=16,
                            scale=32 ** -0.5)
    got = ref.attention_bshd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale=32 ** -0.5,
                                 causal=True, prefix_len=prefix, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    before = ops.launch_counts()["flash_attention"]
    via_ops = ops.attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale=32 ** -0.5,
                                 causal=True, prefix_len=prefix)
    assert ops.launch_counts()["flash_attention"] == before
    np.testing.assert_allclose(via_ops.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("prefix", [0, 5, 40])
def test_prefix_mask_of_both_entries_is_exact_softmax(prefix):
    """The (BH, S, D) oracle and the chunked scan with a prefix against
    softmax over the JAX mask written out, a ragged S of 40; the prefix
    does nothing without causality."""
    rng = np.random.default_rng(prefix)
    q, k, v = (torch.from_numpy(_normal(rng, (3, 40, 16))) for _ in range(3))
    pos = torch.arange(40)
    keep = (pos[:, None] >= pos[None, :]) | \
        ((pos[:, None] < prefix) & (pos[None, :] < prefix))
    s = torch.where(keep, (q * 0.25) @ k.transpose(1, 2), -1.0e30)
    want = torch.softmax(s, dim=-1) @ v
    got = ref.flash_attention_ref(q, k, v, scale=0.25, prefix_len=prefix)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    bshd = ref.attention_bshd_ref(q[:, :, None].transpose(0, 2),
                                  k[:, :, None].transpose(0, 2),
                                  v[:, :, None].transpose(0, 2), scale=0.25,
                                  causal=True, prefix_len=prefix, chunk=16)
    torch.testing.assert_close(bshd[0].transpose(0, 1), want, **ATTN_TOL)
    free = ref.attention_bshd_ref(q[None], k[None], v[None], scale=0.25,
                                  causal=False, prefix_len=prefix)
    torch.testing.assert_close(free, ref.attention_bshd_ref(
        q[None], k[None], v[None], scale=0.25, causal=False))


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("reduced", [True, False])
def test_batch_specs_and_text_tokens_match_jax(arch, shape, reduced):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jax_reduce(jcfg), reduce_for_smoke(cfg)
    want = jax_batch_specs(jcfg, JAX_SHAPES[shape])
    got = make_batch_specs(cfg, SHAPES[shape])
    assert set(got) == set(want)
    for key, spec in got.items():
        assert spec.shape == want[key].shape
        assert str(spec.dtype).split(".")[-1] == str(want[key].dtype)
    assert num_text_tokens(cfg, SHAPES[shape]) == \
        jax_num_text_tokens(jcfg, JAX_SHAPES[shape])


def test_short_vlm_sequence_takes_half_as_patches():
    """The JAX package's ``min(prefix_len, s // 2) or s // 2``: a prefix
    longer than half the sequence is cut to half."""
    cfg = get_config("paligemma-3b")
    short = dataclasses.replace(SHAPES["train_4k"], seq_len=300)
    assert make_batch_specs(cfg, short)["patches"].shape[1] == 150
    assert num_text_tokens(cfg, short) == 256 * 150
    assert make_batch_specs(dataclasses.replace(cfg, prefix_len=0), short)[
        "patches"].shape[1] == 150


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_embed_inputs_match_jax(arch):
    """The first hidden states: hubert's frames through `frontend_proj`,
    paligemma's patches projected ahead of its text embeddings."""
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(3)
    if cfg.family == "audio":
        batch = {"embeddings": _normal(rng, (2, 16, cfg.frontend_dim))}
    else:
        batch = {"patches": _normal(rng, (2, 8, cfg.frontend_dim)),
                 "tokens": rng.integers(0, cfg.vocab_size, (2, 8))}
    want = jax_embed_inputs(jparams, jcfg,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    got = _embed_inputs(params, cfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_vlm_prefill_then_decode_matches_jax():
    """paligemma's `prefill` of 8 patches and 8 text tokens (its prefix of
    8 attended fully), then four decode steps: logits, the cache over
    patches and text, and ``index`` against the JAX package's."""
    jcfg, cfg, jparams, params = _model("paligemma-3b")
    rng = np.random.default_rng(4)
    patches = _normal(rng, (2, 8, cfg.frontend_dim))
    text = rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jcache = jax_prefill(jparams, jcfg, {"patches": jnp.asarray(patches),
                                             "tokens": jnp.asarray(text)},
                             max_seq=24)
    tl, cache = prefill(params, cfg, {"patches": torch.from_numpy(patches),
                                      "tokens": torch.from_numpy(text)},
                        max_seq=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(cache["index"]) == int(jcache["index"]) == 16
    for leaf in ("k", "v"):
        got = cache["groups"]["pos00"][leaf]
        assert got.shape == jcache["groups"]["pos00"][leaf].shape
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcache["groups"]["pos00"][leaf]), **TOL)
    cur = text[:, -1]
    for _ in range(4):
        jl, jcache = jax_decode_step(jparams, jcfg, jnp.asarray(cur), jcache)
        tl, cache = decode_step(params, cfg, torch.from_numpy(cur), cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cur = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert int(cache["index"]) == 20


def test_prefix_changes_the_prefill_logits():
    """The prefix is live in the model: the same weights and inputs with
    `prefix_len` 0 (plain causal) give other logits at the first patch,
    which sees the whole prefix only under the prefix mask."""
    from repro_torch.models import forward

    _, cfg, _, params = _model("paligemma-3b")
    rng = np.random.default_rng(5)
    batch = {"patches": torch.from_numpy(_normal(rng, (1, 8,
                                                       cfg.frontend_dim))),
             "tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                     (1, 8)))}
    with_prefix, _, _ = forward(params, cfg, batch)
    causal, _, _ = forward(params, dataclasses.replace(cfg, prefix_len=0),
                           batch)
    assert cfg.prefix_len == 8
    assert not torch.allclose(with_prefix[:, 0], causal[:, 0])
