"""The port's MLA attention (DeepSeek-V2) against the JAX package's, on the
CPU.

One layer of reduced deepseek-v2-lite-16b (16 heads cut to 4, q and k of
head dim 32 + 16 = 48, v of 32, a latent of 64) on the JAX package's
`init_params` draws: `attn_forward` (the flash entry with v narrower than
q and k) and its latent cache, then 4 absorbed-weight `attn_decode` steps
over a latent cache, each to 1e-4 (f32 products in other orders over a
48-wide head).  `ops.attention_bshd` with Dv != D against the JAX model's
`_flash_attention` to 1e-5, as `tests/test_torch_flash_attention.py` holds
the D = Dv case.  Within the port, the prefill attention equals the
absorbed decode token by token to 1e-4 of its largest output (the
check `chip_smoke.py` makes layer by layer at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import attention as jattn
from repro.models import init_params as jax_init_params
from repro.models.attention import _flash_attention
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.models import attention, params_from_numpy

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def layer():
    jcfg = jax_reduce(jax_get_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    jparams = jax_init_params(jattn.attn_specs(jcfg), jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    x = np.random.default_rng(0).normal(size=(2, 16, 128)).astype(
        np.float32)
    return jcfg, cfg, jparams, params, x


def test_mla_specs_and_cache_specs(layer):
    jcfg, cfg, jparams, params, _ = layer
    assert set(params) == set(jparams) == {
        "wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo", "kv_norm"}
    for key, spec in attention.attn_specs(cfg).items():
        if key != "kv_norm":
            assert spec.shape == jparams[key].shape
    want = jattn.init_kv_cache_spec(jcfg, 2, 24, jnp.float32)
    got = attention.init_kv_cache_spec(cfg, 2, 24, torch.bfloat16)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()} == {
            "c_kv": (2, 24, 64), "k_rope": (2, 24, 16)}
    assert got["c_kv"].dtype == torch.bfloat16


def test_mla_forward_matches_jax(layer):
    jcfg, cfg, jparams, params, x = layer
    want, jcache = jattn.attn_forward(jparams, jnp.asarray(x), jcfg,
                                      return_cache=True)
    got, cache = attention.attn_forward(params, torch.from_numpy(x), cfg,
                                        return_cache=True)
    assert got.shape == (2, 16, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for leaf in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), **TOL)


def test_mla_decode_matches_jax(layer):
    jcfg, cfg, jparams, params, x = layer
    jcache = {"c_kv": jnp.zeros((2, 8, 64)), "k_rope": jnp.zeros((2, 8, 16))}
    cache = {"c_kv": torch.zeros((2, 8, 64)), "k_rope": torch.zeros(
        (2, 8, 16))}
    for t in range(4):
        step = x[:, t: t + 1]
        want, jcache = jattn.attn_decode(jparams, jnp.asarray(step), jcache,
                                         jnp.asarray(t, jnp.int32), jcfg)
        got, cache = attention.attn_decode(params, torch.from_numpy(step),
                                           cache, torch.tensor(t), cfg)
        assert got.shape == (2, 1, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for leaf in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), **TOL)
    assert not bool(cache["c_kv"][:, 4:].any())


def test_mla_prefill_equals_absorbed_decode(layer):
    _, cfg, _, params, x = layer
    xt = torch.from_numpy(x)
    y_f, _ = attention.attn_forward(params, xt, cfg)
    cache = {"c_kv": torch.zeros((2, 16, 64)),
             "k_rope": torch.zeros((2, 16, 16))}
    y_d = torch.cat([attention.attn_decode(params, xt[:, t: t + 1], cache,
                                           torch.tensor(t), cfg)[0]
                     for t in range(16)], dim=1)
    assert float((y_f - y_d).abs().max() / y_f.abs().max()) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,causal", [(1, True), (2, True), (4, False)])
def test_attention_bshd_with_a_narrower_v_matches_jax(g, causal, dtype):
    """q, k (2, 64, H, 48) and v (2, 64, Hk, 32), Hk = 4 / g."""
    rng = np.random.default_rng(g)
    hk = 4 // g
    q, k = (rng.normal(size=(2, 64, n, 48)).astype(np.float32)
            for n in (4, hk))
    v = rng.normal(size=(2, 64, hk, 32)).astype(np.float32)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    want = _flash_attention(*jx, causal=causal, scale=48 ** -0.5)
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    got = ops.attention_bshd(*tx, scale=48 ** -0.5, causal=causal)
    assert got.shape == (2, 64, 4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    flat = ops.flash_attention(*(t[:, :, 0] for t in tx), scale=0.1,
                               causal=causal)
    assert flat.shape == (2, 64, 32)
