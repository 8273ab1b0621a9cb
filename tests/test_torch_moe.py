"""The port's MoE FFN against the JAX package's, on the CPU.

`apply_moe` on the same f32 weights (the JAX package's `init_params`
draws, carried across) and the same inputs (numpy, from a seed): the
output to 1e-3 (f32 products and sums in other orders), the aux loss to
1e-6 (an f32 sum of 8 to 32 terms), and the same assignments kept and
dropped.  The kept set is a function of each token's top-k experts, so the
test holds the port's routing to the JAX package's top-k on its own
probabilities, then counts the drops both ways.  Cases: reduced qwen2-moe
and deepseek (shared experts), 20 experts padded to 32 (the padded ones
never routed), a capacity factor that drops tokens, both dispatch modes,
and two dispatch windows (`MOE_CHUNK_TOKENS` patched in both modules).
`kmeans_router_init` gives the JAX package's array bit for bit.  bf16
runs are held to the JAX package's own bf16 rounding, as
`tests/test_torch_models.py` holds the dense models.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models.model import forward as jax_forward
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import forward, params_from_numpy
from repro_torch.models import moe

CASES = {
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "20-experts": ("qwen2-moe-a2.7b", dict(num_experts=20, moe_top_k=4)),
    "dropping": ("qwen2-moe-a2.7b", dict(capacity_factor=0.3)),
}


def _configs(arch, overrides, dtype="float32"):
    over = dict(overrides, dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(jax_reduce(jax_get_config(arch)), **over),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **over))


@functools.lru_cache(maxsize=None)
def _moe_layer(arch, num_experts):
    """One MoE layer's weights, the JAX package's `init_params` draws of
    `moe_specs`, in both packages (f32)."""
    jcfg, _ = _configs(arch, {} if num_experts is None else
                       dict(num_experts=num_experts))
    jlayer = jax_init_params(jmoe.moe_specs(jcfg), jax.random.key(0))
    return jlayer, params_from_numpy(jax.tree.map(np.asarray, jlayer), "cpu")


def _setup(arch, overrides):
    jcfg, cfg = _configs(arch, overrides)
    return (jcfg, cfg) + _moe_layer(arch, overrides.get("num_experts"))


# one compile of the whole function instead of one per eager op
_jax_apply_moe = jax.jit(jmoe.apply_moe, static_argnums=2)


def _jax_top_ids(jlayer, x, cfg):
    """The JAX package's routing on its own weights: top-k of the masked
    softmax (`repro.models.moe._moe_tokens_global`'s first lines)."""
    e, ep = cfg.num_experts, jmoe.phys_experts(cfg.num_experts)
    logits = (jnp.asarray(x) @ jlayer["router"]).astype(jnp.float32)
    logits = jnp.where(jnp.arange(ep)[None] >= e, -1.0e30, logits)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                    cfg.moe_top_k)[1])


def _kept(top_ids, ep, cap):
    """Kept (token, expert) pairs: the stable sort by expert, rank < cap."""
    flat = top_ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    rank = np.arange(len(se)) - np.searchsorted(se, se)
    return {(int(order[j]) // top_ids.shape[1], int(se[j]))
            for j in np.nonzero(rank < cap)[0]}


@pytest.mark.parametrize("dispatch", ["global", "two_stage"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_jax(case, dispatch):
    arch, over = CASES[case]
    jcfg, cfg, jlayer, layer = _setup(arch, dict(over,
                                                 moe_dispatch=dispatch))
    x = np.random.default_rng(3).normal(size=(2, 48, 128)).astype(
        np.float32)
    jy, jaux = _jax_apply_moe(jlayer, jnp.asarray(x), jcfg)
    y, aux = moe.apply_moe(layer, torch.from_numpy(x), cfg)
    assert y.dtype == torch.float32 and y.shape == (2, 48, 128)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=1e-3)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)

    xf = torch.from_numpy(x.reshape(-1, 128))
    _, top_ids, weights, _ = moe.route(layer, xf, cfg)
    want_ids = _jax_top_ids(jlayer, x.reshape(-1, 128), cfg)
    np.testing.assert_array_equal(np.sort(top_ids.numpy(), 1),
                                  np.sort(want_ids, 1))
    assert int(top_ids.max()) < cfg.num_experts
    np.testing.assert_allclose(weights.sum(-1).numpy(), 1.0, rtol=1e-6)
    cap = moe._capacity(96, cfg, 128 if dispatch == "two_stage" else 256)
    ep = moe.phys_experts(cfg.num_experts)
    kept = _kept(top_ids.numpy(), ep, cap)
    assert kept == _kept(want_ids, ep, cap)
    if case == "dropping":
        assert len(kept) < 96 * cfg.moe_top_k
    if case == "20-experts":
        assert ep == 32 and layer["router"].shape == (128, 32)


@pytest.mark.parametrize("case", ["qwen2-moe", "deepseek"])
def test_two_dispatch_windows_match_jax(case, monkeypatch):
    """64 tokens in windows of 32: capacity per window, the aux loss the
    windows' mean, in both packages."""
    monkeypatch.setattr(jmoe, "MOE_CHUNK_TOKENS", 32)
    monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", 32)
    arch, over = CASES[case]
    jcfg, cfg, jlayer, layer = _setup(arch, dict(over, capacity_factor=0.5))
    x = np.random.default_rng(4).normal(size=(2, 32, 128)).astype(
        np.float32)
    jy, jaux = jmoe.apply_moe(jlayer, jnp.asarray(x), jcfg)
    y, aux = moe.apply_moe(layer, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    whole, _ = moe._moe_tokens(layer, torch.from_numpy(x.reshape(64, 128)),
                               cfg)
    assert not torch.allclose(y.reshape(64, 128) - moe.apply_mlp(
        layer["shared"], torch.from_numpy(x), cfg).reshape(64, 128), whole)


def test_apply_moe_is_deterministic():
    _, cfg, _, layer = _setup("deepseek-v2-lite-16b", {})
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 40, 128)).astype(np.float32))
    a, _ = moe.apply_moe(layer, x, cfg)
    b, _ = moe.apply_moe(layer, x, cfg)
    assert torch.equal(a, b)


def test_moe_specs_match_jax():
    for arch, over in CASES.values():
        jcfg = dataclasses.replace(jax_get_config(arch), **over)
        cfg = dataclasses.replace(get_config(arch), **over)
        want = jax.tree_util.tree_leaves_with_path(
            jmoe.moe_specs(jcfg), is_leaf=lambda n: hasattr(n, "init"))
        got = moe.moe_specs(cfg)
        for path, spec in want:
            node = got
            for k in path:
                node = node[k.key]
            assert (node.shape, node.scale, node.init) == \
                (spec.shape, spec.scale, spec.init), path
    assert moe.phys_experts(60) == 64 and moe.phys_experts(8) == 8


@pytest.mark.parametrize("seeder", ["fastkmeans++", "kmeans++"])
def test_kmeans_router_init_is_the_jax_array(seeder):
    rng = np.random.default_rng(6)
    router = (rng.normal(size=(16, 8)) * 0.02).astype(np.float32)
    emb = rng.normal(size=(300, 16)).astype(np.float32) + \
        np.repeat(rng.normal(size=(6, 16)) * 4, 50, axis=0)
    want = jmoe.kmeans_router_init(router, emb, seeder=seeder, seed=3)
    got = moe.kmeans_router_init(router, emb, seeder=seeder, seed=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_moe_forward_matches_jax_in_bf16(arch):
    """bf16 weights and activations: the port's logits lie no farther
    from the JAX package's bf16 logits than those lie from the f32
    forward on the same bf16-valued weights, in max and in mean (the two
    round bf16 at other places; JAX's scatter-add and the port's ordered
    combine both add a token's experts in bf16)."""
    jcfg, cfg = _configs(arch, {}, "bfloat16")
    jparams = jax_init_params(jax_param_specs(jcfg), jax.random.key(0),
                              jnp.bfloat16)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want, _, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             remat="none")
    got, _, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    exact, _, _ = forward(
        jax.tree.map(lambda t: t.to(torch.float32), params),
        dataclasses.replace(cfg, dtype="float32"),
        {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want.astype(jnp.float32))
    port_err = np.abs(got.to(torch.float32).numpy() - want)
    jax_err = np.abs(want - exact.numpy())
    assert port_err.max() <= jax_err.max()
    assert port_err.mean() <= jax_err.mean()
