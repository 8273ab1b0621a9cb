"""The port's model stack against the JAX package's, on the CPU.

Weights are the JAX package's own `init_params` draws, carried across with
`params_from_numpy(jax.tree.map(np.asarray, params))`, so both packages
run the same function on the same numbers.  Configs are the JAX package's
`reduce_for_smoke` cuts (4 layers, d_model 128, 4 heads of 32 over 2 KV
heads) of the attention-block archs the port runs: yi-9b (GQA), olmo-1b
(non-parametric layernorm, tied embeddings), qwen3-32b (qk-norm),
qwen1.5-110b (qkv-bias), qwen2-moe-a2.7b (MoE with shared experts, 8
experts at this size) and deepseek-v2-lite-16b (MLA, MoE and a leading
dense layer).

Tolerances: f32 logits to 1e-3 (absolute and relative).  The random
weights let the hidden states grow to about 100 over four layers, so f32
rounding in the two packages' different summation orders reaches a few
1e-4 on logits of order 1 to 5; the JAX package's own decode-against-
forward check uses 2e-3.  bf16 runs are held to 5e-2: the two packages
round bf16 products at other places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import make_cache_specs as jax_cache_specs
from repro.models.transformer import block_forward as jax_block_forward
from repro_torch.configs import SHAPES, ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.models import (
    decode_step,
    empty_cache,
    forward,
    init_params,
    make_batch_specs,
    make_cache_specs,
    param_specs,
    params_from_numpy,
    spec_bytes,
)
from repro_torch.models.model import layer_slice
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import block_forward

PORTED = ["yi-9b", "olmo-1b", "qwen3-32b", "qwen1.5-110b", "qwen2-moe-a2.7b",
          "deepseek-v2-lite-16b"]
NOT_PORTED = [a for a in ARCH_IDS if a not in PORTED]
TOL = dict(rtol=1e-3, atol=1e-3)


def _setup(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params, port params) at the smoke size."""
    jcfg = jax_reduce(jax_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    if dtype != "float32":
        jcfg = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    jparams = jax_init_params(jax_param_specs(jcfg), jax.random.key(0),
                              jnp.dtype(dtype))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("reduced", [True, False])
def test_param_specs_match_the_jax_tree(arch, reduced):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jax_reduce(jcfg), reduce_for_smoke(cfg)
    want = {"/".join(str(k.key) for k in path): (leaf.shape, leaf.init,
                                                 leaf.scale)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jax_param_specs(jcfg),
                is_leaf=lambda n: hasattr(n, "init"))}
    got = {path: (leaf.shape, leaf.init, leaf.scale)
           for path, leaf in spec_leaves(param_specs(cfg))}
    assert got == want
    assert cfg.param_count() == jcfg.param_count()


def test_yi_9b_size():
    """Embeddings and head 2 x 64000 x 4096, 48 layers of 173,023,232
    (attention 37,748,736, MLP 135,266,304, norms 8,192), final norm."""
    cfg = get_config("yi-9b")
    assert cfg.param_count() == 2 * 64000 * 4096 + 48 * 173_023_232 + 4096
    assert spec_bytes(param_specs(cfg)) == 2 * 8_829_407_232


def test_batch_and_cache_specs_match_jax():
    jcfg = jax_reduce(jax_get_config("yi-9b"))
    cfg = reduce_for_smoke(get_config("yi-9b"))
    batch = make_batch_specs(cfg, SHAPES["prefill_32k"])
    assert batch == {"tokens": ((32, 32768), torch.int32)}
    want = jax_cache_specs(jcfg, 2, 48)
    got = make_cache_specs(cfg, 2, 48)
    for leaf in ("k", "v"):
        spec = got["groups"]["pos00"][leaf]
        assert spec.shape == want["groups"]["pos00"][leaf].shape
        assert spec.dtype == torch.float32
    assert got["index"].shape == want["index"].shape == ()
    with pytest.raises(NotImplementedError, match="audio"):
        make_batch_specs(reduce_for_smoke(get_config("hubert-xlarge")),
                         SHAPES["train_4k"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "yi-9b"])
def test_cache_spec_trees_match_jax(arch):
    """Every cache leaf, MLA's latents and the leading dense layer's
    ungrouped entry included, with JAX's shape; yi-9b with `cluster_kv`
    gets the clustered leaves."""
    jcfg = jax_reduce(jax_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    if arch == "yi-9b":
        jcfg = dataclasses.replace(jcfg, cluster_kv=True,
                                   cluster_kv_clusters=16)
        cfg = dataclasses.replace(cfg, cluster_kv=True,
                                  cluster_kv_clusters=16)
    want = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jax_cache_specs(jcfg, 2, 48))}
    got = {path: leaf.shape
           for path, leaf in spec_leaves(make_cache_specs(cfg, 2, 48))}
    assert got == want


def test_init_params_follows_the_law():
    """normal * 1/sqrt(fan_in) (fan_in the second-to-last dim) or the
    spec's own scale; ones and zeros as the spec says.  Each normal leaf
    of at least 2,000 values has its sample std within 5% of the law's
    and its mean within 5 standard errors of 0."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-110b")),
                              qk_norm=True)
    specs = param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    leaves = dict(spec_leaves(params))
    checked = 0
    for path, spec in spec_leaves(specs):
        t = leaves[path]
        assert t.shape == spec.shape and t.dtype == torch.float32
        if spec.init in ("ones", "zeros"):
            assert bool((t == (1.0 if spec.init == "ones" else 0.0)).all())
            continue
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale > 0 else fan_in ** -0.5
        if t.numel() >= 2000:
            assert abs(float(t.std()) / std - 1.0) < 0.05, path
            assert abs(float(t.mean())) < 5 * std / t.numel() ** 0.5, path
            checked += 1
    assert checked >= 6
    again = init_params(specs, torch.Generator().manual_seed(0),
                        torch.bfloat16, "cpu")
    assert again["embed"]["tokens"].dtype == torch.bfloat16
    torch.testing.assert_close(again["embed"]["tokens"],
                               params["embed"]["tokens"].to(torch.bfloat16))


def test_params_from_numpy_keeps_keys_and_bf16():
    jcfg, cfg, jparams, params = _setup("yi-9b", "bfloat16")
    flat = dict(spec_leaves(params))
    jflat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
             jax.tree_util.tree_leaves_with_path(jparams)}
    assert set(flat) == set(jflat)
    wq = flat["groups/pos00/attn/wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (4, 128, 4, 32)
    np.testing.assert_array_equal(_f32(wq),
                                  _f32(jflat["groups/pos00/attn/wq"]))


@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_decode_match_jax(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    toks = _tokens(cfg)
    want, want_aux, _ = jax_forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks)},
                                    remat="none")
    got, aux, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert (float(aux) == 0.0) == (not cfg.num_experts)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jax_cache_specs(jcfg, 2, 16))
    cache = empty_cache(cfg, 2, 16, "cpu")
    for t in range(4):
        jl, jcache = jax_decode_step(jparams, jcfg, jnp.asarray(toks[:, t]),
                                     jcache)
        tl, cache = decode_step(params, cfg, torch.from_numpy(toks[:, t]),
                                cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(cache["index"]) == int(jcache["index"]) == 4
    leaf = "c_kv" if cfg.use_mla else "k"
    np.testing.assert_allclose(
        cache["groups"]["pos00"][leaf].numpy(),
        np.asarray(jcache["groups"]["pos00"][leaf]), **TOL)
    for l in range(cfg.first_k_dense):
        np.testing.assert_allclose(
            cache[f"dense{l}"][leaf].numpy(),
            np.asarray(jcache[f"dense{l}"][leaf]), **TOL)


def test_forward_matches_jax_in_bf16():
    """bf16 weights and activations throughout, the card's types.  The two
    packages round bf16 at other places, so the port is held to JAX's own
    bf16 rounding: its logits lie no farther from JAX's bf16 logits than
    those lie from the f32 forward on the same (bf16-valued) weights, in
    max and in mean."""
    jcfg, cfg, jparams, params = _setup("yi-9b", "bfloat16")
    toks = _tokens(cfg)
    want, _, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             remat="none")
    got, _, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    exact, _, _ = forward(
        jax.tree.map(lambda t: t.to(torch.float32), params),
        dataclasses.replace(cfg, dtype="float32"),
        {"tokens": torch.from_numpy(toks)})
    port_err = np.abs(_f32(got) - _f32(want))
    jax_err = np.abs(_f32(want) - exact.numpy())
    assert port_err.max() <= jax_err.max()
    assert port_err.mean() <= jax_err.mean()


@pytest.mark.parametrize("act_dtype,param_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_block_result_types_follow_jax(act_dtype, param_dtype):
    """One block gives the JAX code's result type for f32, bf16 and bf16
    activations over f32 weights (jnp promotes those to f32)."""
    jcfg, cfg, jparams, params = _setup("qwen1.5-110b", param_dtype)
    jlayer = jax.tree.map(lambda a: a[0], jparams["groups"]["pos00"])
    layer = layer_slice(params["groups"]["pos00"], 0)
    x = np.random.default_rng(5).normal(size=(2, 16, 128)).astype(np.float32)
    jx = jnp.asarray(x, act_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, act_dtype))
    want, _, _ = jax_block_forward(jlayer, jx, jcfg, "attn", False,
                                   positions=jnp.arange(16)[None])
    got, _, _ = block_forward(layer, tx, cfg, "attn", False)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    ref = _f32(want)
    tol = 1e-3 if act_dtype == param_dtype == "float32" else 5e-2
    assert np.abs(_f32(got) - ref).max() <= tol * np.abs(ref).max()


def test_decode_matches_forward():
    """The JAX package's `test_decode_matches_forward`, on the port for
    yi-9b: sequential decode reproduces the forward logits (2e-3, its
    tolerance)."""
    cfg = reduce_for_smoke(get_config("yi-9b"))
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=0).astype(np.int64))
    logits_f, _, _ = forward(params, cfg, {"tokens": toks})
    cache = empty_cache(cfg, 2, 16, "cpu")
    outs = []
    for t in range(16):
        lg, cache = decode_step(params, cfg, toks[:, t], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               logits_f.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unsupported_families_raise(arch):
    cfg = reduce_for_smoke(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        param_specs(cfg)


def test_unsupported_options_raise():
    cfg = reduce_for_smoke(get_config("yi-9b"))
    params = init_params(param_specs(cfg), torch.Generator(), torch.float32,
                         "cpu")
    with pytest.raises(NotImplementedError, match="vlm prefix"):
        forward(params, dataclasses.replace(cfg, prefix_len=8),
                {"tokens": torch.zeros((1, 16), dtype=torch.int64)})
    with pytest.raises(ValueError, match="multiple of 1024"):
        forward(params, cfg,
                {"tokens": torch.zeros((1, 1500), dtype=torch.int64)})
