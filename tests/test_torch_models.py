"""The port's model stack against the JAX package's, on the CPU.

Weights are the JAX package's own `init_params` draws, carried across with
`params_from_numpy(jax.tree.map(np.asarray, params))`, so both packages
run the same function on the same numbers.  Configs are the JAX package's
`reduce_for_smoke` cuts (4 layers, d_model 128, 4 heads of 32 over 2 KV
heads) of all ten archs: yi-9b (GQA), olmo-1b (non-parametric layernorm,
tied embeddings), qwen3-32b (qk-norm), qwen1.5-110b (qkv-bias),
qwen2-moe-a2.7b (MoE with shared experts, 8 experts at this size),
deepseek-v2-lite-16b (MLA, MoE and a leading dense layer), rwkv6-3b
(RWKV-6 blocks), jamba-1.5-large-398b (cut to one period of 8: Mamba,
attention at position 4, MoE every other layer), paligemma-3b (image
patches ahead of the text, a prefix of full attention, one KV head) and
hubert-xlarge (audio frames, bidirectional, no decode).

Tolerances: f32 logits to 1e-3 (absolute and relative).  The random
weights let the hidden states grow to about 100 over four layers, so f32
rounding in the two packages' different summation orders reaches a few
1e-4 on logits of order 1 to 5; the JAX package's own decode-against-
forward check uses 2e-3.  bf16 runs are held to 5e-2: the two packages
round bf16 products at other places.
"""

import dataclasses
import functools

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
from repro.models.transformer import block_decode as jax_block_decode
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
from repro_torch.models.transformer import (block_decode, block_forward,
                                            layer_layout)

PORTED = ["yi-9b", "olmo-1b", "qwen3-32b", "qwen1.5-110b", "qwen2-moe-a2.7b",
          "deepseek-v2-lite-16b", "rwkv6-3b", "jamba-1.5-large-398b",
          "paligemma-3b", "hubert-xlarge"]
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


# Reduced jamba has two periods of 8 layers; one period holds its whole
# layout (Mamba, attention at position 4, MoE every other layer) at half
# the cost of the JAX package's init and its op-by-op decode steps.
CUTS = {"jamba-1.5-large-398b": {"num_layers": 8}}


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params, port params) at the smoke size, once
    a module (no test changes them).  Another dtype casts the f32 draws,
    as the JAX package's `init_params(..., dtype)` does."""
    if dtype != "float32":
        jcfg, cfg, jparams, _ = _setup(arch)
        jcfg = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    else:
        cuts = CUTS.get(arch, {})
        jcfg = dataclasses.replace(jax_reduce(jax_get_config(arch)), **cuts)
        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **cuts)
        jparams = jax_init_params(jax_param_specs(jcfg), jax.random.key(0),
                                  jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batch(cfg, b=2, s=16, seed=0) -> dict:
    """numpy inputs of a (b, s) batch: tokens, hubert's frames, or
    paligemma's s / 2 patches ahead of s / 2 text tokens."""
    if cfg.family == "audio":
        return {"embeddings": np.random.default_rng(seed).normal(
            size=(b, s, cfg.frontend_dim)).astype(np.float32)}
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed)
        return {"patches": rng.normal(size=(b, s // 2, cfg.frontend_dim)
                                      ).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (b, s // 2)).astype(np.int32)}
    return {"tokens": _tokens(cfg, b, s, seed)}


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
    assert sorted(PORTED) == sorted(ARCH_IDS)


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
    audio = make_batch_specs(reduce_for_smoke(get_config("hubert-xlarge")),
                             SHAPES["train_4k"])
    assert audio == {"embeddings": ((256, 4096, 64), torch.float32),
                     "labels": ((256, 4096), torch.int32)}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "yi-9b", "rwkv6-3b", "jamba-1.5-large-398b",
                                  "paligemma-3b", "hubert-xlarge"])
def test_cache_spec_trees_match_jax(arch):
    """Every cache leaf, MLA's latents, the leading dense layer's
    ungrouped entry and the Mamba and RWKV-6 states included, with JAX's
    shape and type; yi-9b with `cluster_kv` gets the clustered leaves."""
    jcfg = jax_reduce(jax_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    if arch == "yi-9b":
        jcfg = dataclasses.replace(jcfg, cluster_kv=True,
                                   cluster_kv_clusters=16)
        cfg = dataclasses.replace(cfg, cluster_kv=True,
                                  cluster_kv_clusters=16)
    def kind(dtype) -> str:
        # the port counts in int64 where the JAX package counts in int32
        name = str(dtype).split(".")[-1]
        return "int" if name.startswith("int") else name

    want = {"/".join(str(k.key) for k in path): (leaf.shape, kind(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jax_cache_specs(jcfg, 2, 48))}
    got = {path: (leaf.shape, kind(leaf.dtype))
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


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b",
                                  "hubert-xlarge"])
def test_init_params_draws_the_new_leaves_by_their_specs(arch):
    """The Mamba, RWKV-6 and frontend leaves follow the JAX package's
    specs: ``a_log`` and ``d_skip`` ones, ``conv_w`` normal of scale 0.5,
    the loras of 0.02, ``frontend_proj`` of 1/sqrt(fan_in) (scale -1),
    each normal leaf of 2,000 values or more with its sample std within 5%
    of `ParamSpec.std`."""
    cfg = reduce_for_smoke(get_config(arch))
    specs = param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(1),
                         torch.float32, "cpu")
    leaves = dict(spec_leaves(params))
    seen = set()
    for path, spec in spec_leaves(specs):
        t = leaves[path]
        name = path.split("/")[-1]
        if spec.init != "normal":
            assert bool((t == (1.0 if spec.init == "ones" else 0.0)).all())
        elif t.numel() >= 2000:
            assert abs(float(t.std()) / spec.std - 1.0) < 0.05, path
        seen.add((name, spec.init, spec.scale))
    want = {"jamba-1.5-large-398b": {("a_log", "ones", -1.0),
                                     ("d_skip", "ones", -1.0),
                                     ("conv_w", "normal", 0.5)},
            "rwkv6-3b": {("lora_a", "normal", 0.02),
                         ("lora_b", "normal", 0.02), ("u", "zeros", -1.0)},
            "hubert-xlarge": {("frontend_proj", "normal", -1.0)}}
    assert want[arch] <= seen


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
    """Logits of the forward, then of four decode steps from an empty cache
    with the cache's leaves (K/V, MLA's latents, the Mamba and RWKV-6
    states written in place) after them; hubert, an encoder, has no
    decode."""
    jcfg, cfg, jparams, params = _setup(arch)
    batch = _batch(cfg)
    want, want_aux, _ = jax_forward(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        remat="none")
    got, aux, _ = forward(params, cfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab_size)
    assert (float(aux) == 0.0) == (not cfg.num_experts)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cfg.is_encoder:
        return

    toks = batch["tokens"]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jax_cache_specs(jcfg, 2, 16))
    cache = empty_cache(cfg, 2, 16, "cpu")
    jstep = jax.jit(jax_decode_step, static_argnums=1)   # as JAX serves it
    for t in range(4):
        jl, jcache = jstep(jparams, jcfg, jnp.asarray(toks[:, t]), jcache)
        tl, cache = decode_step(params, cfg, torch.from_numpy(toks[:, t]),
                                cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(cache["index"]) == int(jcache["index"]) == 4
    for path, leaf in spec_leaves(cache):
        if path == "index":
            continue
        keys = path.split("/")
        ref_leaf = jcache
        for key in keys:
            ref_leaf = ref_leaf[key]
        np.testing.assert_allclose(leaf.to(torch.float32).numpy(),
                                   _f32(ref_leaf), **TOL, err_msg=path)


def test_forward_matches_jax_in_bf16():
    """bf16 weights and activations throughout, the card's types.  The two
    packages round bf16 at other places, so the port is held to JAX's own
    bf16 rounding: its logits lie no farther from JAX's bf16 logits than
    those lie from the f32 forward on the same (bf16-valued) weights, in
    max and in mean.  The recurrent stacks are held so block by block
    (`test_bf16_blocks_follow_jax_through_the_stack`)."""
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
@pytest.mark.parametrize("arch", ["qwen1.5-110b", "jamba-1.5-large-398b",
                                  "rwkv6-3b"])
def test_block_result_types_follow_jax(arch, act_dtype, param_dtype):
    """The first block (attention; Mamba with its MLP; RWKV-6's time and
    channel mixes) gives the JAX code's result type for f32, bf16 and
    bf16 activations over f32 weights (jnp promotes those to f32)."""
    jcfg, cfg, jparams, params = _setup(arch, param_dtype)
    block_type, is_moe = layer_layout(cfg).positions[0]
    jlayer = jax.tree.map(lambda a: a[0], jparams["groups"]["pos00"])
    layer = layer_slice(params["groups"]["pos00"], 0)
    x = np.random.default_rng(5).normal(size=(2, 16, 128)).astype(np.float32)
    jx = jnp.asarray(x, act_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, act_dtype))
    want, _, _ = jax_block_forward(jlayer, jx, jcfg, block_type, is_moe,
                                   positions=jnp.arange(16)[None])
    got, _, _ = block_forward(layer, tx, cfg, block_type, is_moe)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    ref = _f32(want)
    tol = 1e-3 if act_dtype == param_dtype == "float32" else 5e-2
    assert np.abs(_f32(got) - ref).max() <= tol * np.abs(ref).max()


def _errors(got, want, exact, kinds: dict, kind: str) -> None:
    """Adds |port - exact| and |JAX - exact| (`exact` the port's f32 on the
    same bf16-valued inputs) to `kinds[kind]`, after checking that the
    port has JAX's type."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype), kind
    e = _f32(exact)
    port, own, top = kinds.setdefault(kind, ([], [], []))
    port.append(np.abs(_f32(got) - e).ravel())
    own.append(np.abs(_f32(want) - e).ravel())
    top.append(np.abs(e).max())


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b"])
def test_bf16_blocks_follow_jax_through_the_stack(arch):
    """bf16 through every block of the recurrent stacks (Mamba with its MLP
    or MoE, jamba's attention, RWKV-6's time and channel mixes), each fed
    JAX's bf16 hidden state: the block's forward on 16 tokens, then 3
    decode steps from an empty cache with every cache leaf after each
    (the bf16 conv and token-shift states, the f32 ssm and wkv states, the
    K/V).  Each result has JAX's type, and over the stack each kind of
    result (forward outputs, decode outputs, each cache leaf) lies no
    farther from the port's f32 on the same bf16-valued inputs than JAX's
    bf16 does: in mean, and in max give or take one bf16 step at the
    kind's largest value (the largest errors of both are rounding noise
    there, and either may be the larger by a step).  Not JAX's bits: XLA
    on the CPU rounds
    inside bf16 sigmoid, silu, softplus and gelu (55 to 85% of them
    correctly rounded on normal inputs), torch rounds once.  Nor the whole
    logits: over the layers of a random-weight stack one value rounded
    the other way grows (`python tests/test_torch_models.py` prints both
    packages' bf16 forward-against-replay gaps)."""
    jcfg, cfg, jparams, params = _setup(arch, "bfloat16")
    exact_params = jax.tree.map(lambda t: t.to(torch.float32), params)
    ecfg = dataclasses.replace(cfg, dtype="float32")
    layout = layer_layout(cfg)
    toks = _tokens(cfg)
    b, s = toks.shape
    jx = jparams["embed"]["tokens"][jnp.asarray(toks)]
    jcaches = jax.tree.map(lambda sp: jnp.zeros(sp.shape, sp.dtype),
                           jax_cache_specs(jcfg, b, 4))["groups"]
    caches = empty_cache(cfg, b, 4, "cpu")["groups"]
    ecaches = empty_cache(ecfg, b, 4, "cpu")["groups"]
    kinds: dict = {}
    for g in range(layout.num_groups):
        for p, (bt, moe) in enumerate(layout.positions):
            key = f"pos{p:02d}"
            jl = jax.tree.map(lambda a: a[g], jparams["groups"][key])
            pl = layer_slice(params["groups"][key], g)
            el = layer_slice(exact_params["groups"][key], g)
            tx = torch.tensor(_f32(jx)).to(torch.bfloat16)
            want, _, _ = jax_block_forward(jl, jx, jcfg, bt, moe,
                                           positions=jnp.arange(s)[None])
            got, _, _ = block_forward(pl, tx, cfg, bt, moe)
            exact, _, _ = block_forward(el, tx.float(), ecfg, bt, moe)
            _errors(got, want, exact, kinds, "forward")
            jc = jax.tree.map(lambda a: a[g], jcaches[key])
            pc = layer_slice(caches[key], g)
            ec = layer_slice(ecaches[key], g)
            for t in range(3):
                wt, jc = jax_block_decode(jl, jx[:, t: t + 1], jc,
                                          jnp.asarray(t), jcfg, bt, moe)
                gt, _ = block_decode(pl, tx[:, t: t + 1], pc, torch.tensor(t),
                                     cfg, bt, moe)
                et, _ = block_decode(el, tx[:, t: t + 1].float(), ec,
                                     torch.tensor(t), ecfg, bt, moe)
                _errors(gt, wt, et, kinds, "decode")
                assert set(pc) == set(jc), key
                for leaf in pc:
                    _errors(pc[leaf], jc[leaf], ec[leaf], kinds, leaf)
            jx = want
    for kind, (port, own, top) in kinds.items():
        port, own = np.concatenate(port), np.concatenate(own)
        step = 2.0 ** (np.floor(np.log2(max(top))) - 7) if max(top) else 0.0
        assert port.mean() <= own.mean(), (kind, port.mean(), own.mean())
        assert port.max() <= own.max() + step, (kind, port.max(), own.max(),
                                                step)


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


def test_unsupported_options_raise():
    """A prefix of full attention in a token model runs as the JAX
    package's (the mask of `_flash_attention`); a sequence length that the
    JAX package's chunk rule refuses raises."""
    jcfg, cfg, jparams, params = _setup("yi-9b")
    toks = _tokens(cfg)
    want, _, _ = jax_forward(jparams, dataclasses.replace(jcfg, prefix_len=8),
                             {"tokens": jnp.asarray(toks)}, remat="none")
    got, _, _ = forward(params, dataclasses.replace(cfg, prefix_len=8),
                        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="multiple of 1024"):
        forward(params, cfg,
                {"tokens": torch.zeros((1, 1500), dtype=torch.int64)})


def replay_gaps(arch: str, seeds=range(4), b: int = 4, s: int = 64) -> list:
    """In bf16, on reduced `arch` with `_setup`'s weights: for each seed's
    (b, s) tokens, the forward's last logits against those of a replay
    through `decode_step` (max abs diff as a share of the largest), in the
    JAX package (jitted, as it serves) and in the port.  Returns
    [(seed, JAX's gap, the port's gap)]."""
    jcfg, cfg, jparams, params = _setup(arch, "bfloat16")
    jforward = jax.jit(lambda p, t: jax_forward(p, jcfg, {"tokens": t},
                                                remat="none")[0][:, -1])
    jstep = jax.jit(jax_decode_step, static_argnums=1)
    rows = []
    for seed in seeds:
        toks = _tokens(cfg, b, s, seed)
        jcache = jax.tree.map(lambda sp: jnp.zeros(sp.shape, sp.dtype),
                              jax_cache_specs(jcfg, b, s))
        cache = empty_cache(cfg, b, s, "cpu")
        for t in range(s):
            jlast, jcache = jstep(jparams, jcfg, jnp.asarray(toks[:, t]),
                                  jcache)
            last, cache = decode_step(params, cfg,
                                      torch.from_numpy(toks[:, t]), cache)
        jfull = _f32(jforward(jparams, jnp.asarray(toks)))
        full = _f32(forward(params, cfg,
                            {"tokens": torch.from_numpy(toks)})[0][:, -1])
        rows.append((seed,
                     float(np.abs(jfull - _f32(jlast)).max()
                           / np.abs(jfull).max()),
                     float(np.abs(full - _f32(last)).max()
                           / np.abs(full).max())))
    return rows


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py
    for name in ("rwkv6-3b", "jamba-1.5-large-398b"):
        for seed, jax_gap, port_gap in replay_gaps(name):
            print(f"{name} seed {seed}: bf16 forward against replay on 4 x "
                  f"64 tokens, JAX {jax_gap:.6g}, port {port_gap:.6g} of "
                  f"the largest logit")
