"""The port's serving path against the JAX package's, on the CPU.

`prefill`, `Engine.generate` and `Engine.replay_prefill` on reduced yi-9b
in f32, with the JAX package's weights carried across
(`params_from_numpy`); the same for reduced qwen2-moe-a2.7b (fused
prefill) and deepseek-v2-lite-16b (MLA latents, a leading dense layer:
`generate` replays the prompt, the JAX package's rule); `generate` on
reduced rwkv6-3b and jamba-1.5-large-398b (their recurrent states come
out of the replayed decode steps, as `tests/test_serving.py`'s
`test_engine_hybrid_replay_path` drives the JAX engine), and the
launcher's CPU smoke for all five.  Logits and caches are held to 1e-3 (f32 rounding
over four layers whose hidden states grow to about 100; see
`tests/test_torch_models.py`), prefill against replay to 2e-3 (the JAX
package's own `test_prefill_matches_replay` tolerance), and greedy tokens
exactly.
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
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.prefill import prefill as jax_prefill
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve
from repro_torch.models import params_from_numpy
from repro_torch.models.params import spec_leaves
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.prefill import prefill

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


# Reduced jamba has two periods of 8 layers; one holds its whole layout
# (Mamba, attention at position 4, MoE every other layer) at half the cost
CUTS = {"jamba-1.5-large-398b": {"num_layers": 8}}


def _model(arch):
    cuts = CUTS.get(arch, {})
    jcfg = dataclasses.replace(jax_reduce(jax_get_config(arch)), **cuts)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **cuts)
    jparams = jax_init_params(jax_param_specs(jcfg), jax.random.key(0),
                              jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def model():
    return _model("yi-9b")


@pytest.fixture(scope="module", params=["qwen2-moe-a2.7b",
                                        "deepseek-v2-lite-16b"])
def moe_model(request):
    return _model(request.param)


def _prompts(n, s, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (n, s))


def test_prefill_matches_jax(model):
    jcfg, cfg, jparams, params = model
    toks = _prompts(2, 24, 0).astype(np.int32)
    jl, jcache = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             max_seq=48)
    tl, cache = prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                        max_seq=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(cache["index"]) == int(jcache["index"]) == 24
    for leaf in ("k", "v"):
        got = cache["groups"]["pos00"][leaf]
        want = np.asarray(jcache["groups"]["pos00"][leaf])
        assert got.shape == want.shape == (4, 2, 48, 2, 32)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert not bool(got[:, :, 24:].any())


def test_prefill_matches_replay(model):
    _, cfg, _, params = model
    eng = Engine(params, cfg, ServeConfig(max_seq=48), device="cpu")
    toks = torch.from_numpy(_prompts(2, 24, 0))
    logits_f, cache_f = prefill(params, cfg, {"tokens": toks}, max_seq=48)
    logits_r, cache_r = eng.replay_prefill(toks)
    np.testing.assert_allclose(logits_f.numpy(), logits_r.numpy(),
                               rtol=2e-3, atol=2e-3)
    assert int(cache_f["index"]) == int(cache_r["index"]) == 24
    np.testing.assert_allclose(cache_f["groups"]["pos00"]["k"].numpy(),
                               cache_r["groups"]["pos00"]["k"].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_generate_matches_jax(model):
    jcfg, cfg, jparams, params = model
    prompts = _prompts(3, 16, 1)
    want = JaxEngine(jparams, jcfg, JaxServeConfig(
        max_new_tokens=8, max_seq=64)).generate(prompts)
    got = Engine(params, cfg, ServeConfig(max_new_tokens=8, max_seq=64),
                 device="cpu").generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_generate_is_deterministic(model):
    _, cfg, _, params = model
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=8, max_seq=64),
                 device="cpu")
    prompts = _prompts(3, 10, 1)
    np.testing.assert_array_equal(eng.generate(prompts),
                                  eng.generate(prompts))


def test_sampling_replays_its_seed(model):
    """At temperature > 0 the same seed gives the same tokens, and the
    tokens are valid ids; another seed draws others here."""
    _, cfg, _, params = model
    prompts = _prompts(2, 6, 4)

    def run(seed):
        return Engine(params, cfg, ServeConfig(
            max_new_tokens=12, max_seq=32, temperature=2.0, seed=seed),
            device="cpu").generate(prompts)

    first = run(3)
    np.testing.assert_array_equal(first, run(3))
    assert ((first >= 0) & (first < cfg.vocab_size)).all()
    assert not np.array_equal(first, run(4))


def test_generate_refuses_an_overfull_cache(model):
    _, cfg, _, params = model
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=8, max_seq=20),
                 device="cpu")
    with pytest.raises(ValueError, match="max_seq=20"):
        eng.generate(_prompts(1, 16, 0))


def test_engine_checks_the_parameters_device(model):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="lie on cpu"):
        Engine(params, cfg, ServeConfig(), device="meta")


def test_launcher_smoke_on_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--tokens", "4"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "yi-9b on cpu" in text and "first sequence:" in text


def test_moe_prefill_matches_jax(moe_model):
    """Logits, the cache tree's leaves (K/V or MLA's latents, the dense
    layer's ungrouped entry padded on its axis 1) and the index."""
    jcfg, cfg, jparams, params = moe_model
    toks = _prompts(2, 16, 0).astype(np.int32)
    jl, jcache = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             max_seq=40)
    tl, cache = prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                        max_seq=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(jcache)}
    got = dict(spec_leaves(cache))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want[path]),
                                   **TOL)
    assert int(cache["index"]) == 16
    if cfg.first_k_dense:
        assert cache["dense0"]["c_kv"].shape == (2, 40, cfg.kv_lora_rank)
        assert not bool(cache["dense0"]["c_kv"][:, 16:].any())


def test_moe_prefill_matches_replay(moe_model):
    """With a capacity factor at which no expert can overflow: capacity
    applies per dispatch window, so at the default factor the prefill's
    one window of 32 tokens drops assignments that replay's windows of 2
    keep (in the JAX package too)."""
    _, cfg, _, params = moe_model
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    toks = torch.from_numpy(_prompts(2, 16, 2))
    logits_f, _ = prefill(params, cfg, {"tokens": toks}, max_seq=24)
    logits_r, cache_r = Engine(params, cfg, ServeConfig(max_seq=24),
                               device="cpu").replay_prefill(toks)
    np.testing.assert_allclose(logits_f.numpy(), logits_r.numpy(),
                               rtol=2e-3, atol=2e-3)
    assert int(cache_r["index"]) == 16


def test_moe_generate_matches_jax(moe_model):
    jcfg, cfg, jparams, params = moe_model
    prompts = _prompts(3, 16, 1)
    want = JaxEngine(jparams, jcfg, JaxServeConfig(
        max_new_tokens=6, max_seq=32)).generate(prompts)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=6, max_seq=32),
                 device="cpu")
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts), got)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_launcher_smoke_on_cpu_for_moe(arch, capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                      "--batch", "2", "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3)
    assert f"{arch} on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_hybrid_generate_matches_jax(arch):
    """Replay prefill then decode over the Mamba and RWKV-6 states: the
    same greedy tokens as the JAX engine, twice; the fused prefill
    refuses the stack as the JAX package's does."""
    jcfg, cfg, jparams, params = _model(arch)
    prompts = _prompts(2, 6, 2, cfg.vocab_size)
    want = JaxEngine(jparams, jcfg, JaxServeConfig(
        max_new_tokens=4, max_seq=32)).generate(prompts)
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=4, max_seq=32),
                 device="cpu")
    got = eng.generate(prompts)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts), got)
    with pytest.raises(NotImplementedError, match="replay_prefill"):
        prefill(params, cfg, {"tokens": torch.from_numpy(prompts)})


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_launcher_smoke_on_cpu_for_hybrids(arch, capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                      "--batch", "2", "--prompt-len", "8", "--tokens", "3"])
    assert out.shape == (2, 3)
    assert f"{arch} on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch,why", [("hubert-xlarge", "encoder-only"),
                                      ("paligemma-3b", "patches")])
def test_launcher_stops_with_the_reason(arch, why):
    with pytest.raises(SystemExit, match=why):
        serve.main(["--smoke", "--device", "cpu", "--arch", arch])
