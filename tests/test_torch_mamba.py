"""The port's Mamba block against the JAX package's, on the CPU.

Parameters are drawn with numpy from a seed in the JAX package's spec
shapes (`mamba_specs` of reduced jamba-1.5-large-398b: d_model 128,
d_inner 256, d_state 8, d_conv 4), with the zero- and one-initialised
leaves moved off their constants so that every term shows, and handed to
both packages.  Outputs and states are f32 and held at rtol/atol 1e-4:
the two packages take the same f32 steps and differ only in the order of
sums (the scan's products of 8 states, the projections).  The decode
carries its state in the cache tensors it is handed, so a dropped state
shows as a wrong second step here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import mamba as jmamba
from repro.models.transformer import block_decode as jax_block_decode
from repro.models.transformer import block_forward as jax_block_forward
from repro.models.transformer import block_specs as jax_block_specs
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import mamba, params_from_numpy
from repro_torch.models.model import empty_cache
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import (block_decode, block_forward,
                                            block_specs)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's tensors here are small, so its ops run on one thread:
    when the suite's workers share the cores, OpenMP teams spun up for
    each small op stall one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**changes):
    jcfg = dataclasses.replace(jax_reduce(jax_get_config(ARCH)), **changes)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes)
    return jcfg, cfg


def _draw(specs, seed):
    """numpy leaves of a JAX spec tree: normal times the spec's std;
    "ones" leaves near 1 and "zeros" leaves near 0 (off their constants)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        shape = spec.shape
        if spec.init == "ones":
            return (1.0 + 0.3 * rng.normal(size=shape)).astype(np.float32)
        if spec.init == "zeros":
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = spec.scale if spec.scale > 0 else fan_in ** -0.5
        return (std * rng.normal(size=shape)).astype(np.float32)

    return jax.tree.map(draw, specs, is_leaf=lambda n: hasattr(n, "init"))


def _mixer(seed=0, **changes):
    jcfg, cfg = _cfgs(**changes)
    tree = _draw(jmamba.mamba_specs(jcfg), seed)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        params_from_numpy(tree, "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_specs_and_state_spec_match_jax():
    jcfg, cfg = _cfgs()
    want = {"/".join(str(k.key) for k in path): (s.shape, s.init, s.scale)
            for path, s in jax.tree_util.tree_leaves_with_path(
                jmamba.mamba_specs(jcfg), is_leaf=lambda n: hasattr(n, "init"))}
    got = {path: (s.shape, s.init, s.scale)
           for path, s in spec_leaves(mamba.mamba_specs(cfg))}
    assert got == want
    jstate = jmamba.mamba_state_spec(jcfg, 3, jnp.bfloat16)
    state = mamba.mamba_state_spec(cfg, 3, torch.bfloat16)
    assert state["ssm"] == (jstate["ssm"].shape, torch.float32)
    assert state["conv"] == (jstate["conv"].shape, torch.bfloat16)
    assert mamba.CHUNK == jmamba.CHUNK == 64


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("length", [1, 5, 64])
def test_causal_conv_matches_jax(length, with_prev):
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, length, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    prev = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_prev \
        else None
    want, want_state = jmamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if prev is None else jnp.asarray(prev))
    got, state = mamba._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if prev is None else torch.from_numpy(prev))
    _close(got, want)
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("length", [32, 64, 192])
def test_forward_matches_jax(length, lowp):
    """One chunk shorter than `CHUNK` (L = 32), one chunk, three chunks;
    f32 scan inputs and the bf16 storage of `mamba_lowp_scan`."""
    jcfg, cfg, jp, params = _mixer(mamba_lowp_scan=lowp)
    x = _x((2, length, 128))
    want = jmamba.mamba_forward(jp, jnp.asarray(x), jcfg)
    got = mamba.mamba_forward(params, torch.from_numpy(x), cfg)
    assert got.shape == (2, length, 128) and got.dtype == torch.float32
    _close(got, want)


def test_forward_refuses_a_ragged_length():
    _, cfg, _, params = _mixer()
    with pytest.raises(ValueError, match="multiple of 64"):
        mamba.mamba_forward(params, torch.zeros((1, 100, 128)), cfg)


def test_decode_steps_carry_the_state_as_jax():
    """Ten decode steps from a zero state: every output and, after every
    step, both states (written into the cache tensors handed in) against
    the JAX decode; the outputs against the chunked forward's positions."""
    jcfg, cfg, jp, params = _mixer(seed=3)
    x = _x((2, 10, 128), seed=4)
    spec = mamba.mamba_state_spec(cfg, 2, torch.float32)
    state = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    ssm, conv = state["ssm"], state["conv"]
    jstate = {k: jnp.zeros(s.shape, s.dtype) for k, s in
              jmamba.mamba_state_spec(jcfg, 2, jnp.float32).items()}
    outs = []
    for t in range(10):
        want, jstate = jmamba.mamba_decode(jp, jnp.asarray(x[:, t: t + 1]),
                                           jstate, jcfg)
        got, state = mamba.mamba_decode(params, torch.from_numpy(
            x[:, t: t + 1]), state, cfg)
        assert state["ssm"] is ssm and state["conv"] is conv
        _close(got, want)
        _close(ssm, jstate["ssm"])
        _close(conv, jstate["conv"])
        outs.append(got)
    full = mamba.mamba_forward(params, torch.from_numpy(
        np.pad(x, ((0, 0), (0, 6), (0, 0)))), cfg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               full[:, :10].numpy(), **TOL)


@pytest.mark.parametrize("is_moe", [False, True])
def test_block_forward_and_decode_match_jax(is_moe):
    """A whole Mamba block (norms, mixer, MLP or MoE) in the layout's
    forward and in four decode steps over the model's cache views."""
    jcfg, cfg = _cfgs()
    tree = _draw(jax_block_specs(jcfg, "mamba", is_moe), 5)
    jp = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, "cpu")
    assert {p for p, _ in spec_leaves(block_specs(cfg, "mamba", is_moe))} \
        == {p for p, _ in spec_leaves(params)}
    x = _x((2, 64, 128), seed=6)
    want, _, _ = jax_block_forward(jp, jnp.asarray(x), jcfg, "mamba", is_moe)
    got, cache, _ = block_forward(params, torch.from_numpy(x), cfg, "mamba",
                                  is_moe, return_cache=True)
    assert cache is None
    _close(got, want)

    stacked = empty_cache(cfg, 2, 8, "cpu")["groups"]["pos00"]
    view = {k: t[1] for k, t in stacked.items()}
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in
              jmamba.mamba_state_spec(jcfg, 2, jnp.float32).items()}
    for t in range(4):
        xt = x[:, t: t + 1]
        want, jcache = jax_block_decode(jp, jnp.asarray(xt), jcache,
                                        jnp.asarray(t), jcfg, "mamba", is_moe)
        got, _ = block_decode(params, torch.from_numpy(xt), view,
                              torch.tensor(t), cfg, "mamba", is_moe)
        _close(got, want)
    _close(stacked["ssm"][1], jcache["ssm"])
    _close(stacked["conv"][1], jcache["conv"])
    assert not bool(stacked["ssm"][0].any())
