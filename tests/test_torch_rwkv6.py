"""The port's RWKV-6 block against the JAX package's, on the CPU.

Parameters are drawn with numpy from a seed in the JAX package's spec
shapes (reduced rwkv6-3b: d_model 128, two wkv heads of 64, d_ff 256),
with the zero- and one-initialised leaves moved off their constants, and
``w0`` spread over [-10, 2] so that the log-decay meets both ends of its
clamp.  Outputs and states are f32 and held at rtol/atol 1e-4: the chunked
form's exp(-cum) factors reach exp(16 x 2.5) inside a chunk, and the two
packages round its f32 sums in other orders.  The decode carries its
state in the cache tensors it is handed, so a dropped state shows as a
wrong second step here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import rwkv6 as jrwkv
from repro.models.transformer import block_decode as jax_block_decode
from repro.models.transformer import block_forward as jax_block_forward
from repro.models.transformer import block_specs as jax_block_specs
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import params_from_numpy, rwkv6
from repro_torch.models.model import empty_cache
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import block_decode, block_forward

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "rwkv6-3b"


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's tensors here are small, so its ops run on one thread:
    when the suite's workers share the cores, OpenMP teams spun up for
    each small op stall one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs():
    return jax_reduce(jax_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))


def _draw(specs, seed):
    """numpy leaves of a JAX spec tree: normal times the spec's std;
    "ones" leaves near 1, "zeros" leaves near 0, ``w0`` over [-10, 2]."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        shape = spec.shape
        if path[-1].key == "w0":
            return rng.uniform(-10.0, 2.0, size=shape).astype(np.float32)
        if spec.init == "ones":
            return (1.0 + 0.3 * rng.normal(size=shape)).astype(np.float32)
        if spec.init == "zeros":
            return (0.3 * rng.normal(size=shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = spec.scale if spec.scale > 0 else fan_in ** -0.5
        return (std * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, specs, is_leaf=lambda n: hasattr(n, "init"))


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _time_mix(seed=0):
    jcfg, cfg = _cfgs()
    return (jcfg, cfg) + _both(_draw(jrwkv.rwkv_time_specs(jcfg), seed))


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _state(spec):
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}


def test_specs_and_state_spec_match_jax():
    jcfg, cfg = _cfgs()
    for jfn, fn in ((jrwkv.rwkv_time_specs, rwkv6.rwkv_time_specs),
                    (jrwkv.rwkv_channel_specs, rwkv6.rwkv_channel_specs)):
        want = {"/".join(str(k.key) for k in path): (s.shape, s.init,
                                                     s.scale)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    jfn(jcfg), is_leaf=lambda n: hasattr(n, "init"))}
        got = {p: (s.shape, s.init, s.scale)
               for p, s in spec_leaves(fn(cfg))}
        assert got == want
    jstate = jrwkv.rwkv_state_spec(jcfg, 3, jnp.bfloat16)
    state = rwkv6.rwkv_state_spec(cfg, 3, torch.bfloat16)
    assert state["wkv"] == (jstate["wkv"].shape, torch.float32)
    for leaf in ("x_prev_time", "x_prev_chan"):
        assert state[leaf] == (jstate[leaf].shape, torch.bfloat16)
    assert (rwkv6.CHUNK, rwkv6.MIN_LOG_W) == (jrwkv.CHUNK, jrwkv.MIN_LOG_W)


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7])
def test_token_shift_matches_jax(s, with_prev):
    """Both branches: one position (the decode's) and several."""
    x = _x((2, s, 8))
    prev = _x((2, 8), seed=2) if with_prev else None
    want = jrwkv._token_shift(jnp.asarray(x),
                              None if prev is None else jnp.asarray(prev))
    got = rwkv6._token_shift(torch.from_numpy(x),
                             None if prev is None else torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ddlerp_and_projections_match_jax():
    """The five data-dependent mixes, r, k, v, g and the clamped log-decay
    (both ends of the clamp reached)."""
    jcfg, cfg, jp, params = _time_mix()
    x, xs = _x((2, 16, 128)), _x((2, 16, 128), seed=2)
    _close(rwkv6._ddlerp(params, torch.from_numpy(x), torch.from_numpy(xs)),
           jrwkv._ddlerp(jp, jnp.asarray(x), jnp.asarray(xs)))
    prev = _x((2, 128), seed=3)
    want = jrwkv._time_projections(jp, jnp.asarray(x), jcfg,
                                   x_prev=jnp.asarray(prev))
    got = rwkv6._time_projections(params, torch.from_numpy(x), cfg,
                                  x_prev=torch.from_numpy(prev))
    for g, w in zip(got, want):
        _close(g, w)
    logw = got[-1]
    assert logw.dtype == torch.float32
    assert bool((logw == rwkv6.MIN_LOG_W).any())
    assert bool((logw == torch.tensor(-1e-4)).any())


def test_group_norm_matches_jax():
    x = _x((2, 5, 128)) * 3 + 1
    scale = _x((128,), seed=4)
    _close(rwkv6._group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             2, 64),
           jrwkv._group_norm(jnp.asarray(x), jnp.asarray(scale), 2, 64))


@pytest.mark.parametrize("s", [8, 16, 64])
def test_time_forward_matches_jax(s):
    """The chunked form: one chunk shorter than `CHUNK` (S = 8), one
    chunk, four chunks carrying the state."""
    jcfg, cfg, jp, params = _time_mix(seed=s)
    x = _x((2, s, 128), seed=s)
    want = jrwkv.rwkv_time_forward(jp, jnp.asarray(x), jcfg)
    got = rwkv6.rwkv_time_forward(params, torch.from_numpy(x), cfg)
    assert got.shape == (2, s, 128)
    _close(got, want)


def test_time_forward_refuses_a_ragged_length():
    _, cfg, _, params = _time_mix()
    with pytest.raises(ValueError, match="multiple of 16"):
        rwkv6.rwkv_time_forward(params, torch.zeros((1, 20, 128)), cfg)


def test_time_decode_steps_carry_the_state_as_jax():
    """Twenty decode steps (past a chunk edge): every output and, after
    every step, ``wkv`` and ``x_prev_time`` (written into the tensors
    handed in) against the JAX decode; the outputs against the chunked
    forward's positions."""
    jcfg, cfg, jp, params = _time_mix(seed=7)
    x = _x((2, 20, 128), seed=8)
    state = _state(rwkv6.rwkv_state_spec(cfg, 2, torch.float32))
    wkv = state["wkv"]
    jstate = {k: jnp.zeros(s.shape, s.dtype) for k, s in
              jrwkv.rwkv_state_spec(jcfg, 2, jnp.float32).items()}
    outs = []
    for t in range(20):
        xt = x[:, t: t + 1]
        want, new = jrwkv.rwkv_time_decode(jp, jnp.asarray(xt), jstate, jcfg)
        jstate = {**jstate, **new}
        got, state = rwkv6.rwkv_time_decode(params, torch.from_numpy(xt),
                                            state, cfg)
        assert state["wkv"] is wkv
        _close(got, want)
        _close(wkv, jstate["wkv"])
        _close(state["x_prev_time"], jstate["x_prev_time"])
        outs.append(got)
    full = rwkv6.rwkv_time_forward(params, torch.from_numpy(
        np.pad(x, ((0, 0), (0, 12), (0, 0)))), cfg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               full[:, :20].numpy(), **TOL)


def test_channel_mix_forward_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp, params = _both(_draw(jrwkv.rwkv_channel_specs(jcfg), 9))
    x = _x((2, 6, 128), seed=10)
    _close(rwkv6.rwkv_channel_forward(params, torch.from_numpy(x), cfg),
           jrwkv.rwkv_channel_forward(jp, jnp.asarray(x), jcfg))
    state = _state(rwkv6.rwkv_state_spec(cfg, 2, torch.float32))
    jstate = {"x_prev_chan": jnp.zeros((2, 128))}
    for t in range(3):
        xt = x[:, t: t + 1]
        want, new = jrwkv.rwkv_channel_decode(jp, jnp.asarray(xt), jstate,
                                              jcfg)
        jstate = {**jstate, **new}
        got, _ = rwkv6.rwkv_channel_decode(params, torch.from_numpy(xt),
                                           state, cfg)
        _close(got, want)
        _close(state["x_prev_chan"], jstate["x_prev_chan"])


def test_block_forward_and_decode_match_jax():
    """A whole RWKV-6 block (norms, time mix, channel mix) in the layout's
    forward and in five decode steps over the model's cache views."""
    jcfg, cfg = _cfgs()
    jp, params = _both(_draw(jax_block_specs(jcfg, "rwkv6", False), 11))
    assert set(params) == {"norm1", "norm2", "time_mix", "channel_mix"}
    x = _x((2, 32, 128), seed=12)
    want, _, _ = jax_block_forward(jp, jnp.asarray(x), jcfg, "rwkv6", False)
    got, cache, _ = block_forward(params, torch.from_numpy(x), cfg, "rwkv6",
                                  False, return_cache=True)
    assert cache is None
    _close(got, want)

    stacked = empty_cache(cfg, 2, 8, "cpu")["groups"]["pos00"]
    view = {k: t[2] for k, t in stacked.items()}
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in
              jrwkv.rwkv_state_spec(jcfg, 2, jnp.float32).items()}
    for t in range(5):
        xt = x[:, t: t + 1]
        want, jcache = jax_block_decode(jp, jnp.asarray(xt), jcache,
                                        jnp.asarray(t), jcfg, "rwkv6", False)
        got, _ = block_decode(params, torch.from_numpy(xt), view,
                              torch.tensor(t), cfg, "rwkv6", False)
        _close(got, want)
    for leaf in ("wkv", "x_prev_time", "x_prev_chan"):
        _close(stacked[leaf][2], jcache[leaf])
        assert not bool(stacked[leaf][1].any())
