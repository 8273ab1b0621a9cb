"""The port's clustered KV cache against the JAX package's, on the CPU.

`build_clustered_cache` on the cpu backend (the NumPy seeders, which open
the JAX package's indices, and the same Lloyd steps) gives the JAX
package's cache bit for bit on `tests/test_cluster_attn.py`'s topical
fixture; the engine's pipelined build equals the serial one.  On the
device backend (the port's default, here with its plain sweeps on the
CPU) the JAX package's three contracts hold at its thresholds.
`clustered_attention` and `append_recent` match the JAX functions on the
same cache to 1e-5 (f32 sums in other orders), and reduced yi-9b with
`cluster_kv=True` decodes 4 steps over caches built from the same K/V to
the JAX package's logits within 1e-3 (`tests/test_torch_models.py`'s
tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import cluster_attn as JCA
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import ClusterEngine
from repro_torch.core.plan import ExecutionSpec
from repro_torch.models import (decode_step, forward, make_cache_specs,
                                params_from_numpy)
from repro_torch.models import cluster_attn as CA

CPU = ExecutionSpec(backend="cpu", device="cpu")
DEVICE_ON_CPU = ExecutionSpec(backend="device", device="cpu")
LEAVES = ("centroids", "k_slots", "v_slots", "slot_valid")


def _topical_kv(b=1, s=2048, hk=2, dh=32, topics=16, seed=0):
    """`tests/test_cluster_attn.py`'s fixture: keys around 16 topics."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(topics, dh)) * 2.0
    keys = (t[rng.integers(topics, size=(b, s))][:, :, None, :]
            + rng.normal(size=(b, s, 1, dh)) * 0.5).repeat(hk, axis=2)
    values = rng.normal(size=(b, s, hk, dh))
    return keys.astype(np.float32), values.astype(np.float32), t


def _exact(q, keys, values, scale):
    kf = keys.transpose(0, 2, 1, 3)
    vf = values.transpose(0, 2, 1, 3)
    sc = np.einsum("bhd,bhsd->bhs", np.asarray(q), kf) * scale
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhs,bhsv->bhv", p, vf)


def _pair(**kw):
    return JCA.ClusterKVConfig(**kw), CA.ClusterKVConfig(**kw)


def _to_torch(jcache) -> dict:
    return {key: torch.from_numpy(np.array(val)) for key, val in
            jcache.items()}


@pytest.fixture(scope="module")
def topical():
    keys, values, topics = _topical_kv()
    jcfg, cfg = _pair(num_clusters=64, topc=16, capacity_slack=4.0,
                      lloyd_iters=2)
    jinfo, info = {}, {}
    want = JCA.build_clustered_cache(keys, values, jcfg, info=jinfo)
    got = CA.build_clustered_cache(keys, values, cfg, info=info,
                                   execution=CPU)
    return keys, values, topics, cfg, want, jinfo, got, info


def test_cpu_build_is_the_jax_cache_bit_for_bit(topical):
    _, _, _, _, want, jinfo, got, info = topical
    for leaf in LEAVES + ("k_recent", "v_recent"):
        assert got[leaf].shape == want[leaf].shape, leaf
        np.testing.assert_array_equal(got[leaf].numpy(),
                                      np.asarray(want[leaf]), err_msg=leaf)
    assert got["slot_valid"].dtype == torch.bool
    assert got["k_slots"].dtype == torch.float32
    assert got["recent_len"].dtype == torch.int64
    assert got["recent_len"].shape == () and int(got["recent_len"]) == 0
    assert info == jinfo and info["capacity"] == 128
    assert info["dropped_frac"] < 0.05


def test_engine_build_equals_the_serial_build(topical):
    keys, values, _, cfg, _, _, got, info = topical
    with ClusterEngine(execution=CPU, prepare_workers=2) as engine:
        info2 = {}
        piped = CA.build_clustered_cache(keys, values, cfg, info=info2,
                                         engine=engine)
    for leaf in LEAVES:
        assert torch.equal(piped[leaf], got[leaf]), leaf
    assert info2 == info


def test_build_takes_tensors_and_returns_on_the_execution_device(topical):
    keys, values, _, cfg, _, _, got, _ = topical
    again = CA.build_clustered_cache(torch.from_numpy(keys),
                                     torch.from_numpy(values), cfg,
                                     execution=CPU)
    for leaf in LEAVES:
        assert again[leaf].device.type == "cpu"
        assert torch.equal(again[leaf], got[leaf]), leaf


def test_specs_match_jax():
    jcfg, cfg = _pair(num_clusters=16, recent_window=8)
    want = JCA.cluster_cache_specs(2, 3, 32, 24, 100, jcfg, jnp.float32)
    got = CA.cluster_cache_specs(2, 3, 32, 24, 100, cfg, torch.bfloat16)
    assert set(got) == set(want)
    for key, spec in got.items():
        assert spec.shape == want[key].shape, key
    assert got["slot_valid"].dtype == torch.bool
    assert got["recent_len"].dtype == torch.int64
    assert got["k_slots"].dtype == torch.bfloat16


def test_concentrated_queries_are_accurate_on_the_device_backend():
    """`test_concentrated_queries_are_accurate`, on the port's default
    (device) backend: 5 topic queries err < 0.08, drops < 5%."""
    keys, values, topics = _topical_kv()
    cfg = CA.ClusterKVConfig(num_clusters=64, topc=16, capacity_slack=4.0,
                             lloyd_iters=2)
    info = {}
    cache = CA.build_clustered_cache(keys, values, cfg, info=info,
                                     execution=DEVICE_ON_CPU)
    assert info["dropped_frac"] < 0.05
    scale = 1.0 / np.sqrt(keys.shape[-1])
    rng = np.random.default_rng(1)
    for _ in range(5):
        qv = topics[rng.integers(len(topics))] * 1.5
        q = torch.from_numpy(np.broadcast_to(qv, (1, 2, 32)).astype(
            np.float32))
        out_c = CA.clustered_attention(q, cache, cfg, scale=scale).numpy()
        out_e = _exact(q.numpy(), keys, values, scale)
        err = np.abs(out_c - out_e).max() / (np.abs(out_e).max() + 1e-9)
        assert err < 0.08, err


def test_recent_window_is_exact_on_the_device_backend():
    keys, values, _ = _topical_kv(s=256)
    cfg = CA.ClusterKVConfig(num_clusters=16, topc=16, capacity_slack=4.0)
    cache = CA.build_clustered_cache(keys, values, cfg,
                                     execution=DEVICE_ON_CPU)
    rng = np.random.default_rng(2)
    k_new = torch.from_numpy((rng.normal(size=(1, 2, 32)) * 3).astype(
        np.float32))
    v_new = torch.from_numpy(rng.normal(size=(1, 2, 32)).astype(np.float32))
    assert CA.append_recent(cache, k_new, v_new) is cache
    assert int(cache["recent_len"]) == 1
    out = CA.clustered_attention(k_new * 4.0, cache, cfg,
                                 scale=1.0 / np.sqrt(32)).numpy()
    v = v_new.numpy()
    cos = (out * v).sum() / (np.linalg.norm(out) * np.linalg.norm(v) + 1e-9)
    assert cos > 0.7


def test_topc_equals_c_recovers_exact_on_the_device_backend():
    keys, values, _ = _topical_kv(s=512)
    cfg = CA.ClusterKVConfig(num_clusters=8, topc=8, capacity_slack=16.0)
    info = {}
    cache = CA.build_clustered_cache(keys, values, cfg, info=info,
                                     execution=DEVICE_ON_CPU)
    assert info["dropped_frac"] == 0.0
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 32)).astype(np.float32))
    scale = 1.0 / np.sqrt(32)
    out_c = CA.clustered_attention(q, cache, cfg, scale=scale).numpy()
    out_e = _exact(q.numpy(), keys, values, scale)
    np.testing.assert_allclose(out_c, out_e, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("appended", [0, 3, 10])
def test_attention_and_ring_match_jax(topical, appended):
    """`clustered_attention` after `appended` ring writes (10 wrap a ring
    of 8), and the ring itself, against the JAX functions on the same
    cache, with GQA (4 query heads over 2 KV heads)."""
    keys, values, _, _, want, _, _, _ = topical
    jcfg, cfg = _pair(num_clusters=64, topc=16, recent_window=8)
    jcache = {**want,
              "k_recent": jnp.zeros((1, 8, 2, 32), jnp.float32),
              "v_recent": jnp.zeros((1, 8, 2, 32), jnp.float32)}
    cache = _to_torch(jcache)
    cache["recent_len"] = torch.zeros((), dtype=torch.int64)
    rng = np.random.default_rng(7)
    for _ in range(appended):
        kn, vn = (rng.normal(size=(1, 2, 32)).astype(np.float32)
                  for _ in range(2))
        jcache = JCA.append_recent(jcache, jnp.asarray(kn), jnp.asarray(vn))
        CA.append_recent(cache, torch.from_numpy(kn), torch.from_numpy(vn))
    for leaf in ("k_recent", "v_recent"):
        np.testing.assert_array_equal(cache[leaf].numpy(),
                                      np.asarray(jcache[leaf]))
    assert int(cache["recent_len"]) == int(jcache["recent_len"]) == appended
    q = rng.normal(size=(1, 4, 32)).astype(np.float32) * 2.0
    w = JCA.clustered_attention(jnp.asarray(q), jcache, jcfg, scale=0.2)
    g = CA.clustered_attention(torch.from_numpy(q), cache, cfg, scale=0.2)
    assert g.dtype == torch.float32 and g.shape == (1, 4, 32)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)


def test_decode_over_clustered_caches_matches_jax():
    """Reduced yi-9b with `cluster_kv=True` (8 clusters, all gathered):
    each layer's cache is built by each package from its own prefill's
    K/V of 2 x 64 tokens, then 4 decode steps; logits to 1e-3."""
    overrides = dict(cluster_kv=True, cluster_kv_clusters=8,
                     cluster_kv_topc=8)
    jcfg = dataclasses.replace(jax_reduce(jax_get_config("yi-9b")),
                               **overrides)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("yi-9b")),
                              **overrides)
    jparams = jax_init_params(jax_param_specs(jcfg), jax.random.key(0),
                              jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 64))
    _, _, jkv = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                            return_cache=True, remat="none")
    _, _, kv = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                       return_cache=True)
    kv = kv["groups"]["pos00"]
    ckv = dict(num_clusters=8, topc=8)
    jlayers, layers = [], []
    for layer in range(cfg.num_layers):
        jlayers.append(JCA.build_clustered_cache(
            np.asarray(jkv["groups"]["pos00"]["k"][layer]),
            np.asarray(jkv["groups"]["pos00"]["v"][layer]),
            JCA.ClusterKVConfig(**ckv), seed=layer))
        layers.append(CA.build_clustered_cache(
            kv["k"][layer], kv["v"][layer], CA.ClusterKVConfig(**ckv),
            seed=layer, execution=CPU))
    jcache = {"index": jnp.asarray(64, jnp.int32), "groups": {
        "pos00": jax.tree.map(lambda *xs: jnp.stack(xs), *jlayers)}}
    cache = {"index": torch.tensor(64), "groups": {"pos00": {
        leaf: torch.stack([c[leaf] for c in layers]) for leaf in layers[0]}}}
    spec = make_cache_specs(cfg, 2, 64)["groups"]["pos00"]
    for leaf, t in cache["groups"]["pos00"].items():
        assert t.shape == spec[leaf].shape and t.dtype == spec[leaf].dtype
    nxt = np.random.default_rng(1).integers(1, cfg.vocab_size, (4, 2))
    for t in range(4):
        jl, jcache = jax_decode_step(jparams, jcfg, jnp.asarray(nxt[t]),
                                     jcache)
        tl, cache = decode_step(params, cfg, torch.from_numpy(nxt[t]),
                                cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
    assert int(cache["index"]) == 68
    np.testing.assert_array_equal(
        cache["groups"]["pos00"]["recent_len"].numpy(), [4] * 4)
