"""The port's gradient compression against the JAX package's, on the CPU.

Held here:

  * `int8_compress` against the JAX package's on the same NumPy values
    (Hypothesis over sizes, magnitudes and residuals): q and the scale
    identical, the residual within one f32 ulp of the compressed value
    (XLA may fuse x - q s into one rounding), or below the smallest
    normal f32 (XLA flushes subnormals to zero);
  * error feedback: 50 rounds of the same gradient dequantise to it
    within 2%, the mirror of the JAX package's own test;
  * on a one-rank gloo group: `compressed_psum` against the JAX package's
    under `shard_map` on a (1,) mesh (the value bit for bit, the residual
    within one ulp), and `make_ddp_step` over the 60 steps of the JAX
    package's test against its losses within rtol 1e-5 (or one f32 ulp
    of the first loss, `DDP_ATOL`, where the loss has fallen 10^4-fold);
  * on two gloo ranks, spawned (`tests/_torch_dist_workers.py`, whose
    processes import no JAX): `compressed_psum` equal to the sum of the
    ranks' q times the largest scale over n, computed in NumPy, and the
    uncompressed DDP step on two halves of a batch against one rank on
    the whole batch within f32 rounding (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import _torch_dist_workers as workers
from repro.training import grad_compress as jgc
from repro_torch.training import grad_compress as gc

# make_ddp_step against the JAX package: the weights follow its weights
# within a few f32 ulps at every step (the gradients' sums round in
# another order), and the losses within rtol 1e-5, or within one f32 ulp
# of the first loss (about 13, whose ulp is 9.5e-7) once the loss has
# fallen by four orders of magnitude and a few ulps of the weights move
# it by more than 1e-5 of itself
DDP_RTOL, DDP_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo default group for the module's in-process tests."""
    if dist.is_initialized():
        pytest.fail("a default process group is already initialized")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield None
    dist.destroy_process_group()


def _within_one_ulp(got: np.ndarray, want: np.ndarray, scale: np.ndarray):
    """|got - want| within one f32 ulp of `scale`, or below the smallest
    normal f32 (XLA on the CPU flushes subnormal results to zero)."""
    ulp = np.maximum(np.spacing(np.abs(scale).astype(np.float32)),
                     np.finfo(np.float32).tiny)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@settings(deadline=None, max_examples=60, derandomize=True)
@given(st.lists(st.floats(-1e3, 1e3), min_size=1, max_size=64),
       st.integers(-30, 30), st.booleans())
def test_int8_compress_matches_jax(values, exponent, with_residual):
    x = (np.asarray(values, np.float64) * 2.0 ** exponent).astype(
        np.float32)
    res = (np.roll(x, 1) * 0.01).astype(np.float32) if with_residual \
        else None
    q, scale, r = gc.int8_compress(
        torch.from_numpy(x), None if res is None else torch.from_numpy(res))
    jq, jscale, jr = jgc.int8_compress(
        jnp.asarray(x), None if res is None else jnp.asarray(res))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    xr = x if res is None else x + res
    _within_one_ulp(r.numpy(), np.asarray(jr), xr)
    np.testing.assert_array_equal(
        gc.int8_decompress(q, scale).numpy(),
        np.asarray(jgc.int8_decompress(jq, jscale)))


def test_grad_compression_error_feedback():
    """The mirror of the JAX package's test: 50 rounds of one gradient
    with the residual fed back dequantise to it within 2%."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=128).astype(np.float32) * 0.1)
    res = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        q, scale, res = gc.int8_compress(g_true, res)
        acc += gc.int8_decompress(q, scale)
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(),
                               rtol=0.02, atol=1e-4)


def test_compressed_psum_matches_jax_on_one_rank(one_rank):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 33)).astype(np.float32)
    res = (rng.normal(size=(7, 33)) * 1e-3).astype(np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    jfn = shard_map(lambda a, r: jgc.compressed_psum(a, "data", r),
                    mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                    check_rep=False)
    jvalue, jres = jfn(jnp.asarray(x), jnp.asarray(res))
    value, new_res = gc.compressed_psum(torch.from_numpy(x), None,
                                        torch.from_numpy(res))
    assert value.dtype == torch.float32
    np.testing.assert_array_equal(value.numpy(), np.asarray(jvalue))
    _within_one_ulp(new_res.numpy(), np.asarray(jres), x + res)
    # one rank: the dequantised value of its own q
    q, scale, _ = gc.int8_compress(torch.from_numpy(x),
                                   torch.from_numpy(res))
    assert torch.equal(value, gc.int8_decompress(q, scale))


def _linear_problem():
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(4, 1)).astype(np.float32)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = x @ np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return w0, x, y


@pytest.mark.parametrize("compress", [True, False])
def test_make_ddp_step_matches_jax(one_rank, compress):
    """The JAX package's test (`tests/test_training.py`): 60 steps of a
    linear least-squares model on a (1,) mesh, lr 0.1: the losses and
    the weights within `DDP_RTOL` and `DDP_ATOL`."""
    w0, x, y = _linear_problem()
    jstep = jax.jit(jgc.make_ddp_step(
        lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
        jax.make_mesh((1,), ("data",)), lr=0.1, compress=compress))
    jparams = {"w": jnp.asarray(w0)}
    jres = jax.tree.map(jnp.zeros_like, jparams)
    params = {"w": torch.from_numpy(w0.copy())}
    res = {"w": torch.zeros_like(params["w"])}
    step = gc.make_ddp_step(workers.linear_loss, None, lr=0.1,
                            compress=compress)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    losses, jlosses = [], []
    for _ in range(60):
        params, res, loss = step(params, res, batch)
        jparams, jres, jloss = jstep(jparams, jres,
                                     {"x": jnp.asarray(x),
                                      "y": jnp.asarray(y)})
        losses.append(float(loss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=DDP_RTOL,
                               atol=DDP_ATOL)
    assert losses[-1] < 0.05 * losses[0]
    np.testing.assert_allclose(params["w"].detach().numpy(),
                               np.asarray(jparams["w"]), rtol=DDP_RTOL,
                               atol=1e-6)


def test_compressed_psum_on_two_ranks(tmp_path):
    """Σ q_i · max s_i / n, each rank's q and s from `int8_compress` of
    its own values, summed and scaled in NumPy: the same bits."""
    got = workers.spawn_ranks("compressed_psum_body", 2,
                              str(tmp_path / "store"), n=257, seed=5)
    qs, scales = [], []
    for r in got:
        q, s, res = gc.int8_compress(torch.from_numpy(r["x"]))
        qs.append(q.numpy().astype(np.int32))
        scales.append(np.float32(s))
        np.testing.assert_array_equal(r["residual"], res.numpy())
    assert scales[0] != scales[1]
    want = (np.sum(qs, axis=0).astype(np.float32) * max(scales)) \
        / np.float32(2)
    for r in got:
        np.testing.assert_array_equal(r["value"], want.astype(np.float32))


def test_ddp_step_on_two_halves_matches_one_rank(tmp_path, one_rank):
    """The uncompressed step on two ranks, each with half the batch,
    against one rank with the whole batch: the mean of the halves' mean
    gradients is the whole batch's, up to f32 rounding."""
    w0, x, y = _linear_problem()
    got = workers.spawn_ranks("ddp_body", 2, str(tmp_path / "store"),
                              x=x, y=y, w0=w0, steps=10, compress=False)
    want = workers.ddp_body(0, 1, torch.device("cpu"), x, y, w0, 10, False)
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-6)
        np.testing.assert_allclose(r["w"], want["w"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[0]["w"], got[1]["w"])
