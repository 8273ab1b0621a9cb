"""The port's sharding rules, meshes and pipeline schedule against the JAX
package's, on the CPU.

Held here:

  * `resolve_spec` and `points_axis` against the JAX functions on the same
    layouts, the port's `AbstractMesh` beside jax 0.9's
    `jax.sharding.AbstractMesh(axis_sizes, axis_names)`: the five cases of
    `tests/test_sharding.py` (written for an older signature) and a
    Hypothesis property over logical axes, shapes, meshes and rule tables;
    the specs equal entry for entry;
  * `sharding_for`'s DTensor placements: a dimension split over ("pod",
    "data") in the mesh's major-to-minor order, another order refused;
    `shard` the identity without a mesh and on a one-device mesh, and a
    plain tensor under a larger mesh refused;
  * `make_production_mesh` refusing a world of one rank (naming the 256 or
    512 it needs), the abstract production meshes, `make_host_mesh`;
  * `pipeline_apply` on one stage against the JAX package's
    `tests/test_pipeline.py` case (within rtol 1e-6: the same f32
    products in another library), and on two spawned gloo ranks
    (`tests/_torch_dist_workers.py`, whose processes import no JAX)
    against the two stages applied in sequence, bit for bit; in the same
    ranks `shard` lays a replicated DTensor out by ("batch", "embed") on a
    ("data",) mesh of two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh as JaxAbstractMesh

import _torch_dist_workers as workers
from repro.distributed import sharding as jsharding
from repro.distributed.pipeline import pipeline_apply as jax_pipeline_apply
from repro_torch.distributed import sharding
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch import mesh as mesh_mod

POD = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def _both(layout):
    return sharding.AbstractMesh(*layout), JaxAbstractMesh(*layout)


def _jax_spec(spec) -> tuple:
    return tuple(spec)


@pytest.fixture(scope="module")
def host_mesh():
    """`make_host_mesh`'s one-rank gloo group for the module's in-process
    tests, destroyed after them."""
    if dist.is_initialized():
        pytest.fail("a default process group is already initialized")
    mesh = mesh_mod.make_host_mesh()
    yield mesh
    dist.destroy_process_group()


# The five cases of tests/test_sharding.py: (axes, shape, layout, want).
SHARDING_CASES = [
    (("batch", "seq", "embed"), (256, 4096, 2048), POD,
     ("data", None, None)),
    (("batch", "seq", "embed"), (256, 4096, 2048), MULTI,
     (("pod", "data"), None, None)),
    # kv_heads=1 cannot shard on model=16 => replicated
    (("batch", "seq_kv", "kv_heads", None), (128, 32768, 1, 128), POD,
     ("data", "model", None, None)),
    # odd vocab falls back to replicated
    (("vocab", "embed"), (504, 1280), POD, (None, None)),
    # seq_kv grabs "model" first; kv_heads then cannot reuse it
    (("batch", "seq_kv", "kv_heads", None), (128, 32768, 16, 128), POD,
     ("data", "model", None, None)),
    # batch=2 divides pod(2) but not pod*data(32) => prefix ("pod",)
    (("batch", "seq"), (2, 64), MULTI, ("pod", None)),
]


@pytest.mark.parametrize("axes, shape, layout, want", SHARDING_CASES)
def test_resolve_spec_matches_jax(axes, shape, layout, want):
    ours, theirs = _both(layout)
    got = sharding.resolve_spec(axes, shape, ours)
    assert got == want
    assert got == _jax_spec(jsharding.resolve_spec(axes, shape, theirs))


AXIS_NAMES = ("pod", "data", "model", "stage")
LOGICAL = sorted(sharding.DEFAULT_RULES) + [None]
SIZES = (1, 2, 3, 4, 16)


@settings(deadline=None, max_examples=150, derandomize=True)
@given(st.lists(st.integers(0, len(AXIS_NAMES) - 1), min_size=1,
                max_size=3),
       st.lists(st.integers(0, len(SIZES) - 1), min_size=3, max_size=3),
       st.lists(st.integers(0, len(LOGICAL) - 1), min_size=1, max_size=5),
       st.lists(st.integers(0, 8), min_size=5, max_size=5),
       st.integers(1, 4096), st.booleans())
def test_resolve_spec_and_points_axis_property(mesh_axes, mesh_sizes,
                                               logical, exps, n, swap):
    """Random meshes (up to three distinct axes), logical axes and dims
    (powers of two times 1 or 3), optionally a rule table that swaps
    "batch" onto ("data", "pod"): the port's spec and `points_axis` equal
    the JAX package's."""
    names = tuple(dict.fromkeys(AXIS_NAMES[i] for i in mesh_axes))
    layout = (tuple(SIZES[mesh_sizes[i]] for i in range(len(names))),
              names)
    axes = tuple(LOGICAL[i] for i in logical)
    shape = tuple((3 if e % 2 else 1) * 2 ** e for e in exps[:len(axes)])
    rules = {"batch": ("data", "pod"), "points": "data"} if swap else {}
    ours, theirs = _both(layout)
    with sharding.use_rules(rules), jsharding.use_rules(rules):
        got = sharding.resolve_spec(axes, shape, ours)
        assert got == _jax_spec(jsharding.resolve_spec(axes, shape, theirs))
        for count in (None, n):
            assert sharding.points_axis(ours, count) == \
                jsharding.points_axis(theirs, count)


def test_points_axis_matches_jax():
    for layout in (POD, MULTI, ((1,), ("data",)), ((4,), ("model",))):
        ours, theirs = _both(layout)
        for n in (None, 1, 2, 16, 32, 48, 311_029):
            assert sharding.points_axis(ours, n) == \
                jsharding.points_axis(theirs, n), (layout, n)


def test_no_mesh_and_rules_context():
    assert sharding.current_mesh() is None
    assert sharding.resolve_spec(("batch",), (8,)) == ()
    assert sharding.sharding_for((8,), ("batch",)) is None
    ours = sharding.AbstractMesh(*POD)
    with sharding.use_mesh(ours), sharding.use_rules({"seq": "model"}):
        assert sharding.current_mesh() is ours
        assert sharding.current_rules()["seq"] == "model"
        assert sharding.resolve_spec(("batch", "seq"), (32, 64)) == \
            ("data", "model")
    assert sharding.current_rules() is sharding.DEFAULT_RULES
    assert sharding.current_mesh() is None


def test_sharding_for_placements():
    from torch.distributed.tensor import Replicate, Shard

    multi = sharding.AbstractMesh(*MULTI)
    got = sharding.sharding_for((256, 4096, 2048), ("batch", "seq", "mlp"),
                                multi)
    # the batch split over pod (major) then data (minor), mlp over model
    assert got == (Shard(0), Shard(0), Shard(2))
    got = sharding.sharding_for((3, 64), ("batch", "seq"), multi)
    assert got == (Replicate(), Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.sharding_for((256, 8), ("batch", None), multi,
                              rules={"batch": ("data", "pod")})


def test_shard_identity_and_refusal():
    x = torch.arange(12.0).reshape(4, 3)
    assert sharding.shard(x, ("batch", "embed")) is x
    with sharding.use_mesh(mesh_mod.abstract_host_mesh()):
        assert sharding.shard(x, ("batch", "embed")) is x
    with sharding.use_mesh(mesh_mod.abstract_production_mesh()):
        with pytest.raises(TypeError, match="plain tensor"):
            sharding.shard(x, ("batch", "embed"))


@pytest.mark.parametrize("multi_pod, ranks", [(False, 256), (True, 512)])
def test_production_meshes(multi_pod, ranks):
    abstract = mesh_mod.abstract_production_mesh(multi_pod=multi_pod)
    want = MULTI if multi_pod else POD
    assert (abstract.shape, abstract.mesh_dim_names) == want
    assert abstract.size() == ranks
    with pytest.raises(RuntimeError, match=f"{ranks} ranks"):
        mesh_mod.make_production_mesh(multi_pod=multi_pod)


def test_host_mesh(host_mesh):
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)
    assert host_mesh.device_type == "cpu"
    assert sharding.mesh_axes(host_mesh) == {"data": 1, "model": 1}
    assert sharding.resolve_spec(("batch", "mlp"), (8, 16), host_mesh) == \
        (None, None)
    assert sharding.sharding_for((8, 16), ("batch", "mlp"), host_mesh) == \
        sharding.sharding_for((8, 16), ("batch", "mlp"),
                              mesh_mod.abstract_host_mesh())


def test_single_stage_pipeline_matches_jax(host_mesh):
    """The JAX package's `tests/test_pipeline.py` case: one stage, four
    microbatches of tanh(x @ w)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(1, 8, 8)).astype(np.float32)      # (S, d, d)
    x = rng.normal(size=(4, 2, 8)).astype(np.float32)      # (M, B, d)
    jout = jax_pipeline_apply(lambda p, a: jnp.tanh(a @ p), jnp.asarray(w),
                              jnp.asarray(x), jax.make_mesh((1,),
                                                            ("stage",)))
    out = pipeline_apply(workers.tanh_stage, torch.from_numpy(w),
                         torch.from_numpy(x), host_mesh, axis="data")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)
    want = torch.tanh(torch.from_numpy(x) @ torch.from_numpy(w[0]))
    assert torch.equal(out, want)


def test_two_stage_pipeline_and_shard_on_two_ranks(tmp_path):
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(2, 8, 8)) / 3).astype(np.float32)
    x = rng.normal(size=(5, 3, 8)).astype(np.float32)
    got = workers.spawn_ranks("pipeline_body", 2, str(tmp_path / "store"),
                              w=w, x=x)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    want = torch.tanh(torch.tanh(tx @ tw[0]) @ tw[1]).numpy()
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["out"], want)
        assert r["placements"] == ["S(0)"]
        np.testing.assert_array_equal(r["local"],
                                      full[4 * rank:4 * rank + 4])
