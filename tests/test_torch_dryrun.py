"""The port's dry run (`repro_torch.launch.dryrun`) and its helpers against
the JAX package's, on the CPU.

Held here:

  * `cell_is_supported` equals the JAX function for every arch and shape,
    reasons included, with and without the clustered KV cache;
  * `make_batch_axes` and `make_cache_axes` equal the JAX trees for every
    arch, `cluster_kv` on and off;
  * `param_shardings` and `zero_shardings` give the JAX functions' partition
    specs leaf by leaf for every full-size arch on the pod and multipod
    layouts (jax 0.9's `jax.sharding.AbstractMesh` on the JAX side);
  * `training_policy` is the JAX driver's (`src/repro/launch/dryrun.py`,
    lines 84-108) for every arch on both meshes;
  * a reduced cell's `meta` operation count equals FlopCounterMode's count
    of the same step on real CPU tensors (attention left out of the CPU
    count, where the plain version's chunked scan does other work), and the
    attention kernel's counted operations equal the closed form;
  * a reduced cell's per-device bytes equal the arithmetic of its specs;
  * every kernel wrapper refuses `meta` outside `ops.counting_on_meta`, and
    inside it the attention wrappers take `meta` only;
  * `run_cell` writes OK and SKIP records, and the command imports no JAX
    and sets no XLA flag.

The reference dry run itself is never imported: it forces 512 host devices
through `XLA_FLAGS` when imported.
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
from repro.models import model as jmodel
from repro.models import params as jparams
from repro_torch import configs
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.models.params import (init_params, param_shardings,
                                       spec_leaves, zero_shardings)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUTS = {"pod": ((16, 16), ("data", "model")),
           "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = configs.ARCH_IDS


# -- the helpers against the JAX package's -----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cell_is_supported_matches_jax(arch):
    for cluster_kv in (False, True):
        cfg = dataclasses.replace(configs.get_config(arch),
                                  cluster_kv=cluster_kv)
        jcfg = dataclasses.replace(jconfigs.get_config(arch),
                                   cluster_kv=cluster_kv)
        for name in configs.SHAPES:
            assert configs.cell_is_supported(cfg, configs.SHAPES[name]) == \
                jconfigs.cell_is_supported(jcfg, jconfigs.SHAPES[name])


def test_mesh_config_matches_jax():
    assert dataclasses.asdict(configs.MeshConfig()) == \
        dataclasses.asdict(jconfigs.MeshConfig())
    assert configs.MeshConfig((2, 16, 16), ("pod", "data", "model")) \
        .num_devices == 512


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_axes_match_jax(arch):
    for cluster_kv in (False, True):
        cfg = dataclasses.replace(configs.get_config(arch),
                                  cluster_kv=cluster_kv)
        jcfg = dataclasses.replace(jconfigs.get_config(arch),
                                   cluster_kv=cluster_kv)
        for name in configs.SHAPES:
            assert M.make_batch_axes(cfg, configs.SHAPES[name]) == \
                jmodel.make_batch_axes(jcfg, jconfigs.SHAPES[name])
        assert M.make_cache_axes(cfg) == jmodel.make_cache_axes(jcfg)


def _jax_specs(tree) -> dict:
    """{path: PartitionSpec as a tuple} of a JAX NamedSharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(k.key for k in path): tuple(s.spec)
            for path, s in flat}


def _padded(spec: tuple, rank: int) -> tuple:
    return tuple(spec) + (None,) * (rank - len(spec))


@pytest.mark.parametrize("mesh_name", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero_shardings_match_jax(arch, mesh_name):
    layout = LAYOUTS[mesh_name]
    mesh, jmesh = AbstractMesh(*layout), JaxAbstractMesh(*layout)
    specs = M.param_specs(configs.get_config(arch))
    jspecs = jmodel.param_specs(jconfigs.get_config(arch))
    rank = {path: len(leaf.shape) for path, leaf in spec_leaves(specs)}
    for mine, theirs in (
            (param_shardings(specs, mesh),
             jparams.param_shardings(jspecs, jmesh)),
            (zero_shardings(specs, mesh),
             jparams.zero_shardings(jspecs, jmesh))):
        mine = dict(spec_leaves(mine))
        theirs = _jax_specs(theirs)
        assert sorted(mine) == sorted(theirs)
        for path in mine:
            assert _padded(mine[path], rank[path]) == \
                _padded(theirs[path], rank[path]), path


def test_zero_shardings_put_dp_on_the_largest_free_dimension():
    """Hand-reckoned cases of the ZeRO rule: the DP axes go on the largest
    still-replicated dimension they divide, the minor axis dropped first."""
    from repro_torch.models.params import ParamSpec

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    specs = {"a": ParamSpec((4096, 1024), ("embed", "mlp")),
             "b": ParamSpec((96, 2048), ("embed", "mlp")),
             "c": ParamSpec((2, 30), (None, None)),
             "d": ParamSpec((7,), (None,))}
    got = zero_shardings(specs, mesh)
    assert got["a"] == (("pod", "data"), "model")
    assert got["b"] == (("pod", "data"), "model")
    # 30 is the larger dimension: 32 does not divide it, "pod" does
    assert got["c"] == (None, "pod")
    assert got["d"] == (None,)


def _jax_policy(arch, mesh_name) -> dict:
    """`src/repro/launch/dryrun.py` lines 84-108, transcribed over the JAX
    package's own config and mesh shape."""
    jcfg = jconfigs.get_config(arch)
    shape = dict(zip(LAYOUTS[mesh_name][1], LAYOUTS[mesh_name][0]))
    mb, fsdp, opt_dtype = 8, False, "float32"
    if jcfg.d_model >= 8192:
        mb, fsdp = 16, True
    if jcfg.param_count() > 3.0e10:
        fsdp = True
    if jcfg.param_count() > 2.0e11:
        opt_dtype = "bfloat16"
    if jcfg.d_model <= 2048 and not jcfg.num_experts:
        mb = 2
    dp = 1
    for ax in ("pod", "data"):
        dp *= shape.get(ax, 1)
    while mb > 1 and (jconfigs.SHAPES["train_4k"].global_batch // mb) % dp:
        mb //= 2
    return {"microbatches": mb, "fsdp": fsdp, "opt_dtype": opt_dtype,
            "remat": "block"}


@pytest.mark.parametrize("arch", ARCHS)
def test_training_policy_matches_the_jax_dry_run(arch):
    for mesh_name, layout in LAYOUTS.items():
        got = dryrun.training_policy(configs.get_config(arch),
                                     configs.SHAPES["train_4k"],
                                     AbstractMesh(*layout))
        got["opt_dtype"] = str(got["opt_dtype"]).removeprefix("torch.")
        assert got == _jax_policy(arch, mesh_name)
    # the table's corners, by hand
    pod = AbstractMesh(*LAYOUTS["pod"])
    policy = dryrun.training_policy(configs.get_config(arch),
                                    configs.SHAPES["train_4k"], pod)
    if arch == "olmo-1b":
        assert (policy["microbatches"], policy["fsdp"]) == (2, False)
    if arch == "jamba-1.5-large-398b":
        assert policy["opt_dtype"] == torch.bfloat16 and policy["fsdp"]
    if arch == "qwen1.5-110b":
        assert (policy["microbatches"], policy["fsdp"]) == (16, True)


def test_variant_opt_takes_the_jax_changes():
    cfg = dryrun.variant_config(configs.get_config("yi-9b"), "decode_32k",
                                "opt")
    assert cfg.cluster_kv and cfg.attn_repeat_kv
    cfg = dryrun.variant_config(configs.get_config("jamba-1.5-large-398b"),
                                "train_4k", "opt")
    assert cfg.moe_dispatch == "two_stage" and cfg.mamba_lowp_scan
    assert not cfg.cluster_kv
    assert dryrun.variant_config(configs.get_config("olmo-1b"), "train_4k",
                                 "base") == configs.get_config("olmo-1b")


# -- operations ----------------------------------------------------------------

class _HiddenAttention(torch.autograd.Function):
    """The plain attention with its forward and backward out of sight of
    every dispatch mode, so a FlopCounterMode count leaves it out."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, prefix_len):
        with _disable_current_modes():
            out = ref.attention_bshd_ref(q, k, v, scale=scale, causal=causal,
                                         prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        scale, causal, prefix_len = ctx.args
        with _disable_current_modes(), torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.attention_bshd_ref(*leaves, scale=scale, causal=causal,
                                         prefix_len=prefix_len)
            grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None, None, None)


def _hidden_attention(q, k, v, *, scale, causal, prefix_len=0):
    return _HiddenAttention.apply(q, k, v, scale, causal, prefix_len)


def _cpu_inputs(cfg):
    gen = torch.Generator().manual_seed(0)

    def make(tree):
        def leaf(spec):
            if spec.dtype.is_floating_point:
                return torch.randn(spec.shape, generator=gen).to(spec.dtype)
            if spec.dtype == torch.bool or not spec.shape:
                return torch.zeros(spec.shape, dtype=spec.dtype)
            return torch.randint(0, cfg.vocab_size, spec.shape,
                                 generator=gen, dtype=spec.dtype)
        return {k: make(v) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}
    return make


COUNT_CELLS = [
    ("olmo-1b", "train", 64), ("olmo-1b", "prefill", 64),
    ("olmo-1b", "decode", 64), ("jamba-1.5-large-398b", "train", 64),
    ("jamba-1.5-large-398b", "prefill", 128), ("rwkv6-3b", "train", 64),
    ("rwkv6-3b", "prefill", 64), ("deepseek-v2-lite-16b", "train", 64),
    ("qwen2-moe-a2.7b", "train", 64), ("paligemma-3b", "train", 64),
]


@pytest.mark.parametrize("arch, kind, seq", COUNT_CELLS)
def test_meta_count_matches_the_cpu_count(arch, kind, seq, monkeypatch):
    """The dry run's `meta` count of a reduced cell equals FlopCounterMode
    over the same step on real CPU tensors, attention apart; the attention
    kernel's count is the closed form of its launches."""
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    shape = configs.ShapeConfig("cell", seq, 2, kind)
    counted = dryrun.count_operations(cfg, shape)

    monkeypatch.setattr(ops, "attention_bshd", _hidden_attention)
    params = init_params(M.param_specs(cfg), torch.Generator(),
                         torch.float32, "cpu")
    fn, _ = dryrun.step_function(cfg, shape, 2, _cpu_inputs(cfg))
    with FlopCounterMode(display=False) as counter:
        fn(params)
    assert counted["aten"] == counter.get_total_flops() > 0

    att = counted["attention"]
    fwd, bwd = att["flash_attention"], att["flash_attention_bwd"]
    if cfg.default_block == "rwkv6" or kind == "decode":
        assert fwd["launches"] == bwd["launches"] == 0
        return
    attn = [cfg.block_type(l) == "attn" for l in range(cfg.num_layers)]
    # remat "block" runs each grouped layer's forward again in the
    # backward; the leading dense layers are not checkpointed
    again = sum(attn[cfg.first_k_dense:]) if kind == "train" else 0
    assert fwd["launches"] == sum(attn) + again
    assert bwd["launches"] == (sum(attn) if kind == "train" else 0)
    d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    dv = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    pairs = ops.attention_pairs(seq, cfg.causal, cfg.prefix_len)
    heads = 2 * cfg.num_heads
    assert fwd["operations"] == fwd["launches"] * 2 * (d + dv) * pairs * heads
    assert bwd["operations"] == bwd["launches"] * 2 * (3 * d + 2 * dv) * \
        pairs * heads
    assert counted["total"] == counted["aten"] + fwd["operations"] + \
        bwd["operations"]


@pytest.mark.parametrize("b, s, h, hk, d, dv, causal, prefix", [
    (2, 64, 4, 2, 32, 32, True, 0),
    (1, 80, 2, 2, 16, 16, False, 0),
    (2, 48, 4, 4, 24, 16, True, 0),
    (1, 64, 2, 1, 32, 32, True, 8),
])
def test_attention_counts_equal_the_closed_form(b, s, h, hk, d, dv, causal,
                                                prefix):
    q = torch.empty((b, s, h, d), device="meta", requires_grad=True)
    k = torch.empty((b, s, hk, d), device="meta", requires_grad=True)
    v = torch.empty((b, s, hk, dv), device="meta", requires_grad=True)
    with ops.counting_on_meta() as counts:
        out = ops.attention_bshd(q, k, v, scale=0.1, causal=causal,
                                 prefix_len=prefix)
        assert out.shape == (b, s, h, dv) and out.device.type == "meta"
        assert out.dtype == torch.float32
        dq, dk, dv_ = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv_.shape) == (q.shape, k.shape, v.shape)
    if causal:
        pairs = s * (s + 1) // 2 + prefix * (prefix - 1) // 2
        if not prefix:
            # the forward's S (S + 1) (D + Dv) a head
            assert 2 * pairs * (d + dv) == s * (s + 1) * (d + dv)
    else:
        pairs = s * s
    assert counts["flash_attention"] == {
        "launches": 1, "operations": 2 * pairs * (d + dv) * b * h}
    assert counts["flash_attention_bwd"] == {
        "launches": 1, "operations": 2 * pairs * (3 * d + 2 * dv) * b * h}
    # the TPU kernel's signature, without gradients
    with ops.counting_on_meta() as counts:
        flat = ops.flash_attention(q[:, :, 0].detach(), k[:, :, 0].detach(),
                                   v[:, :, 0].detach(), scale=0.1,
                                   causal=causal)
    assert flat.shape == (b, s, dv)
    assert counts["flash_attention"]["launches"] == 1
    assert counts["flash_attention_bwd"]["launches"] == 0


def test_wrappers_refuse_meta_outside_the_counting_context():
    q = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.attention_bshd(q, q, q, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q[:, :, 0], q[:, :, 0], q[:, :, 0], scale=1.0)
    x = torch.empty((8, 4), device="meta")
    w = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.pairwise_argmin(x, x[:2])
    with pytest.raises(ValueError, match="no kernel"):
        ops.d2_update(x, x[0], w)
    with ops.counting_on_meta():
        # inside the context only the attention wrappers take meta, and
        # they take nothing else
        with pytest.raises(ValueError, match="no kernel"):
            ops.d2_update(x, x[0], w)
        with pytest.raises(ValueError, match="meta tensors only"):
            ops.attention_bshd(torch.zeros((1, 16, 2, 8)), q, q, scale=1.0,
                               causal=True)
        with pytest.raises(RuntimeError, match="nest"):
            with ops.counting_on_meta():
                pass
    # the context is closed again
    with pytest.raises(ValueError, match="no kernel"):
        ops.attention_bshd(q, q, q, scale=1.0, causal=True)
    assert ops.launch_counts()["flash_attention"] == 0


# -- bytes ----------------------------------------------------------------------

def test_reduced_cell_bytes_equal_the_spec_arithmetic():
    cfg = configs.reduce_for_smoke(configs.get_config("olmo-1b"))
    shape = configs.ShapeConfig("cell", 64, 8, "train")
    mesh = AbstractMesh((2, 4), ("data", "model"))
    sizes = {"data": 2, "model": 4}
    policy = dryrun.training_policy(cfg, shape, mesh)
    assert policy == {"microbatches": 2, "fsdp": False,
                      "opt_dtype": torch.float32, "remat": "block"}
    got = dryrun.device_bytes(cfg, shape, mesh, policy)

    def split(spec):
        n = 1
        for entry in spec:
            for ax in (() if entry is None else (entry,)
                       if isinstance(entry, str) else entry):
                n *= sizes[ax]
        return n

    specs = M.param_specs(cfg)
    layout = dict(spec_leaves(param_shardings(specs, mesh)))
    zero = dict(spec_leaves(zero_shardings(specs, mesh)))
    leaves = list(spec_leaves(specs))
    assert got["params"] == sum(math.prod(p.shape) * 4 // split(layout[k])
                                for k, p in leaves)
    assert got["moments"] == 2 * sum(math.prod(p.shape) * 4 // split(zero[k])
                                     for k, p in leaves)
    assert got["grads"] == got["moments"] // 2
    # tokens (8, 64) int32, rows over "data"
    assert got["batch"] == 8 * 64 * 4 // 2
    # by hand: the (512, 128) embedding, vocab over "model"
    assert layout["embed/tokens"] == ("model", None)

    decode = dryrun.device_bytes(cfg, configs.ShapeConfig("d", 64, 8,
                                                          "decode"), mesh)
    # k and v (layers, 8, 64, 2, 32) f32, rows over "data", seq over
    # "model"; the index once; tokens (8,) int32 over "data"
    assert decode["cache"] == 2 * cfg.num_layers * 8 * 64 * 2 * 32 * 4 \
        // 8 + 8
    assert decode["batch"] == 8 * 4 // 2


def test_run_cell_records(tmp_path):
    rec = dryrun.run_cell("olmo-1b", "long_500k", "pod", out_dir=tmp_path)
    jcfg = jconfigs.get_config("olmo-1b")
    ok, why = jconfigs.cell_is_supported(jcfg, jconfigs.SHAPES["long_500k"])
    assert not ok and rec["status"] == "SKIP" and rec["reason"] == why
    rec = dryrun.run_cell("hubert-xlarge", "prefill_32k", "multipod",
                          out_dir=tmp_path)
    assert rec["status"] == "OK", rec.get("error")
    assert rec["num_devices"] == 512
    assert rec["operations"]["per_device"] == rec["operations"]["total"] / 512
    assert rec["operations"]["attention"]["flash_attention"]["launches"] == \
        configs.get_config("hubert-xlarge").num_layers
    nbytes = rec["bytes_per_device"]
    assert nbytes["total"] == nbytes["params"] + nbytes["batch"]
    assert list(rec["cannot_record"]) == list(dryrun.CANNOT_RECORD)
    on_disk = json.loads(
        (tmp_path / "hubert-xlarge__prefill_32k__multipod.json").read_text())
    assert on_disk["status"] == "OK"
    assert "SKIP" in dryrun.summary_line(
        dryrun.run_cell("olmo-1b", "long_500k", "pod", out_dir=tmp_path))


def test_the_command_imports_no_jax_and_sets_no_xla_flag(tmp_path):
    code = (
        "import os, sys\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.RECORDS = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "rc = dryrun.main(['--arch', 'hubert-xlarge', '--shape',"
        " 'decode_32k', '--mesh', 'both'])\n"
        "print(rc, sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith(('jax.', 'jaxlib')) or n == 'repro'"
        " or n.startswith('repro.')), 'XLA_FLAGS' in os.environ)\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env, cwd=tmp_path)
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "0 [] False"
    assert sum("SKIP" in line for line in lines) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "hubert-xlarge__decode_32k__multipod.json",
        "hubert-xlarge__decode_32k__pod.json"]
