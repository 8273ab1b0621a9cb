"""Multi-pod dry run: count every (arch x shape x mesh) cell without a card.

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \
        --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh both] \
        [--variant opt] [--force]

The counterpart of the JAX package's `launch/dryrun.py`, with its cells,
its skip reasons (`configs.cell_is_supported`), its variant "opt" and its
training memory policy.  That driver lowers and compiles each cell through
XLA against 256 or 512 forced host devices.  The port has no SPMD compiler,
so for each cell it records what the step's shapes and the layouts' rules
fix:

  - the step's operations: `torch.utils.flop_counter.FlopCounterMode` over
    the port's own step on `meta` tensors (a forward for prefill and
    decode; for train one microbatch's forward and backward under remat
    "block", recompute included, times the microbatches), plus the flash
    attention kernel's own operations, which `kernels.ops.counting_on_meta`
    counts where the kernel would launch;
  - each device's bytes of parameters, optimizer moments, gradients and the
    batch (and the decode cache), from the layouts that
    `distributed.sharding.resolve_spec`, `models.params.param_shardings`
    and `models.params.zero_shardings` give on
    `launch.mesh.abstract_production_mesh`;
  - the activations one microbatch saves for the backward, summed over
    `torch.autograd.graph.saved_tensors_hooks` (each storage once, the
    parameters left out) and split by the batch axes' mesh size.

Parameters and inputs are `meta` tensors, so nothing is allocated; no
XLA flag is set and nothing of JAX is imported.  The operations depend on
the (arch, shape, variant) and, for train, on the microbatch's rows (the
mesh's DP extent can halve the microbatches; MoE capacity rounds per
window, so a count is not rescaled); each is counted once a process, and
the other mesh changes only the bytes.  Every record also lists what only a compiled SPMD
program shows (``cannot_record``).  Records go to
``build/dryrun/<arch>__<shape>__<mesh>[__opt].json`` below the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_supported, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import mesh_axes, resolve_spec
from repro_torch.kernels import ops
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.models import mamba, rwkv6, transformer
from repro_torch.models import model as M
from repro_torch.models.params import (TensorSpec, abstract_params,
                                       param_shardings, spec_leaves,
                                       tree_map, zero_shardings)

__all__ = ["RECORDS", "CANNOT_RECORD", "variant_config", "training_policy",
           "step_function", "count_operations", "device_bytes",
           "batch_split", "run_cell", "main"]

RECORDS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

CANNOT_RECORD = (
    "the collectives XLA's SPMD partitioner inserts and their bytes",
    "XLA's buffer assignment: the peak after fusion and rematerialisation",
    "the while loops' trip counts",
    "how the operations split across devices (an even split is assumed)",
)

FSDP_PARAMS = 3.0e10      # weights ZeRO-sharded above this many parameters
BF16_MOMENTS = 2.0e11     # moments in bf16 above this many


def variant_config(cfg: ModelConfig, shape_name: str,
                   variant: str) -> ModelConfig:
    """The cell's config: variant "opt" takes the JAX driver's changes
    (two-stage MoE dispatch, the low-precision Mamba scan, repeated KV
    heads, the clustered KV cache for long decode)."""
    if variant == "base":
        return cfg
    changes = {}
    if cfg.num_experts:
        changes["moe_dispatch"] = "two_stage"
    if cfg.default_block == "mamba" or cfg.attn_period > 1:
        changes["mamba_lowp_scan"] = True
    if cfg.has_attention and cfg.num_kv_heads and cfg.num_kv_heads < 16:
        changes["attn_repeat_kv"] = True
    if (shape_name in ("long_500k", "decode_32k") and cfg.has_attention
            and not cfg.use_mla and not cfg.is_encoder):
        changes["cluster_kv"] = True
    return dataclasses.replace(cfg, **changes) if changes else cfg


def training_policy(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The JAX driver's training memory policy: microbatches bound one
    microbatch's activations; FSDP (weights ZeRO-sharded over the DP
    axes) for a model of d_model >= 8192 or above `FSDP_PARAMS`; bf16
    moments above `BF16_MOMENTS`; two microbatches for small dense models;
    then halved until each microbatch's rows divide by the DP extent."""
    mb, fsdp, opt_dtype = 8, False, torch.float32
    n_params = cfg.param_count()
    if cfg.d_model >= 8192:
        mb, fsdp = 16, True
    if n_params > FSDP_PARAMS:
        fsdp = True
    if n_params > BF16_MOMENTS:
        opt_dtype = torch.bfloat16
    if cfg.d_model <= 2048 and not cfg.num_experts:
        mb = 2
    sizes = mesh_axes(mesh)
    dp = math.prod(sizes.get(ax, 1) for ax in ("pod", "data"))
    while mb > 1 and (shape.global_batch // mb) % dp:
        mb //= 2
    return {"microbatches": mb, "fsdp": fsdp, "opt_dtype": opt_dtype,
            "remat": "block"}


def _meta_inputs(spec_tree) -> dict:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def _mamba_states_on_meta(inp, decay, h):
    # the recurrence is elementwise, no product that an operation count
    # reads, so one op of the states' shape stands in for the step loop
    return torch.addcmul(inp, decay, inp)


def _rwkv_inter_on_meta(r_dec, decay, kv):
    # the loop's products in two: chunk 0's against the zero state, the
    # rest against states of the stacked shape; the update is elementwise
    b, _, _, h, hd = r_dec.shape
    zero = r_dec.new_zeros((b, 1, h, hd, hd))
    return torch.cat([
        torch.einsum("bcihd,bchde->bcihe", r_dec[:, :1], zero),
        torch.einsum("bcihd,bchde->bcihe", r_dec[:, 1:],
                     (kv * decay)[:, 1:])], dim=1)


@contextlib.contextmanager
def _shape_only_scans():
    """Mamba's step loop and RWKV-6's chunk loop replaced by stand-ins of
    the same output shape and the same products: a Python loop a step or a
    chunk would make a long cell's count take minutes.  The stand-ins'
    values are not the scans'; `tests/test_torch_dryrun.py` holds their
    counts to the real loops' on CPU tensors."""
    saved = mamba._chunk_states, rwkv6._inter_chunk
    mamba._chunk_states = _mamba_states_on_meta
    rwkv6._inter_chunk = _rwkv_inter_on_meta
    try:
        yield
    finally:
        mamba._chunk_states, rwkv6._inter_chunk = saved


class _SavedBytes:
    """`saved_tensors_hooks` that add up the storages autograd keeps for
    the backward, each once, leaving out the parameters'."""

    def __init__(self, params: list):
        self.skip = {p.untyped_storage()._cdata for p in params}
        self.seen: set = set()
        self.total = 0

    def pack(self, t: torch.Tensor):
        storage = t.untyped_storage()
        key = storage._cdata
        if key not in self.skip and key not in self.seen:
            self.seen.add(key)
            self.total += storage.nbytes()
        return t

    @staticmethod
    def unpack(t: torch.Tensor):
        return t


def step_function(cfg: ModelConfig, shape: ShapeConfig, rows: int,
                  inputs=None, remat: str = "block"):
    """(fn, needs_grad): the cell's step on `rows` sequences as the port
    runs it, ``fn(params)``, train under `remat`; `inputs` makes the batch
    (or the decode tokens and cache) from a tree of `TensorSpec`s (`meta`
    zeros by default)."""
    inputs = inputs or _meta_inputs
    if shape.kind == "decode":
        cache = inputs(M.make_cache_specs(cfg, rows, shape.seq_len))
        tokens = inputs({"t": TensorSpec((rows,), torch.int32)})["t"]
        return (lambda params: M.decode_step(params, cfg, tokens, cache)), \
            False
    batch = inputs(M.make_batch_specs(
        cfg, dataclasses.replace(shape, global_batch=rows)))
    if shape.kind == "train":
        from repro_torch.training.train_step import make_grads_fn

        grads_fn = make_grads_fn(cfg, TrainConfig(microbatches=1,
                                                  remat=remat))
        return (lambda params: grads_fn(params, batch)), True
    layout = transformer.layer_layout(cfg)
    if all(bt == "attn" for bt, _ in layout.positions) \
            and not cfg.first_k_dense:
        from repro_torch.serving.prefill import prefill

        return (lambda params: prefill(params, cfg, batch)), False
    # hybrid and SSM stacks: the forward's logits, as the JAX driver
    return (lambda params: M.forward(params, cfg, batch)[0][:, -1, :]), False


def count_operations(cfg: ModelConfig, shape: ShapeConfig,
                     microbatches: int = 1, remat: str = "block") -> dict:
    """The operations of one step of the cell (all devices together): one
    microbatch of ``global_batch // microbatches`` rows counted on `meta`
    (train under `remat`), times `microbatches`.  ``aten`` is FlopCounterMode's count (the matrix
    products; elementwise work is not counted), ``attention`` the flash
    kernel's, forward and backward; ``saved_bytes`` one microbatch's
    saved activations (train only)."""
    from torch.utils.flop_counter import FlopCounterMode

    rows = shape.global_batch // microbatches
    params = abstract_params(M.param_specs(cfg), M.dtype_of(cfg.dtype))
    leaves = [t for _, t in spec_leaves(params)]
    fn, needs_grad = step_function(cfg, shape, rows, remat=remat)
    saved = _SavedBytes(leaves) if needs_grad else None
    t0 = time.perf_counter()
    with ops.counting_on_meta() as kernels, _shape_only_scans(), \
            FlopCounterMode(display=False) as counter:
        if saved is None:
            fn(params)
        else:
            with torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                          saved.unpack):
                fn(params)
    seconds = time.perf_counter() - t0
    aten = counter.get_total_flops() * microbatches
    attention = {name: {key: n * microbatches for key, n in entry.items()}
                 for name, entry in kernels.items()}
    total = aten + sum(e["operations"] for e in attention.values())
    return {"total": total, "aten": aten, "attention": attention,
            "microbatch_rows": rows, "microbatches": microbatches,
            "saved_bytes": None if saved is None else saved.total,
            "seconds": seconds}


def _split(entry, sizes: dict) -> int:
    """How many ways one spec entry splits its dimension."""
    if entry is None:
        return 1
    return math.prod(sizes[a] for a in
                     ((entry,) if isinstance(entry, str) else entry))


def _tree_bytes(shapes: dict, layouts: dict, mesh, itemsize=None) -> int:
    """Per-device bytes of a tree of `ParamSpec`s or `TensorSpec`s laid out
    by ``{path: spec tuple}`` on `mesh`; `itemsize` overrides the leaves'
    dtype."""
    sizes = mesh_axes(mesh)
    total = 0
    for path, leaf in spec_leaves(shapes):
        elem = itemsize or torch.empty((), dtype=leaf.dtype).element_size()
        split = math.prod(_split(e, sizes) for e in layouts[path])
        total += math.prod(leaf.shape) * elem // split
    return total


def _layouts(spec_tree: dict, axes_tree: dict, mesh) -> dict:
    """``{path: spec tuple}``: `resolve_spec` of each leaf of a tree of
    `TensorSpec`s by the logical axes tree beside it."""
    axes = dict(spec_leaves(axes_tree))
    return {path: resolve_spec(axes[path], leaf.shape, mesh)
            for path, leaf in spec_leaves(spec_tree)}


def device_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 policy: dict | None = None) -> dict:
    """Per-device bytes of the cell's state on `mesh`: parameters (in
    ``cfg.dtype``, laid out as the JAX driver lays them), and for train
    the two moments and the f32 gradients (ZeRO layouts) and the batch,
    for decode the tokens and the cache."""
    specs = M.param_specs(cfg)
    zsh = dict(spec_leaves(zero_shardings(specs, mesh)))
    fsdp = cfg.param_count() > FSDP_PARAMS or bool(policy and policy["fsdp"])
    psh = zsh if fsdp else dict(spec_leaves(param_shardings(specs, mesh)))
    elem = torch.empty((), dtype=M.dtype_of(cfg.dtype)).element_size()
    out = {"params": _tree_bytes(specs, psh, mesh, elem)}
    if shape.kind == "train":
        mom = torch.empty((), dtype=policy["opt_dtype"]).element_size()
        out["moments"] = 2 * _tree_bytes(specs, zsh, mesh, mom)
        out["grads"] = _tree_bytes(specs, zsh, mesh, 4)
    if shape.kind == "decode":
        tokens = {"tokens": TensorSpec((shape.global_batch,), torch.int32)}
        out["batch"] = _tree_bytes(tokens, _layouts(
            tokens, {"tokens": ("batch",)}, mesh), mesh)
        cache = M.make_cache_specs(cfg, shape.global_batch, shape.seq_len)
        out["cache"] = _tree_bytes(cache, _layouts(
            cache, M.make_cache_axes(cfg), mesh), mesh)
    else:
        batch = M.make_batch_specs(cfg, shape)
        out["batch"] = _tree_bytes(batch, _layouts(
            batch, M.make_batch_axes(cfg, shape), mesh), mesh)
    return out


def batch_split(rows: int, mesh) -> int:
    """How many ways the batch axes split `rows` sequences on `mesh`."""
    return _split(resolve_spec(("batch",), (rows,), mesh)[0],
                  mesh_axes(mesh))


# (arch, shape, variant, microbatches) -> count_operations's result, for
# this process
_COUNTS: dict = {}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             force: bool = False, variant: str = "base",
             out_dir: Path | None = None) -> dict:
    """One cell's record, written to ``<out_dir>/<tag>.json`` (`RECORDS`
    by default); an existing record is read back unless `force`."""
    out_dir = Path(out_dir) if out_dir is not None else RECORDS
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if variant != "base":
        tag += f"__{variant}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = variant_config(get_config(arch), shape_name, variant)
    shape = SHAPES[shape_name]
    ok, why = cell_is_supported(cfg, shape)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "variant": variant,
              "timestamp": time.time()}
    if not ok:
        record.update(status="SKIP", reason=why)
        out_path.write_text(json.dumps(record, indent=2))
        return record

    mesh = abstract_production_mesh(multi_pod=(mesh_name == "multipod"))
    t0 = time.perf_counter()
    try:
        policy = training_policy(cfg, shape, mesh) \
            if shape.kind == "train" else None
        mb = policy["microbatches"] if policy else 1
        key = (arch, shape_name, variant, mb)
        if key not in _COUNTS:
            _COUNTS[key] = count_operations(cfg, shape, mb)
        counted = _COUNTS[key]
        n_dev = mesh.size()
        nbytes = device_bytes(cfg, shape, mesh, policy)
        if counted["saved_bytes"] is not None:
            split = batch_split(counted["microbatch_rows"], mesh)
            nbytes["saved_activations"] = counted["saved_bytes"] // split
        nbytes["total"] = sum(nbytes.values())
        record.update(
            status="OK",
            seconds=time.perf_counter() - t0,
            count_seconds=counted["seconds"],
            num_devices=n_dev,
            policy=None if policy is None else
            {**policy, "opt_dtype": str(policy["opt_dtype"])[6:]},
            operations={
                "total": counted["total"],
                "per_device": counted["total"] / n_dev,
                "aten": counted["aten"],
                "attention": counted["attention"],
                "microbatches": counted["microbatches"],
                "microbatch_rows": counted["microbatch_rows"],
            },
            bytes_per_device=nbytes,
            cannot_record=list(CANNOT_RECORD),
        )
    except Exception:   # noqa: BLE001 — a failed cell is a record
        record.update(status="FAIL", seconds=time.perf_counter() - t0,
                      error=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(record, indent=2))
    return record


def summary_line(rec: dict) -> str:
    line = (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"{rec['status']:5s}")
    if rec["status"] == "OK":
        line += (f" count={rec['seconds']:7.1f}s"
                 f" flops/dev={rec['operations']['per_device']:.3e}"
                 f" bytes/dev={rec['bytes_per_device']['total'] / 2**30:6.1f}"
                 "GiB")
    elif rec["status"] == "SKIP":
        line += f" ({rec['reason'][:60]})"
    else:
        line += " " + rec["error"].splitlines()[-1][:90]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=tuple(SHAPES))
    p.add_argument("--mesh", choices=("pod", "multipod", "both"),
                   default="pod")
    p.add_argument("--variant", choices=("base", "opt"), default="base")
    p.add_argument("--all", action="store_true")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)

    failures = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                rec = run_cell(arch, shape, mesh, force=args.force,
                               variant=args.variant)
                failures += rec["status"] == "FAIL"
                print(summary_line(rec), flush=True)
    print(f"dry run: {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
