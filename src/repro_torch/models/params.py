"""Minimal functional parameter system: spec trees and parameter trees.

A model is described by a *spec tree*: nested dicts whose leaves are
`ParamSpec(shape, logical_axes, init, scale)`, as in the JAX package's
`models/params.py`.  From one spec tree come real parameters
(`init_params`, drawn on the device from a `torch.Generator`), abstract
ones (`abstract_params`, `meta` tensors that hold no memory, for the dry
run), their layouts on a mesh (`param_shardings`, and `zero_shardings`
for ZeRO-sharded state) and their size (`spec_bytes`);
`params_from_numpy` carries a JAX parameter tree across, key for key.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "ParamSpec",
    "TensorSpec",
    "init_params",
    "abstract_params",
    "param_shardings",
    "zero_shardings",
    "params_from_numpy",
    "spec_bytes",
    "spec_leaves",
    "tree_map",
    "tree_unflatten",
]


# (shape, dtype) of a cache leaf or an input: the port's
# `jax.ShapeDtypeStruct`.
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                     # logical axis names, len == len(shape)
    init: str = "normal"            # normal | zeros | ones
    scale: float = -1.0             # -1 => 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")

    @property
    def std(self) -> float:
        """The normal draw's scale: the spec's own, or 1/sqrt(fan_in) with
        fan_in the second-to-last dimension (the last for a vector), the
        JAX package's law."""
        if self.scale > 0:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def spec_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict in sorted key order, the order
    in which `jax.tree` flattens a dict; paths join keys with '/'."""
    for key in sorted(tree):
        node = tree[key]
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            yield from spec_leaves(node, path + "/")
        else:
            yield path, node


def tree_map(fn, tree):
    """`fn` over the leaves of a nested dict, keys kept."""
    return {key: tree_map(fn, node) if isinstance(node, dict) else fn(node)
            for key, node in tree.items()}


def tree_unflatten(tree: dict, leaves: list) -> dict:
    """A nested dict of `tree`'s keys holding `leaves` in `spec_leaves`
    order (sorted keys)."""
    it = iter(leaves)

    def rebuild(node: dict) -> dict:
        return {key: rebuild(node[key]) if isinstance(node[key], dict)
                else next(it) for key in sorted(node)}

    return rebuild(tree)


def init_params(specs, generator: torch.Generator, dtype: torch.dtype,
                device) -> dict:
    """Real parameters for a spec tree, drawn on `device` from `generator`
    (which must live on that device): normal times `ParamSpec.std`, ones
    or zeros where the spec says.  Draws are f32, then cast to `dtype`."""
    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        draw = torch.randn(spec.shape, generator=generator,
                           dtype=torch.float32, device=device)
        return draw.mul_(spec.std).to(dtype)

    return tree_map(make, specs)


def abstract_params(specs, dtype: torch.dtype = torch.bfloat16) -> dict:
    """`meta` tensors of the spec tree's shapes in `dtype`: shapes and
    dtypes without memory (the JAX package's `jax.ShapeDtypeStruct`s)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def param_shardings(specs, mesh=None, rules=None) -> dict:
    """The spec tree's layouts on `mesh` (or the current mesh), one spec
    tuple a leaf (`distributed.sharding.resolve_spec`; ``()`` without a
    mesh).  `distributed.sharding.sharding_for` turns a leaf's layout into
    DTensor placements on a `DeviceMesh`."""
    from repro_torch.distributed.sharding import resolve_spec

    return tree_map(lambda s: resolve_spec(s.axes, s.shape, mesh, rules),
                    specs)


def zero_shardings(specs, mesh, rules=None,
                   dp_axes=("pod", "data")) -> dict:
    """ZeRO layouts for optimizer state (and FSDP weights): a leaf's own
    spec plus the data-parallel mesh axes on its largest still-replicated
    dimension that they divide, dropping the minor DP axes until they do.
    The JAX package's rule; spec tuples padded to the leaf's rank."""
    from repro_torch.distributed.sharding import mesh_axes, resolve_spec

    sizes = mesh_axes(mesh)
    avail_all = tuple(a for a in dp_axes if a in sizes)

    def f(spec: ParamSpec) -> tuple:
        base = resolve_spec(spec.axes, spec.shape, mesh, rules)
        parts = list(base) + [None] * (len(spec.shape) - len(base))
        used = set()
        for p in parts:
            if p is not None:
                used.update(p if isinstance(p, tuple) else (p,))
        avail = tuple(a for a in avail_all if a not in used)
        if avail:
            order = sorted(range(len(spec.shape)),
                           key=lambda i: -spec.shape[i])
            for i in order:
                if parts[i] is not None:
                    continue
                cand = avail
                while cand:
                    n = math.prod(sizes[a] for a in cand)
                    if spec.shape[i] % n == 0 and n > 1:
                        parts[i] = cand if len(cand) > 1 else cand[0]
                        break
                    cand = cand[:-1]
                if parts[i] is not None:
                    break
        return tuple(parts)

    return tree_map(f, specs)


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes, as JAX hands it out
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree, device, dtype: torch.dtype | None = None) -> dict:
    """A parameter tree of numpy arrays (the JAX package's tree after
    ``jax.tree.map(np.asarray, params)``) as tensors on `device`, with the
    same keys, stacked ``groups/posNN`` leaves included; cast to `dtype`
    when given."""
    def move(arr):
        t = _tensor(arr).to(device)
        return t if dtype is None else t.to(dtype)

    return tree_map(move, tree)


def spec_bytes(specs, bytes_per_param: int = 2) -> int:
    return sum(math.prod(leaf.shape) * bytes_per_param
               for _, leaf in spec_leaves(specs))
