"""Minimal functional parameter system: spec trees and parameter trees.

A model is described by a *spec tree*: nested dicts whose leaves are
`ParamSpec(shape, logical_axes, init, scale)`, as in the JAX package's
`models/params.py`.  From one spec tree come real parameters
(`init_params`, drawn on the device from a `torch.Generator`) and their
size (`spec_bytes`); `params_from_numpy` carries a JAX parameter tree
across, key for key.  The logical axes are kept for the shapes' sake: the
port runs on one device, so nothing is sharded.
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
