"""Logical-axis sharding rules (MaxText-style) and the helpers around them.

The counterpart of the JAX package's `distributed/sharding.py`.  Model
code names the axes of a tensor logically (("batch", "seq", "embed"),
("expert", "mlp"), ...); a rule table maps each logical name to a mesh
axis or a tuple of mesh axes, and `resolve_spec` checks divisibility
against the mesh, so the same names give a layout on one card (everything
replicated), on a 256-card pod or on a 512-card pair of pods.

A mesh is anything with axis names and sizes: a
`torch.distributed.device_mesh.DeviceMesh` with `mesh_dim_names`, or an
`AbstractMesh` of this module, which names a layout that no one card can
build (the production meshes of `launch.mesh`) and needs no process
group.  A spec is a tuple with one entry a tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension split
over several axes, the first the major one), the entries of the JAX
package's `PartitionSpec`.  `sharding_for` turns a spec into DTensor
placements, one a mesh dimension, where the JAX package builds a
`NamedSharding`; `shard` redistributes a DTensor to a logical layout.

`use_rules` and `use_mesh` set the rules and the mesh for the calling
thread; without them every constraint is a no-op, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence

import torch

__all__ = [
    "DEFAULT_RULES",
    "AbstractMesh",
    "use_rules",
    "use_mesh",
    "current_mesh",
    "current_rules",
    "mesh_axes",
    "axis_group",
    "resolve_spec",
    "shard",
    "sharding_for",
    "points_axis",
]

# Logical axis -> mesh axis (or tuple of mesh axes).  ``None`` = replicate.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),       # DP (pod axis folds into DP when present)
    "seq": None,                    # sequence: replicated by default
    "seq_kv": "model",              # long-context KV sharding (SP at decode)
    "embed": None,                  # d_model: replicated (activations)
    "heads": "model",               # TP over attention heads
    "kv_heads": "model",
    "mlp": "model",                 # TP over FFN hidden
    "vocab": "model",               # TP over vocab (embed + logits)
    "expert": "model",              # EP over experts
    "dp_shard": ("pod", "data"),    # two-stage MoE dispatch shard axis
    "kv_clusters": "model",         # cluster-KV codebook sharding
    "points": ("pod", "data"),      # clustering point axis (sharded seeders)
    "expert_mlp": None,             # per-expert hidden stays local under EP
    "kv_lora": None,
    "layers": None,                 # scan axis, never sharded
    "conv": None,
    "state": None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group, read the
    way a `DeviceMesh` is: ``mesh_dim_names``, ``shape``, ``ndim``,
    ``size()``.  The JAX package's `jax.sharding.AbstractMesh(axis_sizes,
    axis_names)`."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        sizes = tuple(int(n) for n in self.axis_sizes)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis sizes {sizes} against names {names}")
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @property
    def mesh_dim_names(self) -> tuple:
        return self.axis_names

    @property
    def shape(self) -> tuple:
        return self.axis_sizes

    @property
    def ndim(self) -> int:
        return len(self.axis_sizes)

    def size(self) -> int:
        return math.prod(self.axis_sizes)


_local = threading.local()


def current_rules() -> dict:
    return getattr(_local, "rules", DEFAULT_RULES)


def current_mesh():
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: dict):
    prev = getattr(_local, "rules", None)
    _local.rules = {**DEFAULT_RULES, **rules}
    try:
        yield
    finally:
        if prev is None:
            del _local.rules
        else:
            _local.rules = prev


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield
    finally:
        if prev is None:
            del _local.mesh
        else:
            _local.mesh = prev


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`, in the
    mesh's order."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh without axis names cannot take rules")
    return dict(zip(names, (int(n) for n in mesh.shape)))


def axis_group(mesh, axis: Optional[str]):
    """The process group of `mesh`'s axis `axis` (a `DeviceMesh`), or
    `mesh` itself when it is a group already (a `ProcessGroup`, or None
    for the default group): the counterpart of a JAX mesh and an axis
    name inside `shard_map`."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return mesh.get_group(axis)
    return mesh


def _mesh_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= _mesh_size(sizes, a)
        return n
    return sizes.get(axis, 1)


def resolve_spec(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh=None,
    rules: Optional[dict] = None,
) -> tuple:
    """Logical axes + concrete shape -> spec (a tuple, one entry a
    dimension; ``()`` without a mesh).

    Drops assignments whose mesh axes do not exist or do not divide the
    dimension (so e.g. kv_heads=1 stays replicated on a model=16 mesh),
    trying a prefix of an axis tuple first; a mesh axis is used once.
    """
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return ()
    sizes = mesh_axes(mesh)
    parts = []
    used: set = set()
    for dim, name in zip(shape, axes):
        assignment = rules.get(name) if name else None
        if assignment is None:
            parts.append(None)
            continue
        cand = assignment if isinstance(assignment, (tuple, list)) \
            else (assignment,)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        size = _mesh_size(sizes, cand)
        if size <= 1 or dim % size != 0:
            # Try a prefix of the axis tuple before giving up.
            while cand and (dim % _mesh_size(sizes, cand) != 0):
                cand = cand[:-1]
            if not cand or _mesh_size(sizes, cand) <= 1:
                parts.append(None)
                continue
        used.update(cand)
        parts.append(cand if len(cand) > 1 else cand[0])
    return tuple(parts)


def points_axis(mesh, n: Optional[int] = None):
    """Mesh axis (or axis tuple) carrying the clustering "points" dimension.

    Resolves through the rule table like any model tensor, with the same
    tuple-prefix divisibility fallback as `resolve_spec`, but *keeps*
    size-1 axes: a collective needs a named axis even on a one-device
    mesh.  ``n=None`` skips the divisibility check (used to size the
    padding that then guarantees it).  Returns ``None`` only when no rule
    axis exists in the mesh at all.
    """
    assignment = current_rules().get("points")
    if assignment is None:
        return None
    sizes = mesh_axes(mesh)
    cand = (
        tuple(assignment)
        if isinstance(assignment, (tuple, list))
        else (assignment,)
    )
    cand = tuple(a for a in cand if a in sizes)
    if n is not None:
        while cand and n % _mesh_size(sizes, cand) != 0:
            cand = cand[:-1]
    if not cand:
        return None
    return cand if len(cand) > 1 else cand[0]


def _placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one a mesh dimension) of a spec.  A dimension
    split over several mesh axes is split in the order of the mesh's
    dimensions, the first the major one, which is JAX's order for the
    spec's tuple only when the tuple names them in the mesh's order:
    another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in group]
        if where != sorted(where):
            raise ValueError(f"spec entry {group} names the mesh axes out "
                             f"of the mesh's order {tuple(names)}")
        for i in where:
            out[i] = Shard(dim)
    return tuple(out)


def sharding_for(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[dict] = None,
) -> Optional[tuple]:
    """The DTensor placements of a logical layout on `mesh` (or the
    current mesh): `distribute_tensor(x, mesh, placements)` lays a tensor
    out so.  None without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return _placements(resolve_spec(axes, shape, mesh, rules), mesh)


def shard(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Lay `x` out by its logical axes on the current mesh: the identity
    without a mesh or on a one-device mesh, a redistribution of a DTensor
    otherwise.  A plain tensor under a larger mesh raises, so that a
    layout is never dropped silently."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"shard: a plain tensor under a mesh of "
                        f"{mesh.size()} devices; distribute it first "
                        "(`sharding_for`)")
    return x.redistribute(mesh, sharding_for(x.shape, axes, mesh))
