"""Logical-axis sharding rules.

A copy of ``repro.sharding.rules`` without JAX. A spec is a tuple with
one entry per tensor dim, each entry a mesh-axis name, a tuple of names,
or ``None`` (replicated): the content of the reference's
``PartitionSpec``. A mesh is any object with ``axis_names`` and
``devices.shape``: the sim mesh of ``launch.mesh.make_sim_mesh`` or a
stand-in with the production mesh's shape.

``logical_to_spec`` maps logical names onto mesh axes via a
``ShardingRules`` table, dropping any assignment whose dim size is not
divisible by the mesh-axis size (2 kv-heads on a 16-way model axis stay
replicated), so one model definition stays valid on every mesh. The sim
engine reads ``group_shard_specs``: its bucket groups lie on the logical
"group" axis, which the table assigns to the sim mesh's ``devices``.

The LM mesh (``launch.mesh.LmMesh``) reads ``spec_tree`` and
``param_sharding``: a tree's specs, and each spec turned by
``placements`` into the ``DTensor`` placements of the mesh's
``DeviceMesh``, one per mesh dim; ``distribute`` places a tree of
tensors by them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

Spec = Tuple[object, ...]

# Default logical -> mesh-axis assignment (tensor-parallel flavour).
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "vocab_in": "model",  # input embedding table
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": None,
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "layers": None,
    "norm": None,
    "batch": "data",  # data axis; launchers extend with "pod"
    "seq": None,
    "attn_q_seq": None,  # opt-in context-parallel attention (model axis)
    # KV cache replicated along sequence; rules.replace(table_updates=
    # {"kv_seq": "data"}) shards long-context caches along sequence when
    # batch cannot use the data axis
    "kv_seq": None,
    "member": "data",
    # sim side: SDCA bucket groups lay out along the 1-D sim mesh's
    # "devices" axis (launch.mesh.make_sim_mesh). LM meshes have no
    # "devices" axis, so the assignment drops to replicated there
    "group": "devices",
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Assignment of logical axes to mesh axes, plus the FSDP toggle.

    ``fsdp`` additionally shards the ``fsdp_logical`` dims over
    ``fsdp_axis`` (the ZeRO-3 analogue) where no tensor-parallel axis
    claims them."""

    table: Tuple[Tuple[str, Optional[str]], ...] = tuple(sorted(DEFAULT_RULES.items()))
    fsdp: bool = False
    fsdp_axis: str = "data"
    fsdp_logical: Tuple[str, ...] = ("embed",)

    def lookup(self, logical: str) -> Optional[str]:
        axis = dict(self.table).get(logical)
        if self.fsdp and axis is None and logical in self.fsdp_logical:
            return self.fsdp_axis
        return axis

    def replace(self, **updates) -> "ShardingRules":
        d = dict(self.table)
        for k, v in updates.pop("table_updates", {}).items():
            d[k] = v
        return dataclasses.replace(self, table=tuple(sorted(d.items())), **updates)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes used for batch data parallelism (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def shard_if_divisible(dim_size: int, mesh, axis):
    """``axis`` if ``dim_size`` divides evenly over it (a name or a tuple
    of names, all on ``mesh``), else ``None``."""
    if axis is None:
        return None
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    total = 1
    for a in axes:
        if a not in sizes:
            return None
        total *= sizes[a]
    return axis if dim_size % total == 0 else None


def logical_to_spec(shape, logical: Tuple[Optional[str], ...], mesh,
                    rules: ShardingRules) -> Spec:
    """The spec of one tensor given its logical axes."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes {logical} differ in rank")
    spec = []
    used = set()
    for size, name in zip(shape, logical):
        axis = None if name is None else rules.lookup(name)
        if name == "batch" and axis is not None:
            # batch shards over (pod, data) together when pod exists
            axis = batch_axes(mesh) or None
            if axis is not None and len(axis) == 1:
                axis = axis[0]
        axis = shard_if_divisible(size, mesh, axis)
        # a mesh axis may appear at most once in a spec
        key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if axis is not None and any(a in used for a in key):
            axis = None
        if axis is not None:
            used.update(key)
        spec.append(axis)
    return tuple(spec)


def _map_leaves(fn, tree, logical):
    """``fn(leaf, names)`` over a tree of tensors (dicts, lists, tuples)
    and the tree of logical axis tuples that mirrors it."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, logical[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, n) for v, n in zip(tree, logical))
    return fn(tree, logical)


def spec_tree(mesh, shapes, logical_axes, rules: ShardingRules):
    """The spec of each leaf of ``shapes`` (anything with ``.shape``: the
    ``meta`` tensors of ``models.abstract_params``, real tensors)."""
    return _map_leaves(lambda t, names: logical_to_spec(t.shape, names, mesh, rules),
                       shapes, logical_axes)


def placements(spec: Spec, mesh) -> tuple:
    """The ``DTensor`` placements of a spec on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d is sharded over it, else
    ``Replicate()``. A tensor dim sharded over several mesh axes
    (``("pod", "data")``) must name them in the mesh's order, major axis
    first, which is how ``DTensor`` splits a dim that more than one mesh
    dim shards."""
    owner = {}
    for dim, axis in enumerate(spec):
        axes = () if axis is None else (axis,) if isinstance(axis, str) else tuple(axis)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {dim} names {axes} out of the mesh's "
                             f"order {mesh.axis_names}")
        for a in axes:
            owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.axis_names)


def param_sharding(mesh, params, logical_axes, rules: ShardingRules):
    """The ``placements`` of each leaf of ``params`` (or of optimizer
    state mirroring them), a tree of tuples with one placement per mesh
    dim: the port's ``NamedSharding`` tree."""
    return _map_leaves(
        lambda t, names: placements(logical_to_spec(t.shape, names, mesh, rules), mesh),
        params, logical_axes)


def distribute(tree, mesh, logical_axes, rules: ShardingRules):
    """Each tensor of ``tree`` as a ``DTensor`` on ``mesh.device_mesh``,
    placed by ``param_sharding``. Every rank holds the whole tensor (the
    same seed or the same file), so each keeps its own shard and nothing
    moves (``src_data_rank=None``). A leaf that requires grad stays a
    leaf that requires grad."""
    def one(t, names):
        pl = placements(logical_to_spec(t.shape, names, mesh, rules), mesh)
        with torch.no_grad():
            out = distribute_tensor(t.detach(), mesh.device_mesh, pl, src_data_rank=None)
        return out.requires_grad_(t.requires_grad)

    return _map_leaves(one, tree, logical_axes)


def group_shard_specs(mesh, ranks: Sequence[int],
                      rules: Optional[ShardingRules] = None) -> Tuple[Spec, ...]:
    """Specs for tensors batched on a leading "group" axis, one per
    argument rank: a rank-r tensor shards its leading dim over whatever
    mesh axis the rules assign to "group" (the sim mesh's ``devices``);
    rank 0 means a replicated scalar (``()``). The sharded sim engine
    splits its fit and score arguments by these specs."""
    rules = ShardingRules() if rules is None else rules
    axis = rules.lookup("group")
    axis = axis if axis in mesh.axis_names else None
    return tuple(
        (axis, *([None] * (r - 1))) if r and axis is not None else ()
        for r in ranks
    )
