"""Logical-axis sharding rules of the port (``repro.sharding`` without
JAX): specs are tuples, meshes any object with ``axis_names`` and
``devices.shape``; on the LM mesh a spec becomes ``DTensor`` placements
(``placements``, ``param_sharding``, ``distribute``)."""
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    ShardingRules,
    batch_axes,
    distribute,
    group_shard_specs,
    logical_to_spec,
    param_sharding,
    placements,
    shard_if_divisible,
    spec_tree,
)

__all__ = [
    "DEFAULT_RULES",
    "group_shard_specs",
    "ShardingRules",
    "batch_axes",
    "shard_if_divisible",
    "param_sharding",
    "logical_to_spec",
    "placements",
    "spec_tree",
    "distribute",
]
