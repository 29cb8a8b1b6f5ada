"""Logical-axis sharding rules of the port (``repro.sharding`` without
JAX): specs are tuples, meshes any object with ``axis_names`` and
``devices.shape``."""
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    ShardingRules,
    batch_axes,
    group_shard_specs,
    logical_to_spec,
    shard_if_divisible,
)

__all__ = [
    "DEFAULT_RULES",
    "ShardingRules",
    "batch_axes",
    "group_shard_specs",
    "logical_to_spec",
    "shard_if_divisible",
]
