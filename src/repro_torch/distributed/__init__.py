"""Sharding rules and segment placement of the port (the counterpart of the
JAX package's ``distributed``)."""
from .sharding import (
    NamedSharding,
    ShardingRules,
    ShardMesh,
    constrain,
    current_rules,
    make_shard_mesh,
    param_axes_for,
    segment_placement,
    use_rules,
)

__all__ = [
    "NamedSharding", "ShardMesh", "ShardingRules", "constrain", "current_rules",
    "make_shard_mesh", "param_axes_for", "segment_placement", "use_rules",
]
