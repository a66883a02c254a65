"""Sharding rules, segment placement and the pipeline schedule of the port
(the counterpart of the JAX package's ``distributed``)."""
from .pipeline import pipeline_apply, sequential_apply
from .sharding import (
    NamedSharding,
    ShardingRules,
    ShardMesh,
    constrain,
    current_rules,
    make_shard_mesh,
    param_axes_for,
    params_sharding,
    segment_placement,
    use_rules,
)

__all__ = [
    "NamedSharding", "ShardMesh", "ShardingRules", "constrain", "current_rules",
    "make_shard_mesh", "param_axes_for", "params_sharding", "pipeline_apply",
    "segment_placement", "sequential_apply", "use_rules",
]
