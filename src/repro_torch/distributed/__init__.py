"""Sharding rules, segment placement, the shard process group and the
pipeline schedule of the port (the counterpart of the JAX package's
``distributed``)."""
from .pipeline import pipeline_apply, sequential_apply
from .sharding import (
    NamedSharding,
    ShardingRules,
    ShardMesh,
    check_backend,
    constrain,
    current_rules,
    group_world_size,
    init_shard_group,
    make_shard_mesh,
    param_axes_for,
    params_sharding,
    rank_device,
    segment_placement,
    spawn_ranks,
    use_rules,
)

__all__ = [
    "NamedSharding", "ShardMesh", "ShardingRules", "check_backend", "constrain",
    "current_rules", "group_world_size", "init_shard_group", "make_shard_mesh",
    "param_axes_for", "params_sharding", "pipeline_apply", "rank_device", "segment_placement",
    "sequential_apply", "spawn_ranks", "use_rules",
]
