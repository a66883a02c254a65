"""Sharding rules, parameter shards, segment placement, the process group,
the collectives over a mesh's axes (``collectives``) and the pipeline
schedule of the port (the counterpart of the JAX package's
``distributed``)."""
from .pipeline import pipeline_apply, sequential_apply
from .sharding import (
    NamedSharding,
    ShardingRules,
    ShardMesh,
    check_backend,
    constrain,
    current_rules,
    gather_params,
    group_world_size,
    init_shard_group,
    make_shard_mesh,
    param_axes_for,
    params_sharding,
    rank_device,
    segment_placement,
    shard_params,
    spawn_ranks,
    use_rules,
)

__all__ = [
    "NamedSharding", "ShardMesh", "ShardingRules", "check_backend", "constrain",
    "current_rules", "gather_params", "group_world_size", "init_shard_group", "make_shard_mesh",
    "param_axes_for", "params_sharding", "pipeline_apply", "rank_device", "segment_placement",
    "sequential_apply", "shard_params", "spawn_ranks", "use_rules",
]
