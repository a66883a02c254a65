"""PyTorch/CUDA vector data management system (the system under tune)."""
from .datasets import (
    VectorDataset,
    blend_vectors,
    dataset_names,
    exact_topk,
    exact_topk_masked,
    make_dataset,
    recall_at_k,
    recall_at_k_masked,
)
from .draws import BuildDraws
from .engine import (
    LiveVDMS,
    VDMSInstance,
    analytic_build_seconds,
    analytic_chunk_seconds,
    batch_signature,
    get_search_pipeline,
    measure_batch,
    set_search_pipeline,
)
from .faults import (
    BuildCrashFault,
    FaultError,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    ShadowBuildOOM,
    TransientEngineFault,
    canned_fault_plans,
    classify_eval_error,
)
from .indexes import (
    IndexBundle,
    build_index,
    bundle_from_numpy,
    concat_bundles,
    frozen_state,
    replace_segment,
    search_index,
)
from .merge import merge_topk
from .registry import (
    IndexFamily,
    fused_pipeline_table,
    get_family,
    register_family,
    registered_families,
    registered_names,
    registry_table,
    shard_pipeline_table,
    temporary_family,
    unregister_family,
)
from .segments import SegmentPlan, live_seg_size, plan_segments, stack_sealed
from .sharded import ShardedVDMS
from .tuning_env import VDMSTuningEnv, make_space
from .workload import (
    DRIFT_SCHEDULES,
    WorkloadTrace,
    make_query_streams,
    make_trace,
    poisson_arrivals,
    replay_query_streams,
    replay_trace,
    time_aware_ground_truth,
)

__all__ = [
    "BuildCrashFault", "BuildDraws", "DRIFT_SCHEDULES", "FaultError", "FaultEvent",
    "FaultInjector", "FaultPlan", "IndexBundle", "IndexFamily", "LiveVDMS", "SegmentPlan",
    "ShadowBuildOOM", "ShardedVDMS", "TransientEngineFault", "VDMSInstance", "VDMSTuningEnv",
    "VectorDataset",
    "WorkloadTrace", "analytic_build_seconds", "analytic_chunk_seconds", "batch_signature",
    "blend_vectors", "build_index", "bundle_from_numpy", "canned_fault_plans",
    "classify_eval_error", "concat_bundles",
    "dataset_names", "exact_topk", "exact_topk_masked", "frozen_state",
    "fused_pipeline_table", "get_family", "get_search_pipeline", "live_seg_size",
    "make_dataset", "make_query_streams", "make_space", "make_trace", "measure_batch",
    "merge_topk", "plan_segments", "poisson_arrivals", "recall_at_k", "recall_at_k_masked",
    "register_family", "registered_families", "registered_names", "registry_table",
    "replace_segment", "replay_query_streams", "replay_trace", "search_index",
    "set_search_pipeline", "shard_pipeline_table", "stack_sealed", "temporary_family",
    "time_aware_ground_truth",
    "unregister_family",
]
