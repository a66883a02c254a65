"""PyTorch/CUDA vector data management system (the system under tune)."""
from .datasets import VectorDataset, exact_topk, make_dataset, recall_at_k
from .engine import (
    VDMSInstance,
    analytic_build_seconds,
    analytic_chunk_seconds,
    get_search_pipeline,
    set_search_pipeline,
)
from .indexes import IndexBundle, build_index, bundle_from_numpy, search_index
from .merge import merge_topk
from .registry import IndexFamily, get_family
from .segments import SegmentPlan, plan_segments, stack_sealed
from .tuning_env import VDMSTuningEnv, classify_eval_error, make_space

__all__ = [
    "IndexBundle", "IndexFamily", "SegmentPlan", "VDMSInstance", "VDMSTuningEnv",
    "VectorDataset", "analytic_build_seconds", "analytic_chunk_seconds", "build_index",
    "bundle_from_numpy", "classify_eval_error", "exact_topk", "get_family",
    "get_search_pipeline", "make_dataset", "make_space", "merge_topk", "plan_segments",
    "recall_at_k", "search_index", "set_search_pipeline", "stack_sealed",
]
