"""VDTuner core of the port: multi-objective Bayesian optimization for
system tuning, with the GP and the fused acquisition in PyTorch.

The public tuning API is the ask/tell trio of the JAX package's
``repro.core``: an ask/tell recommender (``VDTuner`` or a baseline), an
``ObjectiveSpec`` (what to maximize), and a ``TuningSession`` (who drives
recommendation, evaluation dispatch, ledger, checkpoints).
"""
from .acquisition import cei, ehvi_mc, ei, greedy_select, qehvi_sequential_greedy
from .acquisition_torch import (
    cei_torch,
    ehvi_mc_torch,
    ei_torch,
    fused_cei_select,
    fused_qehvi_select,
    hvi_2d_torch,
)
from .baselines import ALL_BASELINES, DefaultOnly, OpenTunerLike, OtterTuneLike, QEHVI, RandomLHS
from .budget import SuccessiveAbandon, scores_by_hv_influence
from .gp import GP, GPParams
from .hypervolume import hv_2d, hvi_2d
from .normalize import balanced_base, max_base, npi_normalize
from .objectives import (
    OBJECTIVES,
    EvalBackend,
    ObjectiveSpec,
    SequentialBatchMixin,
    as_eval_backend,
    cost_aware,
    cost_aware_transform,
    default_transform,
    promotion_score,
    recall_floor,
    speed_recall,
    streaming_sustained,
    sustained_transform,
)
from .pareto import non_dominated_mask, pareto_front
from .session import (
    BatchExecutor,
    DriftDetector,
    RetryPolicy,
    SequentialExecutor,
    StopSession,
    ThreadedExecutor,
    TuningSession,
    checkpoint_every,
)
from .space import Config, Param, SearchSpace
from .tuner import Observation, TunerBase, TuningFailure, VDTuner

__all__ = [
    "ALL_BASELINES", "BatchExecutor", "Config", "DefaultOnly", "DriftDetector",
    "EvalBackend", "GP", "GPParams", "OBJECTIVES", "ObjectiveSpec", "Observation",
    "OpenTunerLike", "OtterTuneLike", "Param", "QEHVI", "RandomLHS", "RetryPolicy",
    "SearchSpace",
    "SequentialBatchMixin", "SequentialExecutor", "StopSession", "SuccessiveAbandon",
    "ThreadedExecutor", "TunerBase", "TuningFailure", "TuningSession", "VDTuner",
    "as_eval_backend", "balanced_base", "cei", "cei_torch", "checkpoint_every",
    "cost_aware", "cost_aware_transform", "default_transform", "ehvi_mc",
    "ehvi_mc_torch", "ei", "ei_torch", "fused_cei_select", "fused_qehvi_select",
    "greedy_select", "hv_2d", "hvi_2d", "hvi_2d_torch", "max_base",
    "non_dominated_mask", "npi_normalize", "pareto_front", "promotion_score",
    "qehvi_sequential_greedy",
    "recall_floor", "scores_by_hv_influence", "speed_recall", "streaming_sustained",
    "sustained_transform",
]
