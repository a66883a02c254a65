"""Fleet tuning of the port: multi-tenant sessions, shared budget,
cross-workload transfer (the counterpart of the JAX package's ``fleet``:
numpy over the port's tuning core). ``bench/bench_fleet.py`` runs a
four-tenant example."""

from .descriptor import (
    FEATURE_NAMES,
    FEATURES,
    DescriptorEmbedding,
    WorkloadDescriptor,
    config_summary,
    describe_dataset,
    describe_env,
    describe_trace,
    feature_table,
)
from .fleet import (
    FLEET_LEDGER_SCHEMA,
    FLEET_STATE_VERSION,
    FleetBudget,
    FleetScheduler,
    FleetSession,
    analytic_eval_cost,
)
from .transfer import (
    TransferPolicy,
    TransferReport,
    apply_transfer,
    check_divergence,
    divergence_score,
    purge_imports,
    rank_sources,
    select_observations,
)

__all__ = [
    "FEATURES",
    "FEATURE_NAMES",
    "FLEET_LEDGER_SCHEMA",
    "FLEET_STATE_VERSION",
    "DescriptorEmbedding",
    "FleetBudget",
    "FleetScheduler",
    "FleetSession",
    "TransferPolicy",
    "TransferReport",
    "WorkloadDescriptor",
    "analytic_eval_cost",
    "apply_transfer",
    "check_divergence",
    "config_summary",
    "describe_dataset",
    "describe_env",
    "describe_trace",
    "divergence_score",
    "feature_table",
    "purge_imports",
    "rank_sources",
    "select_observations",
]
