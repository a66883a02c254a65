"""Autonomous serving control plane for a live VDMS deployment (the port's
counterpart of the JAX package's ``serving``).

Three pieces close the loop between serving and tuning:

* :mod:`~repro_torch.serving.metrics` — a Prometheus-style metrics ledger
  (counters / gauges / histograms with text exposition and JSON dumps) fed
  by the live engine's per-search instrumentation hooks.
* :mod:`~repro_torch.serving.slo` — declarative SLO guardrails (recall floor, p99
  latency budget, memory cap) evaluated over sliding windows of live
  measurements.
* :mod:`~repro_torch.serving.controller` — the :class:`ServingController` loop:
  SLO breaches and drift trigger a re-tune, candidates deploy as shadow
  instances with mirrored traffic, and promotion is decided on the
  SLO-constrained score — with checkpoint-exact session rollback for losing
  canaries.

See the README's port section.
"""
from .controller import (
    ControllerParams,
    GidMappedVDMS,
    ServingController,
    mirror_count,
)
from .metrics import (
    DEFAULT_BUCKETS,
    UNIT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsLedger,
    attach_live,
    attach_sharded,
    attach_straggler,
    ledger_table,
    observe_sharded_stats,
    observe_stats,
    percentiles,
    serving_ledger,
)
from .slo import SLOMonitor, SLOSpec, SLOStatus

__all__ = [
    "Counter",
    "ControllerParams",
    "DEFAULT_BUCKETS",
    "Gauge",
    "GidMappedVDMS",
    "Histogram",
    "MetricsLedger",
    "SLOMonitor",
    "SLOSpec",
    "SLOStatus",
    "ServingController",
    "UNIT_BUCKETS",
    "attach_live",
    "attach_sharded",
    "attach_straggler",
    "ledger_table",
    "mirror_count",
    "observe_sharded_stats",
    "observe_stats",
    "percentiles",
    "serving_ledger",
]
