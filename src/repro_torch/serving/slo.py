"""Declarative SLO guardrails for the serving control plane (a copy of the
JAX package's ``serving/slo.py``; numpy only).

:class:`SLOSpec` states the service-level objectives a deployment must hold —
a recall floor (the paper's §IV-F user preference, mapped onto the CEI
constraint objective via :mod:`repro_torch.core.objectives`), a p99 latency budget,
and a memory cap. :class:`SLOMonitor` evaluates a spec over sliding windows
of live measurements (per-query latencies, recall probes, memory snapshots)
and emits breach events; the serving controller uses those events — alongside
drift detection — as its re-tune trigger.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.objectives import ObjectiveSpec, streaming_sustained


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """What the deployment promises. ``None`` disables a guardrail.

    ``recall_floor`` — mean windowed recall must stay >= this (also the CEI
    constraint the re-tuner optimizes under, see :meth:`objective_spec`);
    ``p99_latency_s`` — windowed p99 per-query latency budget (seconds);
    ``mem_gib_cap`` — live-instance footprint cap (GiB);
    ``latency_window`` — per-query latency samples in the sliding window;
    ``recall_window`` — recall probes in the sliding window;
    ``min_samples`` — latency samples required before the latency guardrail
    is considered armed (cold windows never breach).
    """

    recall_floor: Optional[float] = None
    p99_latency_s: Optional[float] = None
    mem_gib_cap: Optional[float] = None
    latency_window: int = 256
    recall_window: int = 8
    min_samples: int = 32

    def __post_init__(self):
        if self.recall_floor is not None and not 0.0 < self.recall_floor <= 1.0:
            raise ValueError(f"recall_floor must be in (0, 1], got {self.recall_floor}")
        if self.p99_latency_s is not None and self.p99_latency_s <= 0:
            raise ValueError(f"p99_latency_s must be > 0, got {self.p99_latency_s}")
        if self.mem_gib_cap is not None and self.mem_gib_cap <= 0:
            raise ValueError(f"mem_gib_cap must be > 0, got {self.mem_gib_cap}")
        if self.latency_window < 1 or self.recall_window < 1:
            raise ValueError("windows must be >= 1")
        if not (self.recall_floor or self.p99_latency_s or self.mem_gib_cap):
            raise ValueError("SLOSpec with every guardrail disabled is meaningless")

    def objective_spec(self, alpha: float = 1.0) -> ObjectiveSpec:
        """The tuning objective this SLO induces: sustained QPS x recall with
        the recall floor carried as the CEI constraint (``rlim``), so a
        re-tune triggered by a breach optimizes under the same contract the
        guardrail enforces."""
        return streaming_sustained(alpha=alpha, rlim=self.recall_floor)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SLOStatus:
    """One guardrail evaluation: ``ok`` plus the measured window values."""

    ok: bool
    breaches: Tuple[str, ...]
    p99_latency_s: float
    recall: float
    mem_gib: float
    n_latency_samples: int
    n_recall_samples: int
    at_time: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["breaches"] = list(self.breaches)
        return d


class SLOMonitor:
    """Sliding-window evaluator for one :class:`SLOSpec`.

    Feed it live measurements (:meth:`observe_query`, :meth:`observe_recall`,
    :meth:`observe_mem`) and call :meth:`evaluate` at control ticks; every
    not-ok status is appended to :attr:`events`. :meth:`reset` clears the
    windows (call after a promote, so the new config starts a fresh window).
    """

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self._lat: Deque[float] = deque(maxlen=spec.latency_window)
        self._recall: Deque[float] = deque(maxlen=spec.recall_window)
        self._mem = 0.0
        self.events: List[Dict[str, Any]] = []
        self.n_evaluations = 0

    # --- feeds ---------------------------------------------------------
    def observe_query(self, latency_s) -> None:
        """One latency or an array of per-query latencies (seconds)."""
        arr = np.atleast_1d(np.asarray(latency_s, np.float64))
        self._lat.extend(arr.tolist())

    def observe_recall(self, recall: float) -> None:
        self._recall.append(float(recall))

    def observe_mem(self, mem_gib: float) -> None:
        self._mem = float(mem_gib)

    def reset(self) -> None:
        self._lat.clear()
        self._recall.clear()

    # --- evaluation ----------------------------------------------------
    @property
    def windowed_recall(self) -> float:
        return float(np.mean(self._recall)) if self._recall else 1.0

    @property
    def windowed_p99(self) -> float:
        if not self._lat:
            return 0.0
        return float(np.percentile(np.asarray(self._lat, np.float64), 99.0))

    def evaluate(self, at_time: float = 0.0) -> SLOStatus:
        spec = self.spec
        breaches: List[str] = []
        p99 = self.windowed_p99
        recall = self.windowed_recall
        if (
            spec.p99_latency_s is not None
            and len(self._lat) >= spec.min_samples
            and p99 > spec.p99_latency_s
        ):
            breaches.append("p99_latency")
        if spec.recall_floor is not None and self._recall and recall < spec.recall_floor:
            breaches.append("recall_floor")
        if spec.mem_gib_cap is not None and self._mem > spec.mem_gib_cap:
            breaches.append("mem_cap")
        status = SLOStatus(
            ok=not breaches,
            breaches=tuple(breaches),
            p99_latency_s=p99,
            recall=recall,
            mem_gib=self._mem,
            n_latency_samples=len(self._lat),
            n_recall_samples=len(self._recall),
            at_time=float(at_time),
        )
        self.n_evaluations += 1
        if breaches:
            self.events.append(status.to_dict())
        return status
