"""Prometheus-style metrics ledger for the serving control plane (a copy of
the JAX package's ``serving/metrics.py``; numpy only).

Three metric kinds, one registry:

* :class:`Counter` — monotonically increasing totals (queries served, retune /
  promote / rollback events);
* :class:`Gauge` — instantaneous values (QPS, memory, tombstone fraction,
  seal/compaction debt);
* :class:`Histogram` — bucketed distributions with an exact sliding-window
  reservoir, so the ledger can both export cumulative Prometheus buckets and
  answer live percentile queries (p50/p95/p99 query latency, recall probes).

:class:`MetricsLedger` owns the metrics and renders them two ways: the
Prometheus text exposition format (``to_text``) and a JSON dump
(``to_json`` / ``dump_json``) that CI uploads as the control-plane artifact.

The ledger is fed by the engine's instrumentation hooks: :func:`attach_live`
subscribes it to a ``LiveVDMS``'s per-search hook stream, and
:func:`observe_stats` syncs the lifecycle gauges from ``LiveVDMS.stats()``.
Nothing in ``repro_torch.vdms`` imports this module — the dependency points one way.
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: Default latency-style histogram bounds (seconds), log-spaced.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
#: Fraction-valued histograms (recall probes) use linear bounds.
UNIT_BUCKETS: Tuple[float, ...] = tuple(round(0.05 * i, 2) for i in range(1, 21))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Metric:
    """Shared name/help plumbing; subclasses define ``kind`` and rendering."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help

    def exposition(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += float(v)

    def exposition(self) -> List[str]:
        return self._header() + [f"{self.name} {self.value:g}"]

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help, "value": float(self.value)}


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)

    def exposition(self) -> List[str]:
        return self._header() + [f"{self.name} {self.value:g}"]

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help, "value": float(self.value)}


class Histogram(Metric):
    """Cumulative Prometheus buckets plus an exact sliding-window reservoir.

    Buckets/count/sum accumulate over the metric's lifetime (the exposition
    contract); ``percentile`` answers over the most recent ``window``
    observations — the sliding view SLO guardrails evaluate.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        window: int = 4096,
    ):
        super().__init__(name, help)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram {name}: buckets must be strictly increasing")
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # +Inf bucket last
        self.count = 0
        self.sum = 0.0
        self.window: deque = deque(maxlen=int(window))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.window.append(v)
        # first bound >= v (linear scan is fine at these cardinalities)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def observe_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    def percentile(self, q: float) -> float:
        """Exact percentile (``q`` in [0, 100]) over the sliding window;
        0.0 when nothing (finite) has been observed yet."""
        arr = np.asarray(self.window, np.float64)
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return 0.0
        return float(np.percentile(arr, q))

    @property
    def window_mean(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    def exposition(self) -> List[str]:
        lines = self._header()
        cum = 0
        for b, n in zip(self.bounds, self.bucket_counts[:-1]):
            cum += n
            lines.append(f'{self.name}_bucket{_label_str({"le": f"{b:g}"})} {cum}')
        lines.append(f'{self.name}_bucket{_label_str({"le": "+Inf"})} {self.count}')
        lines.append(f"{self.name}_sum {self.sum:g}")
        lines.append(f"{self.name}_count {self.count}")
        return lines

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "help": self.help,
            "count": int(self.count),
            "sum": float(self.sum),
            "buckets": {f"{b:g}": int(n) for b, n in zip(self.bounds, self.bucket_counts)},
            "inf": int(self.bucket_counts[-1]),
            "window_n": len(self.window),
            "percentiles": {
                "p50": self.percentile(50.0),
                "p95": self.percentile(95.0),
                "p99": self.percentile(99.0),
            },
        }


class MetricsLedger:
    """A named registry of counters/gauges/histograms with text + JSON export.

    The factory methods are get-or-create (re-registering a name returns the
    existing metric; a kind mismatch raises), so instrumentation sites can be
    written without caring who registered first.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    # --- registration --------------------------------------------------
    def _get_or_create(self, cls, name: str, *args, **kwargs) -> Any:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as {m.kind}")
            return m
        m = cls(name, *args, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        window: int = 4096,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets, window)

    def get(self, name: str) -> Metric:
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return list(self._metrics)

    # --- export --------------------------------------------------------
    def to_text(self) -> str:
        """Prometheus text exposition (one scrape payload)."""
        lines: List[str] = []
        for m in self._metrics.values():
            lines.extend(m.exposition())
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, Any]:
        out = {name: m.to_dict() for name, m in self._metrics.items()}
        # strict-JSON guard: no NaN/Inf leaks into CI artifacts
        def clean(v):
            if isinstance(v, float) and not math.isfinite(v):
                return None
            return v
        return json.loads(json.dumps(out, default=clean))

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


# ---------------------------------------------------------------------------
# the serving instrument set
# ---------------------------------------------------------------------------
def serving_ledger() -> MetricsLedger:
    """A ledger pre-registered with the control plane's standard metrics."""
    led = MetricsLedger()
    led.counter("vdms_queries_total", "Queries served by the live instance")
    led.histogram("vdms_query_latency_seconds", "Per-query wall latency")
    led.gauge("vdms_qps", "Throughput over the last search micro-batch")
    led.histogram("vdms_recall_probe", "Windowed recall probes vs oracle", buckets=UNIT_BUCKETS)
    led.gauge("vdms_mem_gib", "Live instance memory footprint (GiB)")
    led.gauge("vdms_tombstone_fraction", "Dead fraction of inserted vectors")
    led.gauge("vdms_tail_size", "Unsealed growing-tail length")
    led.gauge("vdms_sealed_segments", "Sealed segment count")
    led.gauge("vdms_seal_debt_seconds", "Accumulated seal+compaction build seconds (analytic)")
    led.counter("vdms_seals_total", "Segment seal events")
    led.counter("vdms_compactions_total", "Segment compaction events")
    led.counter("vdms_slo_breach_total", "SLO guardrail breach events")
    led.counter("vdms_retune_total", "Re-tune triggers (drift or SLO breach)")
    led.counter("vdms_promote_total", "Canary promotions (shadow replaced primary)")
    led.counter("vdms_rollback_total", "Canary rollbacks (checkpoint-exact)")
    led.counter("vdms_shadow_build_seconds_total", "Analytic build cost charged for shadow instances")
    # fault-injection / degraded-mode instruments (all stay zero fault-free)
    led.counter("vdms_fault_injected_total", "Faults applied by the armed FaultPlan")
    led.counter("vdms_quarantine_total", "Sealed segments quarantined (loss/corruption)")
    led.counter("vdms_rebuild_total", "Quarantined segments rebuilt from the vector store")
    led.counter("vdms_rebuild_failure_total", "Quarantine rebuilds whose retry budget exhausted")
    led.counter("vdms_seal_retry_total", "Crashed incremental builds retried with backoff")
    led.counter("vdms_canary_fault_abort_total", "Canaries aborted because a fault struck mid-mirror")
    led.gauge("vdms_coverage", "Visible fraction served by the last search (1.0 = full)")
    led.gauge("vdms_quarantined_segments", "Segments currently quarantined")
    led.gauge("vdms_health_state", "Engine health: 0=healthy 1=rebuilding 2=degraded")
    led.gauge("vdms_straggler_flagged", "Straggler-flagged search calls (StragglerMonitor)")
    # sharded multi-device serving instruments (1-shard defaults fault-free)
    led.gauge("vdms_shards", "Shard count of the serving mesh (1 = unsharded)")
    led.gauge("vdms_shard_skew", "Max/mean sealed-segment imbalance across populated shards")
    led.gauge("vdms_shard_min_coverage", "Smallest per-shard alive fraction")
    return led


def ledger_table() -> str:
    """Markdown table of the standard serving-ledger metrics — the generated
    block the README embeds (doc-sync-tested, like the kernel table)."""
    led = serving_ledger()
    lines = ["| metric | kind | description |", "| --- | --- | --- |"]
    for name in led.names():
        m = led.get(name)
        lines.append(f"| `{name}` | {m.kind} | {m.help} |")
    return "\n".join(lines)


def attach_live(ledger: MetricsLedger, live) -> None:
    """Subscribe the ledger to a ``LiveVDMS``'s per-search hook stream:
    every search feeds the query counter, the latency histogram, and the
    instantaneous-QPS gauge."""
    queries = ledger.counter("vdms_queries_total")
    lat = ledger.histogram("vdms_query_latency_seconds")
    qps = ledger.gauge("vdms_qps")

    def hook(nq: int, latencies: np.ndarray, elapsed: float) -> None:
        queries.inc(nq)
        lat.observe_many(np.asarray(latencies, np.float64).tolist())
        qps.set(nq / max(elapsed, 1e-12))

    live.search_hooks.append(hook)


def observe_stats(ledger: MetricsLedger, stats: Dict[str, float]) -> None:
    """Sync the lifecycle gauges/counters from one ``LiveVDMS.stats()``
    snapshot (counters advance by the delta vs their current value, so
    repeated syncs are idempotent)."""
    ledger.gauge("vdms_mem_gib").set(stats["mem_gib"])
    ledger.gauge("vdms_tombstone_fraction").set(stats["tombstone_fraction"])
    ledger.gauge("vdms_tail_size").set(stats["tail_size"])
    ledger.gauge("vdms_sealed_segments").set(stats["n_sealed"])
    ledger.gauge("vdms_seal_debt_seconds").set(
        stats["seal_build_model_s"] + stats["bootstrap_build_model_s"]
    )
    # fault/degraded-mode gauges: .get-guarded so snapshots from engines
    # predating the fault layer still sync cleanly
    ledger.gauge("vdms_coverage").set(float(stats.get("coverage", 1.0)))
    ledger.gauge("vdms_quarantined_segments").set(float(stats.get("quarantined_segments", 0)))
    ledger.gauge("vdms_health_state").set(float(stats.get("health_code", 0)))
    for counter_name, key in (
        ("vdms_seals_total", "n_seals"),
        ("vdms_compactions_total", "n_compactions"),
        ("vdms_fault_injected_total", "n_faults_injected"),
        ("vdms_quarantine_total", "n_quarantines"),
        ("vdms_rebuild_total", "n_rebuilds"),
        ("vdms_rebuild_failure_total", "n_rebuild_failures"),
        ("vdms_seal_retry_total", "n_seal_retries"),
    ):
        c = ledger.counter(counter_name)
        delta = float(stats.get(key, 0.0)) - c.value
        if delta > 0:
            c.inc(delta)


def attach_sharded(ledger: MetricsLedger, sharded) -> None:
    """Wire a sharded live instance (the JAX package's ``ShardedVDMS``; not
    ported yet) into the ledger:
    the search-hook stream feeds the same query/latency/QPS instruments as
    :func:`attach_live`, and :func:`observe_sharded_stats` syncs the shard
    gauges — ``ShardedVDMS`` exposes the identical hook contract, so this is
    ``attach_live`` plus one initial gauge sync."""
    attach_live(ledger, sharded)
    observe_sharded_stats(ledger, sharded.stats())


def observe_sharded_stats(ledger: MetricsLedger, stats: Dict[str, Any]) -> None:
    """Sync the shard placement/coverage gauges from one
    ``ShardedVDMS.stats()`` snapshot."""
    ledger.gauge("vdms_shards").set(float(stats.get("n_shards", 1)))
    ledger.gauge("vdms_shard_skew").set(float(stats.get("shard_skew", 0.0)))
    ledger.gauge("vdms_shard_min_coverage").set(
        float(stats.get("min_shard_coverage", 0.0))
    )
    ledger.gauge("vdms_mem_gib").set(float(stats.get("mem_gib", 0.0)))
    ledger.gauge("vdms_coverage").set(float(stats.get("coverage", 1.0)))


def attach_straggler(ledger: MetricsLedger, live, monitor=None):
    """Wire the fault-tolerance :class:`~repro_torch.ft.monitor.StragglerMonitor`
    into the serving latency path: every search call's elapsed time is a
    "step" the monitor judges against its trailing median, and the flagged
    count is exported as the ``vdms_straggler_flagged`` gauge. Returns the
    monitor (created with serving-friendly defaults when not given) so the
    controller can poll ``should_replace``."""
    from ..ft.monitor import StragglerMonitor

    if monitor is None:
        monitor = StragglerMonitor(window=32, threshold=3.0, patience=4)
    flagged = ledger.gauge("vdms_straggler_flagged")

    def hook(nq: int, latencies: np.ndarray, elapsed: float) -> None:
        monitor.record(len(monitor.history), float(elapsed))
        flagged.set(float(sum(1 for s in monitor.history if s.flagged)))

    live.search_hooks.append(hook)
    return monitor


def percentiles(values: Sequence[float], qs: Sequence[float] = (50.0, 95.0, 99.0)) -> Dict[str, float]:
    """Tiny convenience: ``{"p50": ..., ...}`` over ``values`` (0.0 if empty)."""
    arr = np.asarray(values, np.float64)
    if arr.size == 0:
        return {f"p{q:g}": 0.0 for q in qs}
    return {f"p{q:g}": float(np.percentile(arr, q)) for q in qs}
