"""First-class tuning objectives and the evaluation-backend protocol.

This module decouples the three roles the old API fused into one callable:

* :class:`ObjectiveSpec` — what the tuner optimizes: per-objective names,
  directions, and the transform from a raw measurement dict to the objective
  vector. Built-ins cover the paper's three modes: plain speed x recall
  (Eq. 1), the recall-floor user preference (Eq. 7's constraint target), and
  cost-aware QP$ (Eq. 8).
* :class:`EvalBackend` — who produces raw measurements: any per-config
  callable, optionally exposing a vectorized ``evaluate_batch``.
  :func:`as_eval_backend` upgrades a bare callable with a sequential batch
  adapter so every backend speaks the same protocol.
* :class:`TuningFailure` — how a crashed/timed-out configuration is reported.
  It lives here (rather than in ``tuner``) so backends can depend on the
  protocol module alone; ``repro_torch.core.tuner`` re-exports it unchanged.

Recommenders (``ask``/``tell`` tuners) consume :class:`ObjectiveSpec`;
``TuningSession`` consumes :class:`EvalBackend`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Protocol, Sequence, Tuple, Union, runtime_checkable

Config = Dict[str, Any]
RawResult = Dict[str, float]


class TuningFailure(RuntimeError):
    """Raised by an evaluation backend when a configuration crashes / times out.

    ``transient=True`` marks failures caused by environment faults (injected
    chaos, lost segments, flaky builds) rather than the configuration itself:
    the session retries those with backoff instead of telling the tuner
    worst-value feedback, so the GP only ever sees genuine config faults.
    """

    def __init__(self, message: str = "", transient: bool = False):
        super().__init__(message)
        self.transient = bool(transient)


EvalResult = Union[RawResult, TuningFailure]


# ---------------------------------------------------------------------------
# Objective specifications
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """What a tuner maximizes: named objectives + the raw-result transform.

    ``transform`` maps a backend's raw measurement dict to the objective
    vector in ``names`` order. ``directions`` is one of ``"max"``/``"min"``
    per objective; the MOBO core currently maximizes, so minimized objectives
    must be negated inside the transform (``directions`` then documents the
    original sense). ``rlim`` carries the recall-floor user preference:
    tuners that support constraint mode (VDTuner's CEI, Eq. 7) adopt it as
    their default floor.
    """

    name: str
    names: Tuple[str, ...] = ("speed", "recall")
    transform: Callable[[RawResult], Tuple[float, ...]] = None  # type: ignore[assignment]
    directions: Tuple[str, ...] = ()
    rlim: float | None = None

    def __post_init__(self):
        if self.transform is None:
            object.__setattr__(self, "transform", default_transform)
        if not self.directions:
            object.__setattr__(self, "directions", ("max",) * len(self.names))
        if len(self.directions) != len(self.names):
            raise ValueError(
                f"{self.name}: {len(self.names)} objective names but "
                f"{len(self.directions)} directions"
            )
        bad = set(self.directions) - {"max", "min"}
        if bad:
            raise ValueError(f"{self.name}: invalid directions {sorted(bad)}")

    @property
    def n_objectives(self) -> int:
        return len(self.names)

    def __call__(self, raw: RawResult) -> Tuple[float, ...]:
        return tuple(self.transform(raw))


def default_transform(result: RawResult) -> Tuple[float, float]:
    return float(result["speed"]), float(result["recall"])


def cost_aware_transform(eta: float = 1.0) -> Callable[[RawResult], Tuple[float, float]]:
    """Eq. 8: QP$ = speed / (eta * memory GiB). Any resource/price function can
    be swapped in here; NPI normalization makes the tuner invariant to eta."""

    def tf(result: RawResult) -> Tuple[float, float]:
        mem = max(float(result.get("mem_gib", 1.0)), 1e-9)
        return float(result["speed"]) / (eta * mem), float(result["recall"])

    return tf


def speed_recall() -> ObjectiveSpec:
    """Paper Eq. 1: maximize (search speed, recall) jointly."""
    return ObjectiveSpec(name="speed_recall")


def recall_floor(rlim: float) -> ObjectiveSpec:
    """§IV-F user preference: maximize speed subject to recall >= ``rlim``.

    Tuners with a constraint mode (VDTuner) switch to CEI (Eq. 7); others
    still see both objectives and simply report feasible bests.
    """
    if not 0.0 < rlim <= 1.0:
        raise ValueError(f"rlim must be in (0, 1], got {rlim}")
    return ObjectiveSpec(name=f"recall_floor@{rlim:g}", rlim=float(rlim))


def cost_aware(eta: float = 1.0, rlim: float | None = None) -> ObjectiveSpec:
    """Eq. 8 cost-effectiveness: maximize (QP$, recall), optionally floored."""
    return ObjectiveSpec(
        name=f"cost_aware@{eta:g}",
        names=("qpd", "recall"),
        transform=cost_aware_transform(eta),
        rlim=rlim,
    )


def sustained_transform(alpha: float = 1.0) -> Callable[[RawResult], Tuple[float, float]]:
    """Streaming-replay transform: *sustained* throughput charges the
    incremental seal / compaction index-build seconds against serving time
    (weighted by ``alpha``), so configs that seal tiny segments constantly
    can't fake high search-only QPS. Falls back to plain ``speed`` for raw
    results without the streaming diagnostics (static measurements)."""

    def tf(result: RawResult) -> Tuple[float, float]:
        n = float(result.get("n_searches", 0.0))
        if n <= 0.0:
            return float(result["speed"]), float(result["recall"])
        busy = float(result.get("search_s", 0.0)) + alpha * float(result.get("seal_build_s", 0.0))
        return n / max(busy, 1e-9), float(result["recall"])

    return tf


def streaming_sustained(alpha: float = 1.0, rlim: float | None = None) -> ObjectiveSpec:
    """Streaming regime: maximize (sustained QPS, time-aware recall).

    ``alpha`` is the ingest-overhead weight: 0 reproduces search-only QPS;
    1 (default) counts every incremental build second as lost serving time.
    """
    return ObjectiveSpec(
        name=f"streaming@{alpha:g}",
        names=("sustained_qps", "recall"),
        transform=sustained_transform(alpha),
        rlim=rlim,
    )


def promotion_score(
    raw: RawResult, rlim: float | None = None, alpha: float = 1.0
) -> Tuple[float, float]:
    """SLO-constrained lexicographic score for shadow/canary comparisons.

    Returns ``(feasible, value)`` meant for tuple comparison: a config
    meeting the recall floor always beats one that does not; among feasible
    configs sustained QPS decides (``alpha`` weighs ingest overhead exactly
    as in :func:`sustained_transform`); among infeasible configs the higher
    recall wins — the least-bad candidate while the floor is unreachable.
    The serving controller promotes a canary iff its score strictly exceeds
    the incumbent's.
    """
    qps, recall = sustained_transform(alpha)(raw)
    feasible = rlim is None or recall >= rlim
    return (1.0 if feasible else 0.0, qps if feasible else recall)


#: Registry of built-in objective factories (name -> factory).
OBJECTIVES: Dict[str, Callable[..., ObjectiveSpec]] = {
    "speed_recall": speed_recall,
    "recall_floor": recall_floor,
    "cost_aware": cost_aware,
    "streaming": streaming_sustained,
}


def spec_from_transform(
    transform: Callable[[RawResult], Tuple[float, ...]] | None,
) -> ObjectiveSpec:
    """Back-compat shim: wrap a bare ``transform`` callable (the old API) in an
    anonymous :class:`ObjectiveSpec`."""
    if transform is None or transform is default_transform:
        return speed_recall()
    return ObjectiveSpec(name="custom", transform=transform)


# ---------------------------------------------------------------------------
# Evaluation backends
# ---------------------------------------------------------------------------
@runtime_checkable
class EvalBackend(Protocol):
    """A measurement service: per-config evaluation + vectorized batches.

    ``__call__`` measures one configuration and returns the raw result dict
    (raising :class:`TuningFailure` for crashed configs). ``evaluate_batch``
    measures many, returning one entry per input config aligned with the
    input — either the raw dict or the ``TuningFailure`` instance; it never
    raises per-config (callers decide failure semantics).
    """

    def __call__(self, config: Config) -> RawResult: ...

    def evaluate_batch(self, configs: Sequence[Config]) -> List[EvalResult]: ...


class SequentialBatchMixin:
    """Default adapter: gives any per-config callable the batch half of the
    :class:`EvalBackend` protocol by evaluating sequentially.

    Backends with real batch structure (dedupe, threaded builds, vectorized
    measurement — see ``VDMSTuningEnv``) override ``evaluate_batch``; plain
    environments like ``ServeTuningEnv`` inherit this one for free.
    """

    def evaluate_batch(self, configs: Sequence[Config]) -> List[EvalResult]:
        out: List[EvalResult] = []
        for cfg in configs:
            try:
                out.append(self(cfg))  # type: ignore[operator]
            except TuningFailure as e:
                out.append(e)
        return out


class _CallableBackend(SequentialBatchMixin):
    """Wraps a bare objective function into a full :class:`EvalBackend`."""

    def __init__(self, fn: Callable[[Config], RawResult]):
        self._fn = fn

    def __call__(self, config: Config) -> RawResult:
        return self._fn(config)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_CallableBackend({self._fn!r})"


def as_eval_backend(objective: Callable[[Config], RawResult]) -> EvalBackend:
    """Upgrade ``objective`` to the full protocol. Objects that already expose
    ``evaluate_batch`` are returned unchanged."""
    if hasattr(objective, "evaluate_batch"):
        return objective  # type: ignore[return-value]
    return _CallableBackend(objective)
