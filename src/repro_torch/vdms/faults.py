"""Deterministic fault injection for the live VDMS engine (the counterpart
of the JAX package's ``vdms/faults.py``: numpy only, the same plans, clock
and taxonomy; a configuration that exhausts device memory is a config
failure here, as ``XlaRuntimeError`` is there).

A :class:`FaultPlan` is a seeded, JSON-serializable schedule of faults —
segment loss/corruption, flaky index builds with fail-count schedules,
per-query latency storms, shadow-build OOMs. A :class:`FaultInjector`
replays one plan against a :class:`~repro_torch.vdms.engine.LiveVDMS`: the engine
calls ``advance()`` once per operation (its *fault clock*), ``on_build()``
on every segment build, and ``latency_shape()`` after timing each search
call. All hooks are gated behind ``LiveVDMS._faults is not None``, so the
no-fault fast path is byte-identical to an engine that never imported this
module.

Fault semantics (the degraded-mode contract the engine implements):

* ``segment_loss`` / ``segment_corruption`` — a sealed segment becomes
  unusable (corruption is *detected* via checksum and handled identically:
  the engine must never serve results from a corrupt index). The engine
  quarantines the segment — searches keep serving partial results from the
  surviving segments + growing tail, reporting a per-query ``coverage``
  fraction — and rebuilds it in the background from the authoritative
  vector store with bounded retry + exponential backoff.
* ``build_crash`` — arms a fail-count budget: the next ``fails`` segment
  builds (seals, compactions, or quarantine rebuilds) raise
  :class:`BuildCrashFault`. Failed seals retry with backoff instead of
  raising; a seal whose retries exhaust ``max_seal_retries`` raises
  :class:`TransientEngineFault` (the engine's "give up" signal, classified
  transient by the tuning taxonomy).
* ``latency_storm`` — every search inside ``[at_tick, at_tick +
  duration_ticks)`` has its measured chunk seconds scaled by
  ``latency_mult`` and padded by ``latency_add_s`` per query. Results are
  untouched: storms lie about time, never about answers.
* ``shadow_oom`` — the ``at_tick``-th bootstrap attempt in the injector's
  scope raises :class:`ShadowBuildOOM` (the serving controller aborts the
  canary and rolls back checkpoint-exact).

Determinism: a plan is fully materialized data; an injector's behavior is a
pure function of (plan, the engine's operation sequence), so replaying the
same trace against the same plan twice is bit-identical — property-tested
in ``tests/test_faults.py``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.objectives import TuningFailure

#: Engine health states (ordered by severity; ledger gauge codes).
HEALTH_STATES: Tuple[str, ...] = ("healthy", "rebuilding", "degraded")
HEALTH_CODE: Dict[str, int] = {s: i for i, s in enumerate(HEALTH_STATES)}

FAULT_KINDS: Tuple[str, ...] = (
    "segment_loss",
    "segment_corruption",
    "build_crash",
    "latency_storm",
    "shadow_oom",
)


class FaultError(RuntimeError):
    """Base class of every injected fault raised by a :class:`FaultInjector`."""


class BuildCrashFault(FaultError):
    """An injected segment-build crash (seal, compaction, or rebuild)."""


class ShadowBuildOOM(FaultError):
    """An injected out-of-memory during a shadow instance bootstrap."""


class TransientEngineFault(RuntimeError):
    """The degraded-mode engine exhausted its bounded repair budget.

    Raised (e.g.) when a seal keeps crashing past ``max_seal_retries`` —
    the environment classifies it as a *transient* :class:`TuningFailure`
    so the session retries the evaluation instead of poisoning the GP.
    """


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. Unused fields stay at their defaults (the JSON
    round-trip keeps every field, so plans are self-describing)."""

    kind: str
    at_tick: int = 0  # engine op tick the event arms (shadow_oom: bootstrap ordinal)
    segment: int = -1  # segment_loss/corruption: sealed segment (mod n_sealed at fire)
    fails: int = 1  # build_crash: consecutive build attempts to fail
    duration_ticks: int = 0  # latency_storm: window length in ticks
    latency_mult: float = 1.0  # latency_storm: chunk-seconds multiplier
    latency_add_s: float = 0.0  # latency_storm: added seconds per query
    note: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}")
        if self.at_tick < 0:
            raise ValueError(f"at_tick must be >= 0, got {self.at_tick}")
        if self.kind == "build_crash" and self.fails < 1:
            raise ValueError(f"build_crash needs fails >= 1, got {self.fails}")
        if self.kind == "latency_storm" and (
            self.duration_ticks < 1 or self.latency_mult < 1.0 or self.latency_add_s < 0.0
        ):
            raise ValueError(
                "latency_storm needs duration_ticks >= 1, latency_mult >= 1, latency_add_s >= 0"
            )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, JSON-serializable fault schedule + the repair-policy knobs
    the degraded-mode engine honors while the plan is armed."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    max_seal_retries: int = 6  # failed-seal retries before TransientEngineFault
    max_rebuild_retries: int = 4  # quarantine rebuild attempts before permanent degraded
    backoff_base_ticks: int = 4  # first retry delay; doubles per attempt

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if self.max_seal_retries < 0 or self.max_rebuild_retries < 0:
            raise ValueError("retry budgets must be >= 0")
        if self.backoff_base_ticks < 1:
            raise ValueError("backoff_base_ticks must be >= 1")

    # --- serialization (JSON round-trip is exact) ----------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": int(self.seed),
            "max_seal_retries": int(self.max_seal_retries),
            "max_rebuild_retries": int(self.max_rebuild_retries),
            "backoff_base_ticks": int(self.backoff_base_ticks),
            "events": [dataclasses.asdict(e) for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(
            events=tuple(FaultEvent(**e) for e in d.get("events", [])),
            seed=int(d.get("seed", 0)),
            max_seal_retries=int(d.get("max_seal_retries", 6)),
            max_rebuild_retries=int(d.get("max_rebuild_retries", 4)),
            backoff_base_ticks=int(d.get("backoff_base_ticks", 4)),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    # --- seeded generation ---------------------------------------------
    @classmethod
    def generate(
        cls,
        seed: int,
        horizon_ticks: int,
        n_events: int = 3,
        kinds: Tuple[str, ...] = ("segment_loss", "build_crash", "latency_storm"),
    ) -> "FaultPlan":
        """A random-but-reproducible plan: ``n_events`` faults of the given
        kinds, uniformly placed over ``horizon_ticks``. Same arguments →
        identical plan (the rng is derived from ``seed`` alone)."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(int(n_events)):
            kind = str(kinds[int(rng.integers(len(kinds)))])
            at = int(rng.integers(1, max(horizon_ticks, 2)))
            if kind in ("segment_loss", "segment_corruption"):
                events.append(FaultEvent(kind=kind, at_tick=at, segment=int(rng.integers(8))))
            elif kind == "build_crash":
                events.append(FaultEvent(kind=kind, at_tick=at, fails=int(rng.integers(1, 3))))
            elif kind == "latency_storm":
                events.append(
                    FaultEvent(
                        kind=kind,
                        at_tick=at,
                        duration_ticks=int(rng.integers(4, max(horizon_ticks // 4, 5))),
                        latency_mult=float(2 + 6 * rng.random()),
                        latency_add_s=float(1e-4 * rng.random()),
                    )
                )
            else:  # shadow_oom
                events.append(FaultEvent(kind=kind, at_tick=int(rng.integers(2))))
        events.sort(key=lambda e: (e.at_tick, e.kind))
        return cls(events=tuple(events), seed=int(seed))


def canned_fault_plans(horizon_ticks: int) -> Dict[str, FaultPlan]:
    """The three chaos schedules ``bench_chaos`` replays (scaled to the
    trace's op count): pure segment loss, flaky builds + a loss, and a
    latency storm + a shadow-build OOM striking the first canary."""
    h = max(int(horizon_ticks), 16)
    return {
        "segment_loss": FaultPlan(
            events=(
                FaultEvent(kind="segment_loss", at_tick=h // 4, segment=0),
                FaultEvent(kind="segment_corruption", at_tick=(3 * h) // 5, segment=2),
            ),
            seed=1,
        ),
        "flaky_builds": FaultPlan(
            events=(
                FaultEvent(kind="build_crash", at_tick=h // 6, fails=2),
                FaultEvent(kind="segment_loss", at_tick=h // 2, segment=1),
                FaultEvent(kind="build_crash", at_tick=(2 * h) // 3, fails=1),
            ),
            seed=2,
        ),
        "latency_storm": FaultPlan(
            events=(
                FaultEvent(
                    kind="latency_storm",
                    at_tick=h // 3,
                    duration_ticks=max(h // 6, 8),
                    latency_mult=8.0,
                    latency_add_s=2e-4,
                ),
                FaultEvent(kind="shadow_oom", at_tick=0),
                FaultEvent(kind="segment_loss", at_tick=(4 * h) // 5, segment=1),
            ),
            seed=3,
        ),
    }


class FaultInjector:
    """Replays one :class:`FaultPlan` against a live engine.

    ``scope`` selects which events this injector serves: ``"primary"``
    handles everything except ``shadow_oom``; ``"shadow"`` handles only
    ``shadow_oom`` (keyed by bootstrap ordinal, not ticks) — the serving
    controller arms one injector per role from the same plan.
    """

    def __init__(self, plan: FaultPlan, scope: str = "primary"):
        if scope not in ("primary", "shadow"):
            raise ValueError(f"scope must be 'primary' or 'shadow', got {scope!r}")
        self.plan = plan
        self.scope = scope
        self.tick = 0
        self.n_builds = 0
        self.n_bootstraps = 0
        self.n_injected = 0  # faults actually applied (crashes, losses, storms, ooms)
        self.fired: List[Dict[str, Any]] = []  # applied-event log (diagnostics)
        self._crash_budget = 0
        self._storm_until = -1
        self._storm_mult = 1.0
        self._storm_add = 0.0
        if scope == "shadow":
            self._oom_ordinals = {
                e.at_tick for e in plan.events if e.kind == "shadow_oom"
            }
            self._pending: List[FaultEvent] = []
        else:
            self._oom_ordinals = set()
            self._pending = sorted(
                (e for e in plan.events if e.kind != "shadow_oom"),
                key=lambda e: (e.at_tick, FAULT_KINDS.index(e.kind)),
            )
        self._next = 0  # index into _pending

    # ------------------------------------------------------------------
    def advance(self) -> List[FaultEvent]:
        """Advance the fault clock one engine operation; apply newly-due
        build-crash / latency-storm events and return the due segment
        loss/corruption events for the engine to quarantine."""
        self.tick += 1
        losses: List[FaultEvent] = []
        while self._next < len(self._pending) and self._pending[self._next].at_tick <= self.tick:
            e = self._pending[self._next]
            self._next += 1
            self.n_injected += 1
            self.fired.append({"tick": self.tick, "kind": e.kind, "note": e.note})
            if e.kind == "build_crash":
                self._crash_budget += e.fails
            elif e.kind == "latency_storm":
                self._storm_until = self.tick + e.duration_ticks
                self._storm_mult = float(e.latency_mult)
                self._storm_add = float(e.latency_add_s)
            else:  # segment_loss / segment_corruption
                losses.append(e)
        return losses

    @property
    def storm_active(self) -> bool:
        return self.tick < self._storm_until

    def latency_shape(self) -> Tuple[float, float]:
        """(multiplier, added seconds per query) for searches at this tick."""
        if self.storm_active:
            return self._storm_mult, self._storm_add
        return 1.0, 0.0

    def on_build(self, context: str = "seal") -> None:
        """Called by the engine before every segment build; raises
        :class:`BuildCrashFault` while the fail-count budget lasts."""
        self.n_builds += 1
        if self._crash_budget > 0:
            self._crash_budget -= 1
            self.fired.append({"tick": self.tick, "kind": "build_crash_hit", "note": context})
            raise BuildCrashFault(f"injected build crash during {context} (tick {self.tick})")

    def on_bootstrap(self, n_vectors: int) -> None:
        """Called before a bulk-load; the ``at_tick``-th bootstrap in a
        shadow-scoped injector raises :class:`ShadowBuildOOM`."""
        ordinal = self.n_bootstraps
        self.n_bootstraps += 1
        if ordinal in self._oom_ordinals:
            self.n_injected += 1
            self.fired.append({"tick": self.tick, "kind": "shadow_oom", "note": f"n={n_vectors}"})
            raise ShadowBuildOOM(
                f"injected OOM bootstrapping {n_vectors} vectors (attempt {ordinal})"
            )


# ---------------------------------------------------------------------------
# failure taxonomy (the tuning env routes evaluation errors through this)
# ---------------------------------------------------------------------------
def classify_eval_error(e: BaseException) -> Optional[TuningFailure]:
    """Map an evaluation-time exception to the honest failure taxonomy.

    * :class:`TuningFailure` passes through unchanged (already classified);
    * injected/engine faults (:class:`TransientEngineFault`,
      :class:`FaultError`) become *transient* failures — the session retries
      them instead of feeding the GP worst-value feedback;
    * config-dependent numeric/shape crashes (``ValueError``,
      ``ZeroDivisionError``, ``FloatingPointError``) and device-runtime
      errors (``torch.cuda.OutOfMemoryError`` — bad configs exhausting the
      card's memory) become genuine config failures;
    * anything else — programmer errors — returns ``None``: the caller must
      re-raise rather than swallow it into the GP.
    """
    if isinstance(e, TuningFailure):
        return e
    if isinstance(e, (TransientEngineFault, FaultError)):
        return TuningFailure(str(e), transient=True)
    if isinstance(e, (ValueError, ZeroDivisionError, FloatingPointError)):
        return TuningFailure(str(e))
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return TuningFailure(str(e))
    return None
