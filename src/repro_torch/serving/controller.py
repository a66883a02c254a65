"""The autonomous serving control plane: SLO-guarded shadow/canary retune
(the counterpart of the JAX package's ``serving/controller.py``; the loop is
numpy over the port's ``LiveVDMS``, and every engine, shadow build and
retune environment it creates runs on ``device`` with the build ``draws``
it was given).

:class:`ServingController` wraps a live serving instance and a
:class:`~repro_torch.core.session.TuningSession` into a closed loop:

1. **Serve + observe** — replay live traffic through the primary instance,
   feeding per-query latencies, recall probes and lifecycle stats into the
   metrics ledger and the :class:`~repro_torch.serving.slo.SLOMonitor`.
2. **Trigger** — at control ticks, evaluate the SLO guardrails (and an
   optional :class:`~repro_torch.core.session.DriftDetector` fed with the same
   live window); any breach or drift firing triggers a re-tune.
3. **Retune in shadow** — snapshot the session, re-enter BO on a trailing
   window of the live trace (``TuningSession.retune``), build the candidate
   config as a *shadow* instance bootstrapped from the primary's visible
   vectors (build cost charged via the analytic model), and mirror a slice
   of live traffic to both instances (dual-index, the pgvector migration
   pattern).
4. **Promote or roll back** — after the canary window, compare both arms on
   the SLO-constrained :func:`~repro_torch.core.objectives.promotion_score`.
   A winning shadow becomes the primary (the old index is dropped); a losing
   one is dropped and the session checkpoint is restored **bit-identically**
   (``TuningSession.load_state_dict``) — as if the candidate never existed.

Trace timestamps are normalized to [0, 1]; the report scales time-integrated
quantities (SLO violation time, recall-under-floor time) by
``trace_minutes`` so they read as violation-minutes.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.objectives import promotion_score
from ..core.session import DriftDetector, TuningSession
from ..device import resolve_device
from ..kernels.ref import _total_order
from ..vdms.datasets import recall_at_k_masked
from ..vdms.engine import LiveVDMS
from ..vdms.faults import FaultError, FaultInjector, FaultPlan, ShadowBuildOOM
from ..vdms.tuning_env import VDMSTuningEnv
from ..vdms.workload import (
    OP_INSERT,
    OP_SEARCH,
    WorkloadTrace,
    time_aware_ground_truth,
)
from .metrics import (
    MetricsLedger,
    attach_live,
    attach_straggler,
    observe_stats,
    serving_ledger,
)
from .slo import SLOMonitor, SLOSpec


def visible_topk(all_vecs: torch.Tensor, queries: np.ndarray, searchable: np.ndarray,
                 k: int) -> np.ndarray:
    """Exact top-k of ``queries`` over the rows of ``all_vecs`` (a tensor
    already on the device) where the bool mask ``searchable`` is True, -1
    padded where fewer than ``k`` rows are searchable: the numpy
    ``exact_topk_masked`` of the JAX package's controller, as one matrix
    product on the device a block of queries. Equal scores keep the lowest
    row: each score's total-order key and its row form one int64 key, so a
    top-k of those keys is exact without sorting every row."""
    n = all_vecs.shape[0]
    out = -np.ones((queries.shape[0], k), np.int32)
    k_eff = min(k, int(np.count_nonzero(searchable)))
    if k_eff == 0:
        return out
    dev = all_vecs.device
    dead = torch.from_numpy(~np.asarray(searchable, bool)).to(dev)
    low = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=dev)  # lower row, larger key
    step = max(1, (1 << 25) // n)  # bounds the (rows, n) key block
    for lo in range(0, queries.shape[0], step):
        q = torch.from_numpy(np.ascontiguousarray(queries[lo : lo + step])).to(dev)
        sims = (q @ all_vecs.T).masked_fill(dead, float("-inf"))
        keys = (_total_order(sims).to(torch.int64) << 32) | low
        top = torch.topk(keys, k_eff, dim=1).values
        out[lo : lo + step, :k_eff] = ((n - 1) - (top & 0xFFFFFFFF)).cpu().numpy()
    return out


class GidMappedVDMS:
    """A :class:`LiveVDMS` addressed by trace-global ids.

    A shadow instance is bootstrapped mid-trace from the primary's visible
    vectors, so its local id space is dense while the trace speaks global
    ids; this wrapper carries the local<->global maps for inserts, deletes
    and search results. The initial primary uses the same wrapper with an
    identity bootstrap, so both arms run one code path. (Engine gids are
    stable across tombstones and compaction — survivors keep their ids — so
    the maps never go stale.) ``device`` and ``draws`` go to the
    ``LiveVDMS`` (``None``: the GPU and the port's own draws).
    """

    def __init__(
        self,
        config: Dict[str, Any],
        dim: int,
        capacity: int,
        seed: int = 0,
        compact_threshold: float = 0.3,
        device=None,
        draws=None,
    ):
        self.config = dict(config)
        self.live = LiveVDMS(
            config, dim, capacity, seed=seed, compact_threshold=compact_threshold,
            device=device, draws=draws,
        )
        # local -> global; the extra sentinel slot keeps -1 mapping to -1
        self._gid_of = np.full(capacity + 1, -1, np.int64)
        self._local_of: Dict[int, int] = {}
        self._identity = True  # every local id so far is its own global id

    def bootstrap(self, vectors: np.ndarray, gids: np.ndarray) -> None:
        gids = np.asarray(gids, np.int64)
        if vectors.shape[0] != gids.shape[0]:
            raise ValueError("bootstrap vectors/gids length mismatch")
        self.live.bootstrap(vectors)
        self._gid_of[: gids.size] = gids
        self._local_of = {int(g): i for i, g in enumerate(gids)}
        self._identity = bool(np.array_equal(gids, np.arange(gids.size)))

    def insert(self, gid: int, vec: np.ndarray) -> None:
        loc = int(self.live.insert(vec)[0])
        self._gid_of[loc] = int(gid)
        self._local_of[int(gid)] = loc
        self._identity = self._identity and loc == int(gid)

    def delete(self, gid: int) -> bool:
        loc = self._local_of.get(int(gid), -1)
        return self.live.delete(loc) if loc >= 0 else False

    def search(
        self, queries: np.ndarray, topk: int, mode: str = "analytic"
    ) -> Tuple[np.ndarray, float]:
        ids, secs = self.live.search(queries, topk, mode=mode)
        out = np.where(ids >= 0, self._gid_of[ids], -1).astype(np.int32)
        return out, secs

    def visible_gids(self) -> np.ndarray:
        """Trace-global ids of every vector currently visible to searches."""
        local = self.live.visible_ids()
        return self._gid_of[local].astype(np.int64)

    def searchable_gids(self) -> np.ndarray:
        """Trace-global ids a search can return *right now* — excludes
        quarantined segments and the graceful-window-hidden tail. This is the
        visible set honest degraded-mode recall is scored against."""
        local = self.live.searchable_ids()
        return self._gid_of[local].astype(np.int64)

    def searchable_mask(self, n: int) -> np.ndarray:
        """:meth:`searchable_gids` as a bool mask over ``n`` trace-global
        ids. While every local id is its own global id (an instance
        bootstrapped from ``arange`` and fed the trace's inserts in order, as
        the initial primary is) the engine's own mask is that mask, with no
        gather over the ids."""
        local = self.live.searchable_mask()
        if self._identity:
            return local[:n]
        out = np.zeros(n, bool)
        n_loc = self.live.n_total
        out[self._gid_of[:n_loc][local[:n_loc]]] = True
        return out


def mirror_count(credit: float, fraction: float, n: int) -> Tuple[int, float]:
    """Exact deterministic mirror subsample for one canary flush.

    Accumulates ``fraction * n`` mirror credit, mirrors the integer part and
    carries the fractional remainder to the next flush — so over many small
    flushes the mirrored share converges to ``fraction`` exactly, instead of
    per-flush ceil-rounding (which on small flushes mirrors everything
    regardless of the configured fraction). ``fraction=1.0`` reduces to
    ``(n, 0.0)`` exactly.
    """
    total = credit + fraction * n
    m = int(total)
    return m, total - m


@dataclasses.dataclass(frozen=True)
class ControllerParams:
    """Control-loop knobs (op counts are trace operations, not seconds)."""

    check_every: int = 48  # ops between control ticks
    cooldown_ops: int = 96  # no new trigger this many ops after a decision
    retune_iters: int = 8  # fresh BO evaluations per retune
    retune_window_ops: int = 400  # trailing trace window the retune env replays
    min_window_searches: int = 12  # skip retune when the window has no signal
    canary_queries: int = 48  # mirrored queries before promote-or-rollback
    traffic_mirror: float = 1.0  # fraction of each canary flush mirrored
    canary_feedback: bool = True  # tell both arms' live measurements to the tuner
    alpha: float = 1.0  # ingest weight in the promotion score
    min_win_margin: float = 0.0  # candidate must beat primary by this rel. margin
    build_amortize_queries: int = 10_000  # horizon the shadow build is amortized over
    floor_margin: float = 0.01  # extra recall headroom required on the retune window
    repair_anchors: bool = True  # reanchor retunes with breach-repair variants
    # breach-storm hysteresis: each consecutive rollback multiplies the
    # post-rollback cooldown (capped), so a latency storm that keeps failing
    # canaries cannot thrash the controller into a retune loop
    storm_cooldown_factor: float = 2.0
    storm_cooldown_cap_ops: int = 1024

    def __post_init__(self):
        if not 0.0 < self.traffic_mirror <= 1.0:
            raise ValueError(
                f"traffic_mirror must be in (0, 1], got {self.traffic_mirror}"
            )
        if min(self.canary_queries, self.retune_iters, self.check_every) < 1:
            raise ValueError("canary_queries, retune_iters, check_every must be >= 1")
        if self.storm_cooldown_factor < 1.0 or self.storm_cooldown_cap_ops < 1:
            raise ValueError(
                "need storm_cooldown_factor >= 1 and storm_cooldown_cap_ops >= 1"
            )


class _Canary:
    """One in-flight canary: the shadow arm plus mirrored-slice stats."""

    def __init__(self, shadow: GidMappedVDMS, snapshot: Dict[str, Any], op: int):
        self.shadow = shadow
        self.snapshot = snapshot
        self.started_op = op
        self.mirrored = 0
        # fractional-mirror accumulator: traffic_mirror * flush_size credit
        # carries across flushes so small flushes don't round up to 100%
        self.mirror_credit = 0.0
        self.primary_lat: List[float] = []
        self.shadow_lat: List[float] = []
        self.primary_recall: List[float] = []
        self.shadow_recall: List[float] = []
        self.primary_seal0 = 0.0
        self.shadow_seal0 = 0.0


class ServingController:
    """Autonomous SLO-guarded serving over a live workload trace.

    Parameters
    ----------
    slo:
        The declarative guardrails (:class:`SLOSpec`).
    session:
        A :class:`TuningSession` whose tuner supplies retune candidates; its
        backend is swapped to a trailing-window streaming env at each retune.
        Optional when serving with ``guard=False`` (monitor-only baseline).
    detector:
        Optional :class:`DriftDetector` fed with windowed live metrics at
        every control tick — drift then triggers retunes alongside breaches.
    ledger:
        Metrics ledger; a fresh :func:`serving_ledger` by default.
    mode:
        ``"analytic"`` (deterministic cost model; default) or ``"wall"``.
    trace_minutes:
        Wall-clock minutes one unit of normalized trace time represents —
        the scale behind ``violation_minutes`` in the report.
    device:
        Where every live engine, shadow build, retune window replay and
        visible-set oracle runs (``None``: the GPU, raising without one).
    draws:
        The class of the build draws handed to every engine and retune
        environment (``None``: the port's own ``BuildDraws``).
    """

    def __init__(
        self,
        slo: SLOSpec,
        session: Optional[TuningSession] = None,
        detector: Optional[DriftDetector] = None,
        ledger: Optional[MetricsLedger] = None,
        params: Optional[ControllerParams] = None,
        mode: str = "analytic",
        seed: int = 0,
        trace_minutes: float = 60.0,
        compact_threshold: float = 0.3,
        outcome_hook: Optional[
            Callable[[str, Dict[str, Any], Dict[str, Any]], None]
        ] = None,
        device=None,
        draws=None,
    ):
        self.slo = slo
        self.device = resolve_device(device)
        self.draws = draws
        self.session = session
        self.detector = detector
        self.ledger = ledger if ledger is not None else serving_ledger()
        self.params = params if params is not None else ControllerParams()
        self.mode = mode
        self.seed = int(seed)
        self.trace_minutes = float(trace_minutes)
        self.compact_threshold = float(compact_threshold)
        # optional (kind, config, raw) callback fired after each canary
        # decision — the fleet ledger's promote/rollback outcome feed
        self.outcome_hook = outcome_hook
        self.monitor = SLOMonitor(slo)
        self.timeline: List[Dict[str, Any]] = []
        self.n_retunes = 0
        self.n_promotes = 0
        self.n_rollbacks = 0
        # lifecycle counter offsets across promotes (ledger counters stay
        # monotone even though a fresh instance's counts restart at zero)
        self._life_off = {
            "n_seals": 0.0,
            "n_compactions": 0.0,
            "n_quarantines": 0.0,
            "n_rebuilds": 0.0,
            "n_rebuild_failures": 0.0,
            "n_seal_retries": 0.0,
        }
        # fault-injection state (None unless serve() is given a FaultPlan):
        # one primary-scoped injector rides across promotes, one shadow-scoped
        # injector persists across canaries (so a shadow OOM fires once)
        self._primary_injector: Optional[FaultInjector] = None
        self._shadow_injector: Optional[FaultInjector] = None
        self._consec_rollbacks = 0
        self._straggler = None
        self._last_snapshot: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    # session snapshot / rollback (checkpoint-exact)
    # ------------------------------------------------------------------
    def _snapshot(self) -> Dict[str, Any]:
        return {
            "state": copy.deepcopy(self.session.state_dict()),
            "backend": self.session.backend,
        }

    def _restore(self, snap: Dict[str, Any]) -> None:
        self.session.load_state_dict(snap["state"])
        self.session.backend = snap["backend"]

    def _event(self, kind: str, op: int, t: float, **extra: Any) -> None:
        self.timeline.append({"event": kind, "op": int(op), "time": float(t), **extra})

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def serve(
        self,
        trace: WorkloadTrace,
        config: Dict[str, Any],
        ground_truth: Optional[np.ndarray] = None,
        guard: bool = True,
        fault_plan: Optional[FaultPlan] = None,
    ) -> Dict[str, Any]:
        """Replay ``trace`` under the control loop, starting from ``config``.

        ``guard=False`` runs the monitor-only baseline: identical serving,
        SLO accounting and ledger, but breaches never trigger retunes — the
        frozen arm the serving benchmark compares against.

        ``fault_plan`` arms chaos: a primary-scoped injector on the serving
        engine (riding across promotes) and a shadow-scoped one shared by
        every canary build. The controller then additionally tracks engine
        health transitions, aborts canaries struck by faults mid-mirror
        (checkpoint-exact), applies breach-storm hysteresis after rollbacks,
        and scores every flush's *visible-set* recall against the brute-force
        oracle restricted to searchable vectors (on ``device``, with the
        trace's vectors uploaded once).
        """
        if guard and self.session is None:
            raise ValueError("guarded serving requires a session (tuner) to retune with")
        p = self.params
        k = trace.k
        gt = (
            ground_truth
            if ground_truth is not None
            else time_aware_ground_truth(trace, k, device=self.device)
        )
        primary = GidMappedVDMS(
            config, trace.dim, trace.capacity, seed=self.seed,
            compact_threshold=self.compact_threshold, device=self.device, draws=self.draws,
        )
        primary.bootstrap(trace.base, np.arange(trace.n_base))
        attach_live(self.ledger, primary.live)
        self._straggler = attach_straggler(self.ledger, primary.live, self._straggler)
        all_vecs: Optional[torch.Tensor] = None
        flush_vis: List[Dict[str, Any]] = []
        coverage_min = 1.0
        if fault_plan is not None:
            self._primary_injector = FaultInjector(fault_plan, scope="primary")
            self._shadow_injector = FaultInjector(fault_plan, scope="shadow")
            primary.live.arm_faults(self._primary_injector)
            all_vecs = torch.from_numpy(trace.all_vectors()).to(self.device)
        config = dict(config)
        config_history = [{"op": 0, "time": 0.0, "config": dict(config)}]

        preds = -np.ones((trace.n_searches, k), np.int32)
        lat_all: List[np.ndarray] = []
        search_s = 0.0
        canary: Optional[_Canary] = None
        pending: List[int] = []
        last_tick_op = 0
        last_tick_time = 0.0
        cooldown_until = -1
        last_health = "healthy"
        violation_time = 0.0
        recall_floor_time = 0.0
        breached_now = False
        recall_breached_now = False
        recall_probe = self.ledger.histogram("vdms_recall_probe")

        def promote(c: _Canary, op_i: int, t: float, p_score, c_score) -> None:
            nonlocal primary, config, cooldown_until
            stats = primary.live.stats()
            for key in self._life_off:
                self._life_off[key] += stats.get(key, 0)
            primary = c.shadow  # the old index is dropped here
            config = dict(c.shadow.config)
            attach_live(self.ledger, primary.live)
            self._straggler = attach_straggler(
                self.ledger, primary.live, self._straggler
            )
            if self._primary_injector is not None:
                # the promoted engine carried the shadow-scoped injector while
                # it was a canary; the primary fault clock takes over now
                primary.live.arm_faults(self._primary_injector)
            config_history.append(
                {"op": int(op_i), "time": float(t), "config": dict(config)}
            )
            self.n_promotes += 1
            self._consec_rollbacks = 0
            self.ledger.counter("vdms_promote_total").inc()
            self.monitor.reset()
            if self.detector is not None:
                self.detector.reset()
            cooldown_until = op_i + p.cooldown_ops
            self._event(
                "promote", op_i, t,
                primary_score=list(p_score), candidate_score=list(c_score),
            )

        def rollback(c: _Canary, op_i: int, t: float, p_score, c_score) -> None:
            nonlocal cooldown_until
            self._restore(c.snapshot)
            self.n_rollbacks += 1
            self._consec_rollbacks += 1
            self.ledger.counter("vdms_rollback_total").inc()
            cooldown_until = op_i + self._rollback_cooldown()
            self._event(
                "rollback", op_i, t,
                primary_score=list(p_score), candidate_score=list(c_score),
            )

        def abort_canary(op_i: int, t: float, reason: str) -> None:
            # a fault struck mid-mirror: the comparison is contaminated, so
            # drop the shadow and restore the session checkpoint-exactly —
            # hysteresis cooldown applies (a storm must not thrash retunes)
            nonlocal canary, cooldown_until
            self._restore(canary.snapshot)
            self.n_rollbacks += 1
            self._consec_rollbacks += 1
            self.ledger.counter("vdms_rollback_total").inc()
            self.ledger.counter("vdms_canary_fault_abort_total").inc()
            cooldown_until = op_i + self._rollback_cooldown()
            self._event("canary_fault_abort", op_i, t, reason=reason)
            canary = None

        def decide(c: _Canary, op_i: int, t: float) -> None:
            nonlocal canary
            p_busy = float(np.sum(c.primary_lat))
            c_busy = float(np.sum(c.shadow_lat))
            p_seal = max(primary.live.seal_build_model_s - c.primary_seal0, 0.0)
            c_seal = max(c.shadow.live.seal_build_model_s - c.shadow_seal0, 0.0)
            # the shadow's bootstrap build cost, amortized over the horizon a
            # promoted config is expected to live (the analytic build model)
            amort = c.mirrored / max(p.build_amortize_queries, 1)
            c_build = c.shadow.live.bootstrap_build_model_s * amort
            n = float(c.mirrored)
            p_raw = {
                "speed": n / max(p_busy, 1e-12),
                "recall": float(np.mean(c.primary_recall)),
                "n_searches": n,
                "search_s": p_busy,
                "seal_build_s": p_seal,
            }
            c_raw = {
                "speed": n / max(c_busy, 1e-12),
                "recall": float(np.mean(c.shadow_recall)),
                "n_searches": n,
                "search_s": c_busy,
                "seal_build_s": c_seal + c_build,
            }
            p_score = promotion_score(p_raw, rlim=self.slo.recall_floor, alpha=p.alpha)
            c_score = promotion_score(c_raw, rlim=self.slo.recall_floor, alpha=p.alpha)
            wins = c_score[0] > p_score[0] or (
                c_score[0] == p_score[0]
                and c_score[1] > p_score[1] * (1.0 + p.min_win_margin)
            )
            incumbent = dict(config)
            if wins:
                promote(c, op_i, t, p_score, c_score)
                outcome = "promote"
            else:
                rollback(c, op_i, t, p_score, c_score)
                outcome = "rollback"
            # feed both arms' live measurements into the tuner as external
            # tells — after promote/rollback, so a rollback's checkpoint
            # restore cannot wipe them; bootstrap=True keeps these free
            # byproducts of serving out of the fresh-evaluation budget
            # (they feed the GP and fronts, not the recommend/eval ledger)
            if p.canary_feedback and self.session is not None:
                self.session.tell(incumbent, dict(p_raw), bootstrap=True)
                self.session.tell(dict(c.shadow.config), dict(c_raw), bootstrap=True)
            if self.outcome_hook is not None:
                self.outcome_hook(outcome, dict(c.shadow.config), dict(c_raw))
            canary = None

        def flush(op_i: int) -> None:
            nonlocal search_s, coverage_min
            if not pending:
                return
            rows = np.asarray(pending, np.int64)
            pending.clear()
            q = trace.queries[rows]
            ids, secs = primary.search(q, k, mode=self.mode)
            lat = primary.live.last_latencies
            preds[rows] = ids
            lat_all.append(lat)
            search_s += secs
            self.monitor.observe_query(lat)
            recall = float(recall_at_k_masked(ids[:, :k], gt[rows, :k]))
            self.monitor.observe_recall(recall)
            recall_probe.observe(recall)
            self.monitor.observe_mem(primary.live.memory_gib())
            if fault_plan is not None:
                # honest degraded-mode accounting: score this flush against
                # the brute-force oracle restricted to the vectors a search
                # could actually have returned (searchable = visible minus
                # quarantined segments minus the graceful-hidden tail)
                cov = float(primary.live.last_coverage)
                coverage_min = min(coverage_min, cov)
                self.ledger.gauge("vdms_coverage").set(cov)
                svis = primary.searchable_mask(all_vecs.shape[0])
                vis_gt = visible_topk(all_vecs, q, svis, k)
                vrecall = float(recall_at_k_masked(ids[:, :k], vis_gt[:, :k]))
                flush_vis.append(
                    {
                        "op": int(op_i),
                        "rows": int(rows.size),
                        "visible": int(np.count_nonzero(svis)),
                        "coverage": cov,
                        "recall": vrecall,
                    }
                )
            if canary is not None:
                t_now = float(trace.times[min(op_i, trace.n_ops - 1)])
                if fault_plan is not None and (
                    primary.live.quarantined or primary.live._pending_seal is not None
                ):
                    abort_canary(op_i, t_now, "primary_fault")
                    return
                m, canary.mirror_credit = mirror_count(
                    canary.mirror_credit, p.traffic_mirror, rows.size
                )
                if m == 0:
                    return  # mirror credit carries into the next flush
                try:
                    s_ids, _ = canary.shadow.search(q[:m], k, mode=self.mode)
                except FaultError:
                    abort_canary(op_i, t_now, "shadow_fault")
                    return
                canary.primary_lat.extend(lat[:m].tolist())
                canary.shadow_lat.extend(canary.shadow.live.last_latencies.tolist())
                canary.primary_recall.append(
                    float(recall_at_k_masked(ids[:m, :k], gt[rows[:m], :k]))
                )
                canary.shadow_recall.append(
                    float(recall_at_k_masked(s_ids[:, :k], gt[rows[:m], :k]))
                )
                canary.mirrored += m
                if canary.mirrored >= p.canary_queries:
                    t = float(trace.times[min(op_i, trace.n_ops - 1)])
                    decide(canary, op_i, t)

        def control_tick(op_i: int, t: float) -> None:
            nonlocal last_tick_op, last_tick_time, violation_time, canary
            nonlocal recall_floor_time, breached_now, recall_breached_now
            nonlocal last_health, cooldown_until
            # integrate violation time over the elapsed interval first: the
            # state observed at the previous tick held for [last_tick, now)
            dt = max(t - last_tick_time, 0.0)
            if breached_now:
                violation_time += dt
            if recall_breached_now:
                recall_floor_time += dt
            status = self.monitor.evaluate(at_time=t)
            breached_now = not status.ok
            recall_breached_now = "recall_floor" in status.breaches
            if not status.ok:
                self.ledger.counter("vdms_slo_breach_total").inc()
                self._event(
                    "breach", op_i, t, breaches=list(status.breaches),
                    p99=status.p99_latency_s, recall=status.recall,
                )
            drift_fired = False
            if self.detector is not None and status.n_latency_samples > 0:
                probe = {
                    "speed": status.n_latency_samples
                    / max(float(np.sum(self.monitor._lat)), 1e-12),
                    "recall": status.recall,
                }
                if self.session is not None:
                    drift_fired = self.session.probe_drift(
                        self.detector, config, raw=probe
                    )
                else:
                    drift_fired = self.detector.observe(probe)
                if drift_fired:
                    self._event("drift", op_i, t)
            stats = primary.live.stats()
            adj = dict(stats)
            for key, off in self._life_off.items():
                adj[key] = stats.get(key, 0) + off
            observe_stats(self.ledger, adj)
            health = primary.live.health()
            if health != last_health:
                self._event("health", op_i, t, state=health, prev=last_health)
                last_health = health
            last_tick_op, last_tick_time = op_i, t
            if not guard or canary is not None or op_i < cooldown_until:
                return
            if status.ok and not drift_fired:
                return
            try:
                canary = self._start_canary(trace, config, primary, op_i, t)
            except ShadowBuildOOM as e:
                # the shadow build itself blew up: restore the pre-retune
                # checkpoint so the session is as if the retune never ran,
                # and back off (hysteresis) before trying again
                self._restore(self._last_snapshot)
                self.n_rollbacks += 1
                self._consec_rollbacks += 1
                self.ledger.counter("vdms_rollback_total").inc()
                self.ledger.counter("vdms_canary_fault_abort_total").inc()
                cooldown_until = op_i + self._rollback_cooldown()
                self._event("canary_aborted_oom", op_i, t, reason=str(e))
                canary = None

        # --- replay -------------------------------------------------------
        for i in range(trace.n_ops):
            kind = int(trace.kinds[i])
            t = float(trace.times[i])
            if kind == OP_SEARCH:
                pending.append(int(trace.payload[i]))
            else:
                flush(i)
                row = int(trace.payload[i])
                if kind == OP_INSERT:
                    # the j-th insert op creates global id n_base + j, and
                    # insert payloads are assigned sequentially: gid follows
                    gid = trace.n_base + row
                    primary.insert(gid, trace.inserts[row])
                    if canary is not None:
                        canary.shadow.insert(gid, trace.inserts[row])
                else:
                    primary.delete(row)
                    if canary is not None:
                        canary.shadow.delete(row)
            if i - last_tick_op >= p.check_every:
                flush(i)
                control_tick(i, t)
        flush(trace.n_ops - 1)
        t_end = float(trace.times[-1]) if trace.n_ops else 1.0
        control_tick(trace.n_ops - 1, t_end)
        if canary is not None:
            # the trace ended mid-canary: decide on whatever mirrored traffic
            # accumulated, or abort back to the incumbent (checkpoint-exact)
            if canary.mirrored > 0:
                decide(canary, trace.n_ops - 1, t_end)
            else:
                self._restore(canary.snapshot)
                self.n_rollbacks += 1
                self.ledger.counter("vdms_rollback_total").inc()
                self._event("canary_aborted", trace.n_ops - 1, t_end)
                canary = None

        # --- report -------------------------------------------------------
        lats = np.concatenate(lat_all) if lat_all else np.empty(0, np.float64)
        p50, p99 = (
            np.percentile(lats, (50.0, 99.0)) if lats.size else (0.0, 0.0)
        )
        overall_recall = float(
            recall_at_k_masked(preds[:, :k], gt[:, :k]) if trace.n_searches else 0.0
        )
        report_extra: Dict[str, Any] = {"health": primary.live.health()}
        if fault_plan is not None:
            stats = primary.live.stats()
            n_rows = sum(f["rows"] for f in flush_vis)
            report_extra["visible_recall"] = (
                float(sum(f["recall"] * f["rows"] for f in flush_vis) / n_rows)
                if n_rows
                else 1.0
            )
            report_extra["flush_visibility"] = flush_vis
            report_extra["fault"] = {
                "plan": fault_plan.to_dict(),
                "n_injected": int(
                    self._primary_injector.n_injected
                    + self._shadow_injector.n_injected
                ),
                "n_quarantines": int(
                    stats["n_quarantines"] + self._life_off["n_quarantines"]
                ),
                "n_rebuilds": int(
                    stats["n_rebuilds"] + self._life_off["n_rebuilds"]
                ),
                "n_rebuild_failures": int(
                    stats["n_rebuild_failures"]
                    + self._life_off["n_rebuild_failures"]
                ),
                "n_seal_retries": int(
                    stats["n_seal_retries"] + self._life_off["n_seal_retries"]
                ),
                "n_canary_fault_aborts": int(
                    self.ledger.counter("vdms_canary_fault_abort_total").value
                ),
                "coverage_min": float(coverage_min),
            }
        return {
            **report_extra,
            "guard": bool(guard),
            "trace": trace.name,
            "n_ops": int(trace.n_ops),
            "n_searches": int(trace.n_searches),
            "recall": overall_recall,
            "search_s": float(search_s),
            "speed": float(trace.n_searches / max(search_s, 1e-9)),
            "lat_p50_s": float(p50),
            "lat_p99_s": float(p99),
            "slo": self.slo.to_dict(),
            "violation_time": float(violation_time),
            "violation_minutes": float(violation_time * self.trace_minutes),
            "recall_under_floor_time": float(recall_floor_time),
            "recall_under_floor_minutes": float(recall_floor_time * self.trace_minutes),
            "n_breach_events": len(self.monitor.events),
            "n_retunes": int(self.n_retunes),
            "n_promotes": int(self.n_promotes),
            "n_rollbacks": int(self.n_rollbacks),
            "config_history": config_history,
            "timeline": copy.deepcopy(self.timeline),
            "final_stats": primary.live.stats(),
        }

    def _rollback_cooldown(self) -> int:
        """Post-rollback cooldown with breach-storm hysteresis: doubles (by
        ``storm_cooldown_factor``) per consecutive rollback, capped."""
        p = self.params
        n = max(self._consec_rollbacks, 1) - 1
        return int(
            min(
                p.cooldown_ops * p.storm_cooldown_factor**n,
                p.storm_cooldown_cap_ops,
            )
        )

    # ------------------------------------------------------------------
    # retune + canary start
    # ------------------------------------------------------------------
    def _start_canary(
        self,
        trace: WorkloadTrace,
        config: Dict[str, Any],
        primary: GidMappedVDMS,
        op_i: int,
        t: float,
    ) -> Optional[_Canary]:
        """Retune on the trailing trace window; on a genuinely new candidate,
        build it as a shadow instance and open the canary. Returns None when
        the window is too thin or the tuner retains the incumbent."""
        p = self.params
        lo = max(0, op_i - p.retune_window_ops)
        window = trace.window(lo, op_i)
        if window.n_searches < p.min_window_searches:
            self._event("retune_skipped", op_i, t, reason="window has too few searches")
            return None
        snap = self._snapshot()
        self._last_snapshot = snap
        env = VDMSTuningEnv(
            trace=window,
            workload="streaming",
            mode=self.mode,
            seed=self.seed,
            n_phases=1,
            compact_threshold=self.compact_threshold,
            device=self.device,
            draws=self.draws,
        )
        self.session.backend = env
        anchors = (
            self._repair_anchors(config) if p.repair_anchors else [dict(config)]
        )
        self.session.retune(p.retune_iters, reanchor=anchors)
        self.n_retunes += 1
        self.ledger.counter("vdms_retune_total").inc()
        # window replays bootstrap the visible state as fully-indexed sealed
        # segments, which flatters recall vs the live sliding window — demand
        # a margin above the floor before a candidate is considered feasible
        rlim = self.slo.recall_floor
        if rlim is not None:
            rlim = min(1.0, rlim + p.floor_margin)
        candidate = self.session.tuner.best_config(rlim=rlim)
        if candidate is None or self._canon(candidate) == self._canon(config):
            # the incumbent is still the best the tuner can find: no canary,
            # but the freshly-learned surrogate state is kept
            self._event("retune_retained", op_i, t)
            return None
        shadow = self._build_shadow(trace, candidate, primary)
        self._event(
            "canary_start", op_i, t, candidate=dict(candidate),
            shadow_build_model_s=float(shadow.live.bootstrap_build_model_s),
        )
        self.ledger.counter("vdms_shadow_build_seconds_total").inc(
            float(shadow.live.bootstrap_build_model_s)
        )
        c = _Canary(shadow, snap, op_i)
        c.primary_seal0 = primary.live.seal_build_model_s
        c.shadow_seal0 = shadow.live.seal_build_model_s
        return c

    def _repair_anchors(self, config: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The incumbent plus breach-repair variants, re-measured first under
        the current window (they flow through ``retune``'s reanchor path).

        The variants are a DBA's playbook for recall breaches, not a search:
        open the bounded-consistency window fully (``graceful_time`` at its
        minimum — drifted queries hit the newest, unindexed inserts hardest)
        and widen the per-segment merge. BO still explores beyond them.
        """
        anchors = [dict(config)]
        space = getattr(self.session.tuner, "space", None)
        if space is None:
            return anchors
        by_name = {q.name: q for q in space.system_params}

        def bound(q, hi: bool = False):
            if q.kind in ("grid", "cat"):
                return q.choices[-1] if hi else q.choices[0]
            return q.high if hi else q.low

        g = by_name.get("graceful_time")
        if g is not None and "graceful_time" in config:
            full_vis = dict(config, graceful_time=bound(g))
            anchors.append(full_vis)
            w = by_name.get("topk_merge_width")
            if w is not None and "topk_merge_width" in config:
                anchors.append(dict(full_vis, topk_merge_width=bound(w, hi=True)))
        seen = set()
        out = []
        for a in anchors:
            key = self._canon(a)
            if key not in seen:
                seen.add(key)
                out.append(a)
        return out

    def _build_shadow(
        self, trace: WorkloadTrace, candidate: Dict[str, Any], primary: GidMappedVDMS
    ) -> GidMappedVDMS:
        vis = primary.visible_gids()
        shadow = GidMappedVDMS(
            candidate, trace.dim, trace.capacity,
            seed=self.seed + 1 + self.n_retunes,
            compact_threshold=self.compact_threshold,
            device=self.device,
            draws=self.draws,
        )
        if self._shadow_injector is not None:
            # armed before bootstrap so a scheduled shadow OOM can strike the
            # canary build itself (the injector persists across canaries)
            shadow.live.arm_faults(self._shadow_injector)
        shadow.bootstrap(trace.all_vectors()[vis], vis)
        return shadow

    @staticmethod
    def _canon(cfg: Dict[str, Any]) -> Tuple:
        return tuple(
            (k, round(v, 6) if isinstance(v, float) else v)
            for k, v in sorted(cfg.items())
        )
