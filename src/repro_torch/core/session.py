"""`TuningSession`: one loop that runs every tuner.

The session owns everything the ask/tell recommenders do not: evaluation
dispatch (sequential, vectorized ``evaluate_batch``, or a pluggable
executor), the worst-value failure feedback path, stop conditions, the
recommend/eval time ledger, callbacks, and serializable checkpoints.

Lifecycle::

        ┌──────────────── TuningSession.run(n) ────────────────┐
        │                                                      │
        │   cfgs = tuner.ask(remaining)      # pure recommender │
        │   results = executor(backend, cfgs)  # EvalBackend    │
        │   for cfg, result in zip(cfgs, results):              │
        │       tuner.tell(cfg, result)      # + ledger, cbs    │
        │                                                      │
        └── until budget met / tuner exhausted / StopSession ──┘

Checkpointing: ``session.state_dict()`` captures the tuner state (history,
RNG, polling/abandon state, §IV-F bootstrap observations, and — for
warm-started tuners — the previous GP fit's hyperparameters, so resumed
warm refits are bit-identical) plus the session's own in-flight state —
configurations that were asked but not yet told — as a JSON-compatible
dict. ``TuningSession.restore(state, tuner)`` resumes
bit-identically: the pending queue is re-evaluated first (deterministic
backends, e.g. the cached ``VDMSTuningEnv``, reproduce the same results),
then recommendation continues from the exact saved RNG state.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .objectives import EvalBackend, TuningFailure
from .space import Config
from .tuner import Observation, TunerBase

STATE_VERSION = 1
LEDGER_SCHEMA = 1

Callback = Callable[["TuningSession", Observation], None]


class StopSession(Exception):
    """Raised from a callback (or executor) to stop the session cleanly.

    The session stays consistent: every already-told observation is kept and
    the not-yet-told remainder of the current round survives in the pending
    queue, so ``state_dict()`` right after the stop checkpoints mid-round.
    """


# ---------------------------------------------------------------------------
# Workload drift detection (the re-tune trigger)
# ---------------------------------------------------------------------------
class DriftDetector:
    """Detects workload drift from repeated probes of a fixed configuration.

    The deployed incumbent is periodically re-measured through the backend
    (:meth:`TuningSession.probe_drift`); the first ``warmup`` probes after a
    (re)set establish the per-metric reference, and a later probe *fires*
    when any watched metric deviates from its reference by more than
    ``rel_threshold`` relative — the signal that the optimum may have moved
    and the session should re-enter BO (:meth:`TuningSession.retune`).

    State is JSON-compatible (``state_dict``/``load_state_dict``) so drift
    tracking can ride in session checkpoints.
    """

    def __init__(
        self,
        metrics: Sequence[str] = ("speed", "recall"),
        rel_threshold: float = 0.2,
        warmup: int = 1,
    ):
        if rel_threshold <= 0:
            raise ValueError(f"rel_threshold must be > 0, got {rel_threshold}")
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.metrics = tuple(metrics)
        self.rel_threshold = float(rel_threshold)
        self.warmup = int(warmup)
        self.reference: Optional[Dict[str, float]] = None
        self._ref_buf: List[Dict[str, float]] = []
        self.n_fired = 0
        self.log: List[Dict[str, Any]] = []

    def observe(self, raw: Dict[str, float]) -> bool:
        """Feed one probe measurement; returns True when drift fired."""
        vals = {m: float(raw[m]) for m in self.metrics}
        if self.reference is None:
            self._ref_buf.append(vals)
            if len(self._ref_buf) >= self.warmup:
                self.reference = {
                    m: sum(v[m] for v in self._ref_buf) / len(self._ref_buf)
                    for m in self.metrics
                }
                self._ref_buf = []
            self.log.append({"metrics": vals, "rel": 0.0, "fired": False})
            return False
        rel = max(
            abs(vals[m] - self.reference[m]) / max(abs(self.reference[m]), 1e-12)
            for m in self.metrics
        )
        fired = rel > self.rel_threshold
        if fired:
            self.n_fired += 1
        self.log.append({"metrics": vals, "rel": float(rel), "fired": bool(fired)})
        return fired

    def reset(self) -> None:
        """Restart reference collection (call after re-tuning re-deploys)."""
        self.reference = None
        self._ref_buf = []

    # --- checkpointing (JSON-compatible) --------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "metrics": list(self.metrics),
            "rel_threshold": self.rel_threshold,
            "warmup": self.warmup,
            "reference": dict(self.reference) if self.reference is not None else None,
            "ref_buf": [dict(v) for v in self._ref_buf],
            "n_fired": self.n_fired,
            "log": copy.deepcopy(self.log),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "DriftDetector":
        self.metrics = tuple(state["metrics"])
        self.rel_threshold = float(state["rel_threshold"])
        self.warmup = int(state["warmup"])
        ref = state.get("reference")
        self.reference = {k: float(v) for k, v in ref.items()} if ref is not None else None
        self._ref_buf = [dict(v) for v in state.get("ref_buf", [])]
        self.n_fired = int(state.get("n_fired", 0))
        self.log = copy.deepcopy(state.get("log", []))
        return self


# ---------------------------------------------------------------------------
# Transient-failure retry policy (the honest failure taxonomy's session half)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a session treats *transient* :class:`TuningFailure`s.

    A transient failure (environment fault — lost segment, flaky build,
    injected chaos — not the configuration's doing) is retried up to
    ``max_retries`` times with exponential backoff before falling through to
    the tuner's worst-value failure feedback; a retried-and-recovered
    evaluation is told as a *normal* observation with the wasted attempts'
    wall time charged to its build seconds, so the GP never learns from
    faults it cannot control. ``eval_timeout_s`` bounds each evaluation's
    wall clock (a timeout is itself a transient failure).
    """

    max_retries: int = 2
    backoff_s: float = 0.25  # first retry delay (seconds); 0 disables sleeping
    backoff_factor: float = 2.0
    eval_timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("need backoff_s >= 0 and backoff_factor >= 1")
        if self.eval_timeout_s is not None and self.eval_timeout_s <= 0:
            raise ValueError(f"eval_timeout_s must be > 0, got {self.eval_timeout_s}")

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        return self.backoff_s * self.backoff_factor ** max(attempt - 1, 0)


class _TimeoutBackend:
    """Per-evaluation wall-clock timeout wrapper around an EvalBackend.

    Deliberately does NOT expose ``evaluate_batch``: a vectorized batch
    cannot be timed out per config, so batch executors fall back to their
    sequential path through this proxy. On timeout the worker thread is
    abandoned (``shutdown(wait=False)``) rather than joined — the stuck
    evaluation keeps running to completion in the background, but the
    session moves on with a *transient* :class:`TuningFailure`.
    """

    def __init__(self, backend: EvalBackend, timeout_s: float):
        self._backend = backend
        self._timeout_s = float(timeout_s)

    def __call__(self, cfg: Config) -> Any:
        ex = ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(self._backend, cfg)
        try:
            return fut.result(timeout=self._timeout_s)
        except FuturesTimeout:
            raise TuningFailure(
                f"evaluation timed out after {self._timeout_s:.3g}s", transient=True
            ) from None
        finally:
            ex.shutdown(wait=False)


# ---------------------------------------------------------------------------
# Evaluation executors
# ---------------------------------------------------------------------------
class SequentialExecutor:
    """Evaluate one config at a time through ``backend(cfg)`` — results are
    yielded as they land, so observations are told (and checkpointable)
    between evaluations."""

    name = "sequential"

    def execute(self, backend: EvalBackend, cfgs: Sequence[Config]) -> Iterator[Tuple[Any, float]]:
        for cfg in cfgs:
            t0 = time.perf_counter()
            try:
                result: Any = backend(cfg)
            except TuningFailure as e:
                result = e
            yield result, time.perf_counter() - t0


class BatchExecutor:
    """Vectorized dispatch through the backend's ``evaluate_batch``.

    Mirrors the pre-redesign batch path exactly: single-config rounds and
    backends without ``evaluate_batch`` fall back to sequential evaluation;
    batch eval time is amortized per config.
    """

    name = "batch"

    def execute(self, backend: EvalBackend, cfgs: Sequence[Config]) -> Iterator[Tuple[Any, float]]:
        eb = getattr(backend, "evaluate_batch", None)
        if eb is None or len(cfgs) == 1:
            yield from SequentialExecutor().execute(backend, cfgs)
            return
        t0 = time.perf_counter()
        results = eb(list(cfgs))
        per_cfg = (time.perf_counter() - t0) / max(len(cfgs), 1)
        for result in results:
            yield result, per_cfg


class ThreadedExecutor:
    """Concurrent per-config evaluation in a thread pool, yielded in config
    order — for backends whose evaluations are independent and release the
    GIL (network-attached VDMS replicas, subprocess benchmarks)."""

    name = "threaded"

    def __init__(self, max_workers: Optional[int] = None):
        self.max_workers = max_workers

    def execute(self, backend: EvalBackend, cfgs: Sequence[Config]) -> Iterator[Tuple[Any, float]]:
        def one(cfg: Config) -> Tuple[Any, float]:
            t0 = time.perf_counter()
            try:
                result: Any = backend(cfg)
            except TuningFailure as e:
                result = e
            return result, time.perf_counter() - t0

        workers = self.max_workers or min(max(len(cfgs), 1), os.cpu_count() or 4)
        if len(cfgs) <= 1 or workers == 1:
            yield from (one(c) for c in cfgs)
            return
        with ThreadPoolExecutor(max_workers=workers) as ex:
            yield from ex.map(one, cfgs)


_EXECUTORS = {
    "sequential": SequentialExecutor,
    "batch": BatchExecutor,
    "auto": BatchExecutor,  # batch when available, sequential otherwise
    "threaded": ThreadedExecutor,
}

ExecutorLike = Union[str, None, SequentialExecutor, BatchExecutor, ThreadedExecutor, Any]


def resolve_executor(executor: ExecutorLike, tuner: TunerBase):
    if executor is None:
        executor = tuner.preferred_executor()
    if isinstance(executor, str):
        try:
            return _EXECUTORS[executor]()
        except KeyError:
            raise ValueError(
                f"unknown executor {executor!r}; choose from {sorted(_EXECUTORS)} "
                "or pass an object with .execute(backend, cfgs)"
            ) from None
    if not hasattr(executor, "execute"):
        raise TypeError(f"executor must expose .execute(backend, cfgs), got {executor!r}")
    return executor


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------
class TuningSession:
    """Drives one tuner against one evaluation backend.

    Parameters
    ----------
    tuner:
        Any ask/tell recommender (``VDTuner`` or a baseline).
    backend:
        The evaluation service (``EvalBackend``). Defaults to the tuner's
        own ``objective`` for the legacy construction style.
    executor:
        ``"sequential"`` | ``"batch"`` | ``"auto"`` | ``"threaded"``, an
        object with ``.execute(backend, cfgs)``, or ``None`` to use the
        tuner's ``preferred_executor()`` (which reproduces pre-redesign
        dispatch exactly).
    callbacks:
        Callables ``cb(session, observation)`` invoked after every told
        observation — checkpoint hooks, progress bars, early stopping (raise
        :class:`StopSession`).
    retry:
        Optional :class:`RetryPolicy`. When set, *transient* failures are
        retried with backoff (and each evaluation is wall-clock bounded by
        ``eval_timeout_s``) before any worst-value feedback reaches the
        tuner. ``None`` (default) reproduces pre-policy behavior exactly.
    """

    def __init__(
        self,
        tuner: TunerBase,
        backend: Optional[EvalBackend] = None,
        executor: ExecutorLike = None,
        callbacks: Sequence[Callback] = (),
        retry: Optional[RetryPolicy] = None,
    ):
        self.tuner = tuner
        self.backend = backend if backend is not None else tuner.objective
        if self.backend is None:
            raise ValueError("no evaluation backend: pass backend= or construct the tuner with an objective")
        self.executor = resolve_executor(executor, tuner)
        self.callbacks: List[Callback] = list(callbacks)
        self.retry = retry
        self.rounds: List[Dict[str, Any]] = []
        self._pending: List[Config] = []
        self._pending_recommend_s = 0.0
        # per-config transient-retry bookkeeping, keyed by canonical config
        # JSON: {"attempts", "wasted_s", "backoff_s"} — JSON-compatible so it
        # checkpoints (a resume mid-retry continues the backoff schedule)
        self._retry_state: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------
    # progress views
    # ------------------------------------------------------------------
    @property
    def history(self) -> List[Observation]:
        return self.tuner.history

    @property
    def n_observations(self) -> int:
        """Fresh (non-bootstrap) observations — the budget currency."""
        return sum(1 for o in self.tuner.history if not o.bootstrap)

    @property
    def pending(self) -> List[Config]:
        """Asked-but-not-yet-told configurations (read-only copy)."""
        return [dict(c) for c in self._pending]

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def run(
        self,
        n_iters: int,
        max_wall_s: Optional[float] = None,
        stop: Optional[Callable[["TuningSession"], bool]] = None,
    ) -> "TuningSession":
        """Run until ``n_iters`` fresh observations (counting any restored
        ones), the wall-clock budget, a ``stop`` predicate, tuner exhaustion
        (empty ask), or a :class:`StopSession` from a callback.

        A round already in flight is always drained before stop conditions
        are re-checked, so a mandatory warm-up batch may overshoot the budget
        — exactly like the pre-redesign tuner loops.
        """
        t_start = time.perf_counter()
        try:
            while True:
                if self._pending:
                    self._drain()
                    continue
                if self.n_observations >= n_iters:
                    break
                if max_wall_s is not None and time.perf_counter() - t_start >= max_wall_s:
                    break
                if stop is not None and stop(self):
                    break
                t0 = time.perf_counter()
                cfgs = list(self.tuner.ask(n_iters - self.n_observations))
                ask_s = time.perf_counter() - t0
                if not cfgs:
                    break  # recommender exhausted (e.g. DefaultOnly)
                self._pending = cfgs
                self._pending_recommend_s = ask_s / len(cfgs)
                self.rounds.append(
                    {"round": len(self.rounds), "n_asked": len(cfgs), "ask_s": ask_s, "evals": []}
                )
        except StopSession:
            pass
        return self

    def _drain(self) -> None:
        """Evaluate the pending queue, telling each result as it lands.

        ``_pending`` is popped before callbacks fire, so a checkpoint taken
        from a callback (or after a :class:`StopSession`) holds exactly the
        not-yet-told remainder.
        """
        cfgs = list(self._pending)
        backend = self.backend
        if self.retry is not None:
            self._sleep_backoff(cfgs[0])
            if self.retry.eval_timeout_s is not None:
                backend = _TimeoutBackend(self.backend, self.retry.eval_timeout_s)
        for result, eval_s in self.executor.execute(backend, cfgs):
            cfg = self._pending[0]
            retries = 0
            if self.retry is not None:
                if self._note_transient(cfg, result, eval_s):
                    # the config stays at the head of the pending queue; the
                    # run() loop re-enters _drain, which sleeps the backoff
                    # and re-evaluates — the tuner never hears about it
                    return
                retries, result, eval_s = self._charge_retries(cfg, result, eval_s)
            obs = self.tuner.tell(
                cfg, result, recommend_time=self._pending_recommend_s, eval_time=eval_s
            )
            self._pending.pop(0)
            self._ledger_obs(obs, eval_s, retries)
            for cb in self.callbacks:
                cb(self, obs)

    # --- transient-retry plumbing (no-ops unless a RetryPolicy is set) ---
    @staticmethod
    def _cfg_key(cfg: Config) -> str:
        return json.dumps(cfg, sort_keys=True, default=repr)

    def _sleep_backoff(self, cfg: Config) -> None:
        st = self._retry_state.get(self._cfg_key(cfg))
        if st is not None and st.get("backoff_s", 0.0) > 0.0:
            time.sleep(st["backoff_s"])
            st["backoff_s"] = 0.0  # consumed; re-set if the retry fails again

    def _note_transient(self, cfg: Config, result: Any, eval_s: float) -> bool:
        """Record a transient failure; True = retry (leave cfg pending)."""
        if not (isinstance(result, TuningFailure) and getattr(result, "transient", False)):
            return False
        key = self._cfg_key(cfg)
        st = self._retry_state.setdefault(
            key, {"attempts": 0, "wasted_s": 0.0, "backoff_s": 0.0}
        )
        if st["attempts"] >= self.retry.max_retries:
            return False  # budget exhausted: fall through to failure feedback
        st["attempts"] += 1
        st["wasted_s"] += float(eval_s)
        st["backoff_s"] = self.retry.backoff(int(st["attempts"]))
        return True

    def _charge_retries(self, cfg: Config, result: Any, eval_s: float):
        """Fold a config's retry history into its final result: wasted wall
        time is charged to build seconds (the honest place — retries re-build
        the instance), and the eval time the ledger sees includes it."""
        st = self._retry_state.pop(self._cfg_key(cfg), None)
        if st is None:
            return 0, result, eval_s
        wasted = float(st["wasted_s"])
        eval_s = float(eval_s) + wasted
        if isinstance(result, dict):
            result = dict(result)
            if "seal_build_s" in result:
                result["seal_build_s"] = float(result["seal_build_s"]) + wasted
            elif "build_time" in result:
                result["build_time"] = float(result["build_time"]) + wasted
        return int(st["attempts"]), result, eval_s

    def _ledger_obs(self, obs: Observation, eval_s: float, retries: int = 0) -> None:
        if not self.rounds:  # restored mid-round: ledger continues in a fresh row
            self.rounds.append({"round": 0, "n_asked": 0, "ask_s": 0.0, "evals": []})
        row = {
            "iteration": int(obs.iteration),
            "recommend_s": float(obs.recommend_time),
            "eval_s": float(eval_s),
            "failed": bool(obs.failed),
        }
        if retries:  # only recovered-after-retry rows carry the key, so
            row["retries"] = int(retries)  # no-retry ledgers stay byte-identical
        self.rounds[-1]["evals"].append(row)

    # ------------------------------------------------------------------
    # external observations & fleet delegation
    # ------------------------------------------------------------------
    def tell(
        self,
        config: Config,
        result: Any,
        eval_time: float = 0.0,
        recommend_time: float = 0.0,
        bootstrap: bool = False,
        noise_scale: float = 1.0,
    ) -> Observation:
        """Feed one externally-measured result into the tuner.

        This is the entry point for observations the session did not itself
        dispatch: live canary measurements from the serving control plane,
        or another tenant's ledger rows during fleet transfer. The
        observation lands in the tuner history (feeding the GP, fronts, and
        abandon bookkeeping) but NOT in the recommend/eval ledger — it is
        deployment/transfer feedback, not a budgeted BO evaluation.
        ``bootstrap=True`` additionally keeps it out of the fresh-observation
        budget count; ``noise_scale > 1`` down-weights it in the GP fit.
        """
        obs = self.tuner.tell(
            dict(config), result, recommend_time=recommend_time, eval_time=eval_time
        )
        if bootstrap:
            obs.bootstrap = True
        if noise_scale != 1.0:
            obs.noise_scale = float(noise_scale)
        return obs

    def import_observations(
        self,
        observations: Sequence[Union[Observation, Dict[str, Any]]],
        noise_scale: float = 1.0,
        space_signature: Optional[str] = None,
    ) -> int:
        """Seed the tuner with observations from another session's ledger.

        Each observation is appended as a §IV-F-style *bootstrap* entry: it
        feeds the GP (marking its index type "seen", so warm-started tenants
        skip the mandatory per-type default evaluations) and the Pareto
        front, but never counts against the fresh-observation budget.
        Objective values are recomputed from ``raw`` through this tuner's
        own transform so imports land in local objective units; failed
        source rows are skipped. ``noise_scale`` (> 1 for cross-tenant
        imports) rides on each row into the GP's per-row noise hook.

        ``space_signature`` — the source space's ``encoding_signature()`` —
        guards the registry's uniform encoding: imports are refused unless
        it matches this tuner's space, since encoded rows would otherwise
        decode to different configurations.
        """
        if space_signature is not None:
            own = self.tuner.space.encoding_signature()
            if space_signature != own:
                raise ValueError(
                    f"cannot import observations: source space signature "
                    f"{space_signature!r} != target {own!r}"
                )
        n_imported = 0
        for o in observations:
            if isinstance(o, dict):
                o = Observation.from_dict(o)
            if o.failed:
                continue
            raw = dict(o.raw)
            try:
                y = np.asarray(self.tuner.transform(raw), np.float64) if raw else None
            except Exception:
                continue  # raw lacks what the local objective needs
            if y is None or not np.all(np.isfinite(y)):
                continue
            self.tuner.history.append(
                Observation(
                    iteration=len(self.tuner.history),
                    config=dict(o.config),
                    y=y,
                    raw=raw,
                    recommend_time=0.0,
                    eval_time=0.0,
                    failed=False,
                    bootstrap=True,
                    noise_scale=float(noise_scale),
                )
            )
            n_imported += 1
        return n_imported

    def run_round(self, n: int = 1) -> List[Observation]:
        """Run exactly one ask round (draining any restored pending queue
        first) and return the observations it produced.

        This is the fleet scheduler's unit of budget delegation: the
        ``FleetSession`` calls ``run_round`` on whichever tenant it picked,
        charges the returned observations' evaluation cost to the shared
        budget, and re-decides. ``n`` caps the batch request passed to
        ``ask`` (warm-up batches may exceed it, exactly as in ``run``).
        """
        start = len(self.tuner.history)
        try:
            if not self._pending:
                t0 = time.perf_counter()
                cfgs = list(self.tuner.ask(max(int(n), 1)))
                ask_s = time.perf_counter() - t0
                if not cfgs:
                    return []
                self._pending = cfgs
                self._pending_recommend_s = ask_s / len(cfgs)
                self.rounds.append(
                    {"round": len(self.rounds), "n_asked": len(cfgs), "ask_s": ask_s, "evals": []}
                )
            while self._pending:
                self._drain()
        except StopSession:
            pass
        return list(self.tuner.history[start:])

    # ------------------------------------------------------------------
    # drift tracking (moving-optimum workloads)
    # ------------------------------------------------------------------
    def probe_drift(
        self,
        detector: DriftDetector,
        config: Config,
        raw: Optional[Dict[str, float]] = None,
    ) -> bool:
        """Re-measure the deployed ``config`` through the backend and feed
        the drift detector. Probes live outside the tuning budget and the
        recommend/eval ledger — they are deployment monitoring, not BO
        iterations. An incumbent that now *fails* outright counts as drift.

        With ``raw`` given the backend is not called: the supplied
        measurement (e.g. the serving control plane's windowed live metrics)
        is judged directly, so probes can come from real traffic instead of
        a synthetic re-evaluation.
        """
        if raw is None:
            try:
                raw = self.backend(config)
            except TuningFailure:
                detector.n_fired += 1
                # finite sentinel keeps detector state/artifacts strict-JSON safe
                detector.log.append({"metrics": {}, "rel": 1e9, "fired": True, "failed": True})
                return True
        return detector.observe(raw)

    def retune(
        self,
        n_iters: int = 0,
        reanchor: Sequence[Config] = (),
        keep_stale: bool = False,
    ) -> int:
        """Re-enter BO after workload drift, warm-started where the knowledge
        still transfers.

        By default the stale observations are *dropped*: their measured
        objective values no longer describe the workload, and keeping them
        would wedge unreachable pre-drift points into the surrogate's front
        and its NPI normalization. What carries over is exactly what remains
        valid: the warm-started GP *hyperparameters* (``warm_start=True``
        tuners resume from the previous fit), while successive-abandon state
        resets so index types abandoned under the old workload get
        reconsidered. ``reanchor`` configs — typically the deployed Pareto
        set — are re-measured first under the current workload as the fresh
        foundation (they count as fresh observations and flow through the
        executor/ledger like any round). The evaluation backend decides what
        re-measurement means (the streaming ``VDMSTuningEnv`` keys its cache
        by phase, so configurations are genuinely re-evaluated after the
        workload moved).

        ``keep_stale=True`` instead demotes old observations to §IV-F-style
        bootstrap entries (they keep feeding the GP and keep every index
        type "seen" but stop counting against the budget) — the right mode
        when the objective *scale* is expected to survive the drift.

        Returns the number of stale observations handled; with
        ``n_iters > 0`` immediately runs until that many fresh evaluations
        (re-anchors included) have landed.
        """
        stale = sum(1 for o in self.tuner.history if not o.bootstrap)
        if keep_stale:
            for obs in self.tuner.history:
                obs.bootstrap = True
        else:
            self.tuner.history = []
        self._pending = []
        self._pending_recommend_s = 0.0
        self._retry_state = {}
        abandon = getattr(self.tuner, "abandon", None)
        if abandon is not None:
            self.tuner.abandon = type(abandon)(
                self.tuner.space.type_names, window=abandon.window
            )
        if reanchor:
            self._pending = [dict(c) for c in reanchor]
            self._pending_recommend_s = 0.0
            # a fresh ledger round: re-anchor evals are post-drift work
            self.rounds.append(
                {"round": len(self.rounds), "n_asked": len(self._pending), "ask_s": 0.0, "evals": []}
            )
            self._drain()
        if n_iters:
            self.run(n_iters)
        return stale

    # ------------------------------------------------------------------
    # ledger
    # ------------------------------------------------------------------
    def ledger_dict(self) -> Dict[str, Any]:
        """The recommend/eval time ledger with a stable schema (BENCH json
        ``session`` block)."""
        evals = [e for r in self.rounds for e in r["evals"]]
        recommend_s = float(sum(e["recommend_s"] for e in evals))
        totals = {
            "n_rounds": len(self.rounds),
            "n_evals": len(evals),
            "n_failures": sum(1 for e in evals if e["failed"]),
            "ask_s": float(sum(r["ask_s"] for r in self.rounds)),
            "recommend_s": recommend_s,
            # per-iteration recommendation overhead — the figure
            # bench_overhead tracks and CI gates
            "recommend_s_per_eval": recommend_s / max(len(evals), 1),
            "eval_s": float(sum(e["eval_s"] for e in evals)),
        }
        n_retries = sum(e.get("retries", 0) for e in evals)
        if n_retries:  # key appears only on fault-affected sessions, keeping
            totals["n_retries"] = int(n_retries)  # clean ledgers byte-identical
        return {
            "schema": LEDGER_SCHEMA,
            "tuner": self.tuner.name,
            "executor": getattr(self.executor, "name", type(self.executor).__name__),
            "rounds": copy.deepcopy(self.rounds),
            "totals": totals,
        }

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-compatible checkpoint: tuner state + in-flight session state."""
        return {
            "version": STATE_VERSION,
            "tuner": self.tuner.state_dict(),
            "pending": [dict(c) for c in self._pending],
            "pending_recommend_s": float(self._pending_recommend_s),
            "rounds": copy.deepcopy(self.rounds),
            # optional key (absent in older checkpoints): in-flight transient
            # retry bookkeeping, so a resume mid-retry keeps its backoff state
            "retry": copy.deepcopy(self._retry_state),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "TuningSession":
        """In-place restore of a ``state_dict()`` checkpoint onto this
        session (tuner state included); backend, executor and callbacks are
        untouched. This is the rollback half of the serving control plane's
        canary protocol: snapshot before a candidate retune, load back on a
        losing canary — bit-identical to never having retuned.
        """
        version = state.get("version")
        if version != STATE_VERSION:
            raise ValueError(f"unsupported session state version {version!r}")
        self.tuner.load_state_dict(state["tuner"])
        self._pending = [dict(c) for c in state.get("pending", [])]
        self._pending_recommend_s = float(state.get("pending_recommend_s", 0.0))
        self.rounds = copy.deepcopy(state.get("rounds", []))
        self._retry_state = copy.deepcopy(state.get("retry", {}))
        return self

    @classmethod
    def restore(
        cls,
        state: Dict[str, Any],
        tuner: TunerBase,
        backend: Optional[EvalBackend] = None,
        executor: ExecutorLike = None,
        callbacks: Sequence[Callback] = (),
        retry: Optional[RetryPolicy] = None,
    ) -> "TuningSession":
        """Rebuild a session from ``state_dict()`` output.

        ``tuner`` must be freshly constructed with the same constructor
        arguments as the checkpointed one (its mutable state — history, RNG,
        polling/abandon, bootstrap observations — is overwritten from the
        checkpoint). The continuation is bit-identical to an uninterrupted
        run for deterministic backends.
        """
        session = cls(tuner, backend=backend, executor=executor, callbacks=callbacks, retry=retry)
        return session.load_state_dict(state)


def checkpoint_every(
    path_fn: Callable[[int], str], every: int = 1
) -> Callback:
    """Convenience callback factory: JSON-dump ``session.state_dict()`` every
    ``every`` observations to ``path_fn(iteration)``."""
    import json

    def cb(session: TuningSession, obs: Observation) -> None:
        if session.n_observations % every == 0:
            with open(path_fn(obs.iteration), "w") as f:
                json.dump(session.state_dict(), f)

    return cb
