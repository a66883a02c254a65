"""VDTuner: polling multi-objective Bayesian optimization (paper Algorithm 1),
the port of the JAX package's ``core/tuner.py`` (same recommender, with the
GP and the fused acquisition in PyTorch on ``device``).

The tuner maximizes two objectives — (search speed, recall) by default, or
(QP$, recall) in cost-aware mode — over a `SearchSpace` whose tunable set
changes with the index type. Components:

* holistic GP surrogate over all index types (one copy of shared params),
* NPI polling normalization (Eq. 2–3),
* MC-EHVI acquisition with ref = 0.5 * per-type balanced base (Eq. 4),
* round-robin polling with successive abandon (Eq. 5–6, windowed trigger),
* optional recall-floor constraint mode with CEI (Eq. 7) and bootstrapping
  from previous constraint levels (§IV-F),
* batch-parallel rounds (``q > 1``): sequential-greedy q-EHVI / q-CEI with
  Kriging-believer fantasies. ``q == 1`` reproduces the original
  single-point trajectory exactly.

Ask/tell protocol
-----------------
Every tuner is a pure *recommender*: ``ask(n)`` proposes up to ``n``
configurations (it may exceed ``n`` for mandatory warm-up, e.g. the per-type
default sampling of Algorithm 1 lines 1–5, and may return fewer — or none,
signalling exhaustion). ``tell(config, result)`` feeds one result back:
either the raw measurement dict or a ``TuningFailure``; failures receive the
worst values in history at record time (paper §V-A). The tuner never calls
the objective itself — evaluation dispatch, budgets, the time ledger and
checkpointing belong to :class:`repro_torch.core.session.TuningSession`. The
legacy ``tuner.run(n)`` is a thin shim over a session and reproduces the
pre-redesign trajectory exactly (regression-tested).

Objectives are first-class (:mod:`repro_torch.core.objectives`): pass
``objective_spec=recall_floor(0.9)`` instead of the legacy bare ``transform``
callable; both remain accepted.

Checkpointing: ``state_dict()`` / ``load_state_dict()`` round-trip history,
RNG state, and polling/abandon state through JSON-compatible dicts so a
killed tuning run resumes bit-identically (see ``TuningSession.restore``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from .acquisition import cei, greedy_select, qehvi_sequential_greedy
from .acquisition_torch import fused_cei_select, fused_qehvi_select
from .budget import SuccessiveAbandon
from .gp import GP, GPParams
from .normalize import npi_normalize
from .objectives import (
    ObjectiveSpec,
    TuningFailure,
    cost_aware_transform,
    default_transform,
    spec_from_transform,
)
from .pareto import non_dominated_mask, pareto_front
from .space import Config, SearchSpace

__all__ = [
    "Observation", "TunerBase", "TuningFailure", "VDTuner",
    "cost_aware_transform", "default_transform",
]

Objective = Callable[[Config], Dict[str, float]]


@dataclasses.dataclass
class Observation:
    iteration: int
    config: Config
    y: np.ndarray  # (2,) raw objective values (speed-like, recall)
    raw: Dict[str, float]
    recommend_time: float
    eval_time: float
    failed: bool = False
    bootstrap: bool = False
    # GP observation-noise variance multiplier; > 1 for observations imported
    # from another tenant's ledger (fleet transfer), 1.0 for local measurements
    noise_scale: float = 1.0

    @property
    def index_type(self) -> str:
        return self.config["index_type"]

    # --- serialization (JSON-compatible) --------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {
            "iteration": int(self.iteration),
            "config": dict(self.config),
            "y": [float(v) for v in np.asarray(self.y).ravel()],
            "raw": {k: float(v) for k, v in self.raw.items()},
            "recommend_time": float(self.recommend_time),
            "eval_time": float(self.eval_time),
            "failed": bool(self.failed),
            "bootstrap": bool(self.bootstrap),
        }
        if self.noise_scale != 1.0:  # keep pre-fleet checkpoints byte-identical
            d["noise_scale"] = float(self.noise_scale)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Observation":
        return cls(
            iteration=int(d["iteration"]),
            config=dict(d["config"]),
            y=np.asarray(d["y"], np.float64),
            raw=dict(d["raw"]),
            recommend_time=float(d["recommend_time"]),
            eval_time=float(d["eval_time"]),
            failed=bool(d["failed"]),
            bootstrap=bool(d["bootstrap"]),
            noise_scale=float(d.get("noise_scale", 1.0)),
        )


class TunerBase:
    """Shared recommender bookkeeping: history + worst-value failure feedback.

    Subclasses implement ``ask``; ``tell`` is shared. ``objective`` is kept
    for the legacy self-driving path (``run`` / ``step``) and as the default
    backend when a ``TuningSession`` is built from the tuner alone — new code
    may pass ``objective=None`` and wire the backend into the session.
    """

    name = "base"

    def __init__(
        self,
        space: SearchSpace,
        objective: Optional[Objective] = None,
        seed: int = 0,
        transform: Optional[Callable[[Dict[str, float]], Tuple[float, float]]] = None,
        objective_spec: Optional[ObjectiveSpec] = None,
    ):
        if transform is not None and objective_spec is not None:
            raise ValueError("pass either transform= (legacy) or objective_spec=, not both")
        self.space = space
        self.objective = objective
        self.rng = np.random.default_rng(seed)
        self.spec = objective_spec if objective_spec is not None else spec_from_transform(transform)
        self.transform = self.spec.transform  # back-compat attribute
        self.history: List[Observation] = []
        self._seed = seed

    # ------------------------------------------------------------------
    # ask/tell protocol
    # ------------------------------------------------------------------
    def ask(self, n: int = 1) -> List[Config]:
        """Propose up to ``n`` configurations to evaluate next.

        May exceed ``n`` for mandatory warm-up batches and may return fewer;
        an empty list means the recommender is exhausted (e.g. ``DefaultOnly``
        after covering every index type).
        """
        raise NotImplementedError

    def tell(
        self,
        config: Config,
        result: Any,
        recommend_time: float = 0.0,
        eval_time: float = 0.0,
    ) -> Observation:
        """Feed back one evaluation result (raw dict or ``TuningFailure``)."""
        obs = self._record(config, result, recommend_time, eval_time)
        self._on_tell(obs)
        return obs

    def _on_tell(self, obs: Observation) -> None:
        """Subclass hook run after each observation lands (e.g. bandit credit)."""

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-compatible snapshot of all mutable tuner state.

        Constructor arguments (space, objective spec, hyperparameters) are
        NOT serialized — ``load_state_dict`` expects a tuner constructed with
        identical arguments, mirroring how model checkpoints work.
        """
        return {
            "tuner": self.name,
            "seed": self._seed,
            "rng": self.rng.bit_generator.state,
            "history": [o.to_dict() for o in self.history],
            "extra": self._extra_state(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "TunerBase":
        if state.get("tuner") != self.name:
            raise ValueError(
                f"state is for tuner {state.get('tuner')!r}, not {self.name!r}"
            )
        self.rng.bit_generator.state = state["rng"]
        self.history = [Observation.from_dict(d) for d in state["history"]]
        self._load_extra_state(state.get("extra", {}))
        return self

    def _extra_state(self) -> Dict[str, Any]:
        return {}

    def _load_extra_state(self, extra: Dict[str, Any]) -> None:
        pass

    # ------------------------------------------------------------------
    def _record(
        self, cfg: Config, result: Any, recommend_time: float, eval_time: float
    ) -> Observation:
        """Append one observation. ``result`` is either the raw objective dict
        or an Exception instance marking a failed evaluation (paper §V-A:
        failed configs get the worst values in history at record time)."""
        failed = False
        if isinstance(result, Exception):
            failed, raw, y = True, {}, self._worst_so_far()
        else:
            raw = result
            try:
                y = np.asarray(self.transform(raw), np.float64)
                if not np.all(np.isfinite(y)):
                    raise TuningFailure("non-finite objective")
            except TuningFailure:
                failed, raw, y = True, {}, self._worst_so_far()
        obs = Observation(
            iteration=len(self.history),
            config=cfg,
            y=y,
            raw=raw,
            recommend_time=recommend_time,
            eval_time=eval_time,
            failed=failed,
        )
        self.history.append(obs)
        return obs

    def _evaluate(self, cfg: Config, recommend_time: float) -> Observation:
        t0 = time.perf_counter()
        try:
            result: Any = self.objective(cfg)
        except TuningFailure as e:
            result = e
        return self._record(cfg, result, recommend_time, time.perf_counter() - t0)

    def _evaluate_batch(
        self, cfgs: Sequence[Config], recommend_time: float
    ) -> List[Observation]:
        """Evaluate a batch, preferring the objective's vectorized
        ``evaluate_batch`` (e.g. ``VDMSTuningEnv``) when it exposes one.

        Results are recorded in config order one at a time, so the worst-value
        fallback for failed configs sees exactly the history a sequential run
        would have seen. Single-config batches always take the sequential path
        (keeps q=1 behavior identical to the pre-batch tuner).
        """
        eb = getattr(self.objective, "evaluate_batch", None)
        if eb is None or len(cfgs) == 1:
            return [self._evaluate(c, recommend_time) for c in cfgs]
        t0 = time.perf_counter()
        results = eb(list(cfgs))
        per_cfg = (time.perf_counter() - t0) / max(len(cfgs), 1)
        return [self._record(c, r, recommend_time, per_cfg) for c, r in zip(cfgs, results)]

    def _worst_so_far(self) -> np.ndarray:
        ys = [o.y for o in self.history if not o.failed]
        if not ys:
            return np.array([1e-6, 1e-6])
        return np.min(np.stack(ys), axis=0)

    # --- views ----------------------------------------------------------
    @property
    def X_enc(self) -> np.ndarray:
        return np.stack([self.space.encode(o.config) for o in self.history])

    @property
    def Y(self) -> np.ndarray:
        return np.stack([o.y for o in self.history])

    @property
    def types(self) -> np.ndarray:
        return np.array([o.index_type for o in self.history])

    def pareto(self) -> np.ndarray:
        return pareto_front(self.Y)

    def best_speed_at_recall(self, rlim: float) -> float:
        """Best observed speed among configs with recall >= rlim (paper Fig. 6)."""
        ys = self.Y
        ok = ys[:, 1] >= rlim
        return float(ys[ok, 0].max()) if ok.any() else float("nan")

    def _deploy_pool(self) -> List[Observation]:
        """Observations eligible for deployment decisions: fresh (current
        workload) non-failed ones, falling back to bootstrap history when no
        fresh observation exists yet (e.g. right after ``retune``)."""
        ok = [o for o in self.history if not o.failed]
        fresh = [o for o in ok if not o.bootstrap]
        return fresh or ok

    def best_config(self, rlim: Optional[float] = None) -> Config:
        """Deployment incumbent: with a recall floor, the fastest feasible
        configuration; otherwise the knee of the observed front (max product
        of per-objective max-normalized values)."""
        pool = self._deploy_pool()
        if not pool:
            raise ValueError("no successful observations yet")
        ys = np.stack([o.y for o in pool])
        if rlim is not None:
            ok = ys[:, 1] >= rlim
            if ok.any():
                idx = np.flatnonzero(ok)[int(np.argmax(ys[ok, 0]))]
                return dict(pool[idx].config)
        norm = ys.max(axis=0)
        norm = np.where(norm <= 0, 1.0, norm)
        return dict(pool[int(np.argmax((ys / norm).prod(axis=1)))].config)

    def pareto_configs(self, max_n: Optional[int] = None) -> List[Config]:
        """Non-dominated configurations of the deployment pool (the set a
        deployment would keep live); ``max_n`` keeps the highest-knee-score
        subset when the front is larger."""
        pool = self._deploy_pool()
        if not pool:
            return []
        ys = np.stack([o.y for o in pool])
        nd = non_dominated_mask(ys)
        front = [o for o, keep in zip(pool, nd) if keep]
        if max_n is not None and len(front) > max_n:
            fy = np.stack([o.y for o in front])
            norm = fy.max(axis=0)
            norm = np.where(norm <= 0, 1.0, norm)
            score = (fy / norm).prod(axis=1)
            keep = np.argsort(-score, kind="stable")[:max_n]
            front = [front[i] for i in sorted(keep)]
        return [dict(o.config) for o in front]

    # ------------------------------------------------------------------
    # legacy self-driving shim
    # ------------------------------------------------------------------
    def preferred_executor(self) -> str:
        """Evaluation-dispatch policy reproducing this tuner's pre-ask/tell
        behavior when a session is built with ``executor=None``."""
        return "sequential"

    def run(self, n_iters: int) -> "TunerBase":
        """Legacy one-call runner: build a ``TuningSession`` over the tuner's
        own objective and run it. Kept as a thin shim; reproduces the
        pre-redesign observation sequence exactly."""
        from .session import TuningSession  # deferred: session imports tuner

        TuningSession(self).run(n_iters)
        return self


class _WarmGPMixin:
    """Shared GP warm-start machinery for surrogate-based tuners.

    ``warm_start=True`` (the kwarg every surrogate tuner exposes) threads
    the previous round's fitted hyperparameters into the next fit
    (``gp_warm_fit_steps`` Adam steps instead of a cold ``fit_steps``-step
    fit). The warm state is kept on device between rounds and serialized
    (exact f32 round-trip through JSON) by ``_warm_state`` /
    ``_load_warm_state``, so checkpointed runs resume bit-identically. The GP
    lives on ``device`` (the GPU unless the caller passes ``device="cpu"``).
    """

    def _init_warm(self, warm_start: bool, gp_warm_fit_steps: int, device=None) -> None:
        self.warm_start = warm_start
        self.gp_warm_fit_steps = gp_warm_fit_steps
        self._gp_warm: Optional[GPParams] = None
        self.device = resolve_device(device)

    def _fit_gp(self, X, Y, fit_steps: int = 120, noise_scale=None) -> GP:
        gp = GP(
            seed=int(self.rng.integers(2**31)),
            fit_steps=fit_steps,
            warm_fit_steps=self.gp_warm_fit_steps,
            device=self.device,
        )
        gp.fit(X, Y, init=self._gp_warm if self.warm_start else None, noise_scale=noise_scale)
        if self.warm_start:
            self._gp_warm = gp.params  # kept on device; serialized lazily
        return gp

    def _warm_state(self) -> Optional[Dict[str, Any]]:
        return self._gp_warm.to_lists() if self._gp_warm is not None else None

    def _load_warm_state(self, warm: Optional[Dict[str, Any]]) -> None:
        self._gp_warm = GPParams.from_lists(warm) if warm is not None else None

    def _extra_state(self) -> Dict[str, Any]:
        return {"gp_warm": self._warm_state()}

    def _load_extra_state(self, extra: Dict[str, Any]) -> None:
        self._load_warm_state(extra.get("gp_warm"))


class VDTuner(_WarmGPMixin, TunerBase):
    """Algorithm 1: polling BO with NPI surrogate + successive abandon.

    ``engine`` selects the acquisition implementation: ``"torch"`` (default)
    runs the whole recommend path — posterior prediction, EHVI/CEI scoring,
    Kriging-believer fantasies — on the GP's device
    (:mod:`.acquisition_torch`); ``"numpy"`` is the host-side reference.
    Both select identical configuration sequences on seeded runs (scores
    agree to reduction-order rounding). ``device`` is where the GP and the
    acquisition run: the GPU unless the caller passes ``device="cpu"``.

    ``warm_start=True`` reuses the previous round's GP hyperparameters as
    the optimizer init with ``gp_warm_fit_steps`` Adam steps instead of a
    ``gp_fit_steps``-step cold fit — a large recommend-time saving that
    slightly perturbs the hyperparameter trajectory, so it is opt-in. The
    warm state rides in ``state_dict()`` checkpoints, keeping resumes
    bit-identical.
    """

    name = "vdtuner"

    def __init__(
        self,
        space: SearchSpace,
        objective: Optional[Objective] = None,
        seed: int = 0,
        transform=None,
        abandon_window: int = 10,
        n_candidates: int = 512,
        mc_samples: int = 64,
        gp_fit_steps: int = 120,
        rlim: Optional[float] = None,
        bootstrap_history: Optional[Sequence[Observation]] = None,
        q: int = 1,
        objective_spec: Optional[ObjectiveSpec] = None,
        engine: str = "torch",
        warm_start: bool = False,
        gp_warm_fit_steps: int = 30,
        device=None,
    ):
        super().__init__(space, objective, seed, transform, objective_spec)
        if q < 1:
            raise ValueError(f"q must be >= 1, got {q}")
        if engine not in ("torch", "numpy"):
            raise ValueError(f"engine must be 'torch' or 'numpy', got {engine!r}")
        self.abandon = SuccessiveAbandon(space.type_names, window=abandon_window)
        self.n_candidates = n_candidates
        self.mc_samples = mc_samples
        self.gp_fit_steps = gp_fit_steps
        self.engine = engine
        self._init_warm(warm_start, gp_warm_fit_steps, device)
        # user recall-floor preference (constraint mode); an ObjectiveSpec
        # carrying rlim (e.g. objectives.recall_floor) sets it implicitly
        if rlim is not None and self.spec.rlim is not None and rlim != self.spec.rlim:
            raise ValueError(
                f"conflicting recall floors: rlim={rlim} but objective_spec "
                f"{self.spec.name!r} carries rlim={self.spec.rlim}"
            )
        self.rlim = rlim if rlim is not None else self.spec.rlim
        self.q = q  # configurations proposed (and evaluated) per BO round
        self._poll_cursor = 0
        if bootstrap_history:
            # §IV-F: warm-start the surrogate with data from previous
            # constraint levels. These observations feed the GP/fronts but are
            # not re-evaluated.
            for o in bootstrap_history:
                self.history.append(dataclasses.replace(o, bootstrap=True))

    # ------------------------------------------------------------------
    # ask/tell
    # ------------------------------------------------------------------
    def ask(self, n: int = 1) -> List[Config]:
        """Recommend the next batch.

        Warm-up (Algorithm 1 lines 1–5): while any index type lacks an
        observation, the remaining per-type defaults are returned as one
        mandatory batch (possibly exceeding ``n`` — exactly the legacy
        initial sampling). Afterwards each call is one BO round proposing
        ``min(q, n)`` configurations of the polled index type.
        """
        seen = set(o.index_type for o in self.history)
        todo = [self.space.default_config(t) for t in self.space.type_names if t not in seen]
        if todo:
            return todo
        q = max(1, min(self.q, n))
        Y, types = self.Y, self.types

        # --- successive abandon (lines 7–14) ---------------------------
        self.abandon.step(Y, types)

        # --- NPI normalization + holistic surrogate (lines 15–18) ------
        mode = "balanced" if self.rlim is None else "max"
        Yn, bases = npi_normalize(Y, types, mode=mode)
        scales = np.array([o.noise_scale for o in self.history], np.float32)
        gp = self._fit_gp(
            self.X_enc, Yn, fit_steps=self.gp_fit_steps,
            noise_scale=scales if np.any(scales != 1.0) else None,
        )

        # --- poll next index type & recommend (lines 19–21) ------------
        t = self._next_poll_type()
        raw, Xc = self._candidates_encoded(t)

        if self.rlim is None:
            # EHVI with ref = 0.5 * base; in normalized space the base is
            # (1, 1), so r = (0.5, 0.5); the front is the normalized
            # non-dominated set across all types (§IV-C).
            front = Yn[non_dominated_mask(Yn)]
            ref = np.array([0.5, 0.5])
            if self.engine == "torch":
                idx = fused_qehvi_select(gp, Xc, front, ref, self.rng, q, self.mc_samples)
            else:
                idx = qehvi_sequential_greedy(
                    gp, Xc, front, ref, self.rng, q, self.mc_samples
                )
        else:
            # constraint mode: EI(speed) * Pr(recall > rlim).
            if self.engine == "torch":
                best_feasible, rlim_n = self._cei_incumbent(Y, bases, t)
                idx = fused_cei_select(gp, Xc, best_feasible, rlim_n, q)
            else:
                idx = self._cei_select(gp, Xc, Y, bases, t, q)

        return [self.space.decode(raw[i], index_type=t) for i in idx]

    def preferred_executor(self) -> str:
        # q=1 evaluated the warm-up defaults sequentially pre-redesign; q>1
        # routed batches through the backend's evaluate_batch.
        return "sequential" if self.q == 1 else "batch"

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _extra_state(self) -> Dict[str, Any]:
        return {
            "poll_cursor": int(self._poll_cursor),
            "abandon": self.abandon.state_dict(),
            "gp_warm": self._warm_state(),
        }

    def _load_extra_state(self, extra: Dict[str, Any]) -> None:
        self._poll_cursor = int(extra["poll_cursor"])
        self.abandon.load_state_dict(extra["abandon"])
        self._load_warm_state(extra.get("gp_warm"))

    # ------------------------------------------------------------------
    def _initial_sampling(self):
        """Algorithm 1 lines 1–5: each index type's default configuration.

        Legacy helper (the session/ask path emits the same batch through
        ``ask``). With ``q > 1`` the defaults go through the batch evaluation
        path; with ``q == 1`` they are evaluated sequentially exactly as
        before.
        """
        seen = set(o.index_type for o in self.history)
        todo = [self.space.default_config(t) for t in self.space.type_names if t not in seen]
        if not todo:
            return
        if self.q > 1:
            self._evaluate_batch(todo, recommend_time=0.0)
        else:
            for cfg in todo:
                self._evaluate(cfg, recommend_time=0.0)

    def _next_poll_type(self) -> str:
        remaining = self.abandon.remaining
        t = remaining[self._poll_cursor % len(remaining)]
        self._poll_cursor += 1
        return t

    def _candidates(self, t: str) -> List[Config]:
        """Candidate set within type-t's subspace: uniform + perturbations of
        the type's (and globally) best observed configurations. Thin wrapper
        decoding every row of ``_candidates_encoded`` (the recommend path
        only decodes the chosen rows)."""
        raw, _ = self._candidates_encoded(t)
        return [self.space.decode(r, index_type=t) for r in raw]

    def _candidates_encoded(self, t: str) -> Tuple[np.ndarray, np.ndarray]:
        """Bulk candidate generation: ``(raw, Xc)`` where ``raw`` rows decode
        to exactly the configs the legacy per-config loop built (identical
        RNG consumption — the uniform block is one C-order ``rng.random``
        matrix) and ``Xc = snap_encoded(raw)`` is the encoded matrix the GP
        scores, equal bit-for-bit to ``np.stack([encode(c) for c in cands])``.
        """
        n_uniform = self.n_candidates // 2
        blocks = [self.space.sample_encoded(self.rng, n_uniform, t)]
        count = n_uniform
        # exploit: perturb non-dominated configs of this type
        ys = self.Y
        nd = non_dominated_mask(ys)
        seeds = [o.config for o, keep in zip(self.history, nd) if keep and o.index_type == t]
        if not seeds:  # fall back to the type's best-speed and best-recall configs
            mine = [o for o in self.history if o.index_type == t and not o.failed]
            if mine:
                seeds = [
                    max(mine, key=lambda o: o.y[0]).config,
                    max(mine, key=lambda o: o.y[1]).config,
                ]
        if seeds:
            seeds_enc = [self.space.encode(c) for c in seeds]
            free = self.space.free_mask(t)
            rows = []
            # per-candidate draws (choice then normal) keep the generator
            # stream identical to the legacy space.perturb loop
            while count + len(rows) < self.n_candidates:
                base = seeds_enc[(count + len(rows)) % len(seeds_enc)]
                scale = float(self.rng.choice([0.05, 0.1, 0.2]))
                noise = self.rng.normal(0.0, scale, size=self.space.dims)
                rows.append(np.clip(base + noise * free, 0.0, 1.0))
            if rows:
                blocks.append(np.stack(rows))
                count += len(rows)
        if count < self.n_candidates:
            blocks.append(self.space.sample_encoded(self.rng, self.n_candidates - count, t))
        raw = np.concatenate(blocks, axis=0)
        return raw, self.space.snap_encoded(raw, t)

    def _cei_incumbent(self, Y: np.ndarray, bases: Dict[str, np.ndarray], t: str):
        """(best feasible speed, recall floor) in the polled type's
        normalized units — the CEI incumbent state (Eq. 7)."""
        base_t = bases.get(t, np.array([1.0, 1.0]))
        rlim_n = self.rlim / base_t[1]
        feas = Y[:, 1] >= self.rlim
        if feas.any():
            spd_n = np.array(
                [o.y[0] / bases[o.index_type][0] for o, f in zip(self.history, feas) if f]
            )
            best_feasible = float(spd_n.max())
        else:
            best_feasible = float("-inf")
        return best_feasible, rlim_n

    def _cei_select(
        self,
        gp: GP,
        Xc: np.ndarray,
        Y: np.ndarray,
        bases: Dict[str, np.ndarray],
        t: str,
        q: int,
    ) -> List[int]:
        """Sequential-greedy constrained-EI selection (Eq. 7) for a batch.

        Thresholds are in the polled type's normalized units. After each pick
        the Kriging-believer fantasy conditions the posterior, and — if the
        fantasy clears the recall floor — raises the feasible-speed incumbent.
        """
        best_feasible, rlim_n = self._cei_incumbent(Y, bases, t)
        state = {"best": best_feasible}

        def score(mean, std):
            return cei(mean[:, 0], std[:, 0], mean[:, 1], std[:, 1], state["best"], rlim_n)

        def on_fantasy(fantasy):
            if fantasy[1] >= rlim_n:
                state["best"] = max(state["best"], float(fantasy[0]))

        return greedy_select(gp, Xc, q, score, on_fantasy)

    def step(self, max_new: Optional[int] = None) -> List[Observation]:
        """Legacy self-driving round: ``ask`` + evaluate + ``tell`` in one
        call, against the tuner's own objective. Prefer ``TuningSession``.

        ``max_new`` clamps the batch so a run never overshoots its iteration
        budget. With ``q == 1`` the round consumes exactly the same RNG draws
        and picks the same argmax as the original single-point step.
        """
        t0 = time.perf_counter()
        cfgs = self.ask(self.q if max_new is None else max_new)
        rec_time = time.perf_counter() - t0
        return self._evaluate_batch(cfgs, recommend_time=rec_time / len(cfgs))
