"""Baseline tuners evaluated in the paper (§V-A):

* Default      — no tuning; per-index-type default configurations.
* RandomLHS    — Latin hypercube sampling over the holistic space [33, 34].
* OtterTuneLike— single-objective GP-BO on a weighted sum of normalized
                 objectives, EI acquisition [11].
* QEHVI        — vanilla multi-objective BO: holistic GP on raw standardized
                 objectives, MC-EHVI with reference point 0, index type treated
                 as just another searched dimension (no polling / NPI /
                 abandon) [24].
* OpenTunerLike— AUC-bandit meta-search over numerical techniques (random,
                 annealing-style perturbation, crossover) on the weighted-sum
                 reward [20].

All baselines speak the same ask/tell protocol as ``VDTuner`` and are driven
by ``TuningSession`` — one harness for every tuner, so paper comparisons
(Fig. 6–7, Table VI) measure the recommenders, not five different loops.
This is the port of the JAX package's ``core/baselines.py``: the same numpy
recommenders, with the two GP baselines' surrogate in PyTorch on ``device``
(the GPU unless the caller passes ``device="cpu"``), as in ``VDTuner``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .acquisition import ehvi_mc, ei
from .pareto import non_dominated_mask
from .space import Config
from .tuner import Observation, TunerBase, _WarmGPMixin


class DefaultOnly(TunerBase):
    name = "default"

    def ask(self, n: int = 1) -> List[Config]:
        # one default per index type, in declaration order, up to the budget;
        # exhausted (empty ask) once every type has been tried.
        done = len(self.history)
        todo = self.space.type_names[done : done + max(n, 0)]
        return [self.space.default_config(t) for t in todo]


class RandomLHS(TunerBase):
    name = "random_lhs"

    def ask(self, n: int = 1) -> List[Config]:
        # the whole remaining budget is one LHS plan, so the stratification
        # covers it exactly like the legacy single-shot design.
        return self.space.lhs(self.rng, max(n, 1))


def _weighted_sum(Y: np.ndarray, w: float = 0.5) -> np.ndarray:
    """Normalized weighted-sum scalarization used to port single-objective
    baselines to the bi-objective problem (paper §V-A)."""
    mx = Y.max(axis=0)
    mx = np.where(mx <= 0, 1.0, mx)
    return w * Y[:, 0] / mx[0] + (1 - w) * Y[:, 1] / mx[1]


class OtterTuneLike(_WarmGPMixin, TunerBase):
    name = "ottertune"

    def __init__(
        self, *args, n_init: int = 10, n_candidates: int = 512,
        warm_start: bool = False, gp_warm_fit_steps: int = 30, device=None, **kw,
    ):
        super().__init__(*args, **kw)
        self.n_init = n_init
        self.n_candidates = n_candidates
        self._init_warm(warm_start, gp_warm_fit_steps, device)

    def ask(self, n: int = 1) -> List[Config]:
        if not self.history:
            return self.space.lhs(self.rng, min(self.n_init, max(n, 1)))
        Y = self.Y
        scal = _weighted_sum(Y)
        gp = self._fit_gp(self.X_enc, scal[:, None])
        cands = self.space.sample(self.rng, self.n_candidates)
        Xc = np.stack([self.space.encode(c) for c in cands])
        mean, std = gp.predict(Xc)
        acq = ei(mean[:, 0], std[:, 0], float(scal.max()))
        return [cands[int(np.argmax(acq))]]


class QEHVI(_WarmGPMixin, TunerBase):
    name = "qehvi"

    def __init__(
        self, *args, n_init: int = 10, n_candidates: int = 512, mc_samples: int = 64,
        warm_start: bool = False, gp_warm_fit_steps: int = 30, device=None, **kw,
    ):
        super().__init__(*args, **kw)
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.mc_samples = mc_samples
        self._init_warm(warm_start, gp_warm_fit_steps, device)

    def ask(self, n: int = 1) -> List[Config]:
        if not self.history:
            return self.space.lhs(self.rng, min(self.n_init, max(n, 1)))
        Y = self.Y
        gp = self._fit_gp(self.X_enc, Y)
        cands = self.space.sample(self.rng, self.n_candidates)
        Xc = np.stack([self.space.encode(c) for c in cands])
        mean, std = gp.predict(Xc)
        front = Y[non_dominated_mask(Y)]
        ref = np.zeros(2)  # paper: qEHVI reference point set to 0
        acq = ehvi_mc(mean, std, front, ref, self.rng, self.mc_samples)
        return [cands[int(np.argmax(acq))]]


class OpenTunerLike(TunerBase):
    """AUC-bandit over low-overhead numerical search techniques."""

    name = "opentuner"

    TECHNIQUES = ("random", "perturb", "crossover", "anneal")

    def __init__(self, *args, window: int = 30, **kw):
        super().__init__(*args, **kw)
        self.window = window
        self._uses: List[str] = []
        self._credits: List[float] = []
        self._temp = 0.5
        # (technique, pre-eval best scalarization) for the in-flight proposal
        self._pending_credit: Optional[Tuple[str, float]] = None

    def _pick_technique(self) -> str:
        # AUC-credit bandit: exploitation score per technique from recent
        # successes, plus a sqrt exploration bonus.
        scores = {}
        n_total = max(len(self._uses), 1)
        for t in self.TECHNIQUES:
            idx = [i for i, u in enumerate(self._uses[-self.window :]) if u == t]
            if not idx:
                scores[t] = float("inf")
                continue
            credit = np.mean([self._credits[-self.window :][i] for i in idx])
            scores[t] = credit + np.sqrt(2.0 * np.log(n_total) / len(idx))
        return max(scores, key=lambda t: scores[t])

    def _propose(self, tech: str) -> Config:
        good = None
        if self.history:
            scal = _weighted_sum(self.Y)
            good = self.history[int(np.argmax(scal))].config
        if tech == "random" or good is None:
            return self.space.sample(self.rng, 1)[0]
        if tech == "perturb":
            return self.space.perturb(self.rng, good, scale=0.1)
        if tech == "anneal":
            cfg = self.space.perturb(self.rng, good, scale=self._temp)
            self._temp = max(self._temp * 0.97, 0.02)
            return cfg
        if tech == "crossover":
            other = self.history[int(self.rng.integers(len(self.history)))].config
            if other["index_type"] != good["index_type"]:
                return self.space.perturb(self.rng, good, scale=0.1)
            xa, xb = self.space.encode(good), self.space.encode(other)
            mask = self.rng.random(xa.shape) < 0.5
            return self.space.decode(np.where(mask, xa, xb), index_type=good["index_type"])
        raise ValueError(tech)

    def ask(self, n: int = 1) -> List[Config]:
        tech = self._pick_technique()
        cfg = self._propose(tech)
        before = _weighted_sum(self.Y).max() if self.history else -np.inf
        self._pending_credit = (tech, float(before))
        return [cfg]

    def _on_tell(self, obs: Observation) -> None:
        if self._pending_credit is None:
            return
        tech, before = self._pending_credit
        self._pending_credit = None
        after = float(_weighted_sum(self.Y).max())
        self._uses.append(tech)
        self._credits.append(1.0 if after > before else 0.0)

    def _extra_state(self) -> Dict[str, Any]:
        return {
            "uses": list(self._uses),
            "credits": [float(c) for c in self._credits],
            "temp": float(self._temp),
            "pending_credit": list(self._pending_credit) if self._pending_credit else None,
        }

    def _load_extra_state(self, extra: Dict[str, Any]) -> None:
        self._uses = list(extra["uses"])
        self._credits = [float(c) for c in extra["credits"]]
        self._temp = float(extra["temp"])
        pc = extra.get("pending_credit")
        self._pending_credit = (str(pc[0]), float(pc[1])) if pc else None


ALL_BASELINES = {
    c.name: c for c in (DefaultOnly, RandomLHS, OtterTuneLike, QEHVI, OpenTunerLike)
}
