"""Acquisition functions: MC-EHVI (Eq. 4), EI, constrained EI (Eq. 7), and
sequential-greedy q-EHVI batch selection with Kriging-believer fantasies.

This is the host-side reference implementation (numpy, the same code as the
JAX package's ``core/acquisition.py``); the device-resident fused path lives
in :mod:`.acquisition_torch` and is tested against it."""
from __future__ import annotations

from typing import List

import numpy as np
from scipy.special import erf as _erf  # vectorized float64 erf

from .hypervolume import hvi_2d
from .pareto import pareto_front


def _phi(z: np.ndarray) -> np.ndarray:
    """Standard normal pdf."""
    return np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


def _Phi(z: np.ndarray) -> np.ndarray:
    """Standard normal cdf via erf."""
    return 0.5 * (1.0 + _erf(np.asarray(z, np.float64) / np.sqrt(2.0)))


def ehvi_mc(
    mean: np.ndarray,
    std: np.ndarray,
    front: np.ndarray,
    ref: np.ndarray,
    rng: np.random.Generator,
    n_samples: int = 64,
) -> np.ndarray:
    """Monte-Carlo EHVI for `c` candidates with independent-normal posteriors.

    mean/std: (c, 2); front: (k, 2) current non-dominated set; ref: (2,).
    Returns (c,) expected exclusive hypervolume improvement (paper Eq. 4,
    estimated by Monte-Carlo integration as in qEHVI [24]).
    """
    c = mean.shape[0]
    eps = rng.standard_normal((n_samples, c, 2))
    samples = mean[None] + std[None] * eps  # (S, c, 2)
    flat = samples.reshape(-1, 2)
    hvi = hvi_2d(flat, front, ref).reshape(n_samples, c)
    return hvi.mean(axis=0)


def greedy_select(gp, Xc: np.ndarray, q: int, score_fn, on_fantasy=None) -> List[int]:
    """Sequential-greedy batch selection with Kriging-believer fantasies.

    Picks ``q`` distinct candidate indices: at each round ``score_fn(mean,
    std)`` scores all candidates from the current posterior, the best
    still-available one is taken, and the posterior is conditioned on the
    fantasy (the posterior mean at the pick) via ``gp.condition_on`` so later
    picks spread across the candidate set instead of clustering on one
    acquisition peak. ``on_fantasy(fantasy)`` lets callers update incumbent
    state (running front, best-feasible) between picks.

    For ``q == 1`` this is exactly one ``gp.predict`` + one ``score_fn``
    call — identical RNG consumption and argmax to a single-point step.
    """
    q = min(q, Xc.shape[0])
    chosen: List[int] = []
    avail = np.ones(Xc.shape[0], dtype=bool)
    for j in range(q):
        mean, std = gp.predict(Xc)
        acq = np.where(avail, score_fn(mean, std), -np.inf)
        i = int(np.argmax(acq))
        chosen.append(i)
        avail[i] = False
        if j + 1 < q:
            fantasy = mean[i]
            gp = gp.condition_on(Xc[i][None], fantasy[None])
            if on_fantasy is not None:
                on_fantasy(fantasy)
    return chosen


def qehvi_sequential_greedy(
    gp,
    Xc: np.ndarray,
    front: np.ndarray,
    ref: np.ndarray,
    rng: np.random.Generator,
    q: int,
    n_samples: int = 64,
) -> List[int]:
    """Sequential-greedy q-EHVI: each Kriging-believer fantasy joins the
    running non-dominated front before the next pick."""
    state = {"front": np.asarray(front, np.float64)}

    def score(mean, std):
        return ehvi_mc(mean, std, state["front"], ref, rng, n_samples)

    def on_fantasy(fantasy):
        state["front"] = pareto_front(np.vstack([state["front"], fantasy[None]]))

    return greedy_select(gp, Xc, q, score, on_fantasy)


def ei(mean: np.ndarray, std: np.ndarray, best: float) -> np.ndarray:
    """Closed-form expected improvement (maximization)."""
    std = np.maximum(std, 1e-12)
    z = (mean - best) / std
    return (mean - best) * _Phi(z) + std * _phi(z)


def cei(
    mean_spd: np.ndarray,
    std_spd: np.ndarray,
    mean_rec: np.ndarray,
    std_rec: np.ndarray,
    best_feasible: float,
    rlim: float,
) -> np.ndarray:
    """Constrained EI (paper Eq. 7):  EI(speed) * Pr(recall > rlim)."""
    p_feas = 1.0 - _Phi((rlim - mean_rec) / np.maximum(std_rec, 1e-12))
    if not np.isfinite(best_feasible):
        # no feasible observation yet: chase feasibility only
        return p_feas
    return ei(mean_spd, std_spd, best_feasible) * p_feas
