"""Budget allocation among index types: scoring + successive abandon
(paper §IV-D, Eq. 5–6, windowed trigger).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .hypervolume import hv_2d
from .normalize import balanced_base
from .pareto import non_dominated_mask


def scores_by_hv_influence(
    Y: np.ndarray, types: np.ndarray, remaining: Sequence[str]
) -> Dict[str, float]:
    """Eq. 6: Score(t) = max_t' HV(r, Y/Y_t') - HV(r, Y/Y_t).

    Y are *raw* observations of all types; the non-dominated subset and the
    reference point r = 0.5 * ȳ (ȳ per Eq. 3 computed over the whole
    non-dominated set) follow the paper. Higher score = bigger marginal
    hypervolume contribution.
    """
    Y = np.asarray(Y, np.float64)
    types = np.asarray(types)
    # scale-normalize per objective so the HV is not dominated by the axis
    # with the larger dynamic range (QPS ~1e3 vs recall <=1); Eq. 3's balance
    # criterion is scale-aware in the same way.
    ymax = Y.max(axis=0)
    ymax = np.where(ymax <= 0, 1.0, ymax)
    Y = Y / ymax[None, :]
    nd_mask = non_dominated_mask(Y)
    nd_Y = Y[nd_mask]
    nd_types = types[nd_mask]
    ybar = balanced_base(nd_Y)
    r = 0.5 * ybar

    hv_without: Dict[str, float] = {}
    for t in remaining:
        rest = nd_Y[nd_types != t]
        hv_without[t] = hv_2d(rest, r) if rest.size else 0.0
    mx = max(hv_without.values()) if hv_without else 0.0
    return {t: mx - hv_without[t] for t in remaining}


class SuccessiveAbandon:
    """Windowed abandon trigger: if one index type ranks worst for `window`
    consecutive scoring rounds, drop it (never below one remaining type).
    """

    def __init__(self, types: Sequence[str], window: int = 10):
        self.remaining: List[str] = list(types)
        self.window = window
        self._worst_history: List[str] = []
        self.abandoned: List[str] = []
        self.score_log: List[Dict[str, float]] = []

    # --- checkpointing (JSON-compatible) --------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "remaining": list(self.remaining),
            "worst_history": list(self._worst_history),
            "abandoned": list(self.abandoned),
            "score_log": [dict(s) for s in self.score_log],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "SuccessiveAbandon":
        self.remaining = list(state["remaining"])
        self._worst_history = list(state["worst_history"])
        self.abandoned = list(state["abandoned"])
        self.score_log = [{k: float(v) for k, v in s.items()} for s in state["score_log"]]
        return self

    def step(self, Y: np.ndarray, types: np.ndarray) -> Optional[str]:
        """Score remaining types on the observations so far; abandon and return
        the consistently-worst type if the windowed trigger fires, else None."""
        if len(self.remaining) <= 1:
            return None
        scores = scores_by_hv_influence(Y, types, self.remaining)
        self.score_log.append(dict(scores))
        worst = min(self.remaining, key=lambda t: scores[t])
        self._worst_history.append(worst)
        recent = self._worst_history[-self.window :]
        if len(recent) == self.window and all(w == worst for w in recent):
            self.remaining.remove(worst)
            self.abandoned.append(worst)
            self._worst_history.clear()
            return worst
        return None
