"""Polling-surrogate NPI normalization (paper §IV-B, Eq. 2–3).

Each index type's observations are divided by a per-type *base* — the most
balanced non-dominated configuration of that type — so the GP sees relative
improvements rather than absolute performance. This removes the inter-index
performance offsets that otherwise make BO exploit only the currently-best
index type ("polling surrogate").
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .pareto import non_dominated_mask

EPS = 1e-12


def balanced_base(Y_t: np.ndarray) -> np.ndarray:
    """Eq. 3: among a type's non-dominated observations, pick the one that
    maximizes 1 / |y_spd/y_spd_max - y_rec/y_rec_max| (the most balanced).

    Y_t: (n, 2) raw (speed, recall) observations for one index type.
    Returns the (2,) base value  (ȳ_spd, ȳ_rec).
    """
    Y_t = np.asarray(Y_t, np.float64).reshape(-1, 2)
    nd = Y_t[non_dominated_mask(Y_t)]
    ymax = nd.max(axis=0)
    ymax = np.where(ymax <= 0, 1.0, ymax)
    imbalance = np.abs(nd[:, 0] / ymax[0] - nd[:, 1] / ymax[1])
    base = nd[int(np.argmin(imbalance))]
    return np.maximum(base, EPS)


def max_base(Y_t: np.ndarray) -> np.ndarray:
    """Constraint-mode base (paper §IV-F): the per-objective maximum of the
    type, which 'relaxes the goal of achieving both objectives simultaneously'."""
    Y_t = np.asarray(Y_t, np.float64).reshape(-1, 2)
    return np.maximum(Y_t.max(axis=0), EPS)


def npi_normalize(
    Y: np.ndarray,
    types: np.ndarray,
    mode: str = "balanced",
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Eq. 2: divide each observation by its index type's base value.

    Y: (n, 2) raw observations; types: (n,) index-type label per row.
    Returns (normalized Y, {type: base}).
    """
    Y = np.asarray(Y, np.float64)
    types = np.asarray(types)
    bases: Dict[str, np.ndarray] = {}
    Yn = np.empty_like(Y)
    base_fn = balanced_base if mode == "balanced" else max_base
    for t in np.unique(types):
        sel = types == t
        base = base_fn(Y[sel])
        bases[str(t)] = base
        Yn[sel] = Y[sel] / base[None, :]
    return Yn, bases
