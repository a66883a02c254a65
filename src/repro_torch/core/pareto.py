"""Pareto utilities (maximization convention throughout)."""
from __future__ import annotations

import numpy as np


def non_dominated_mask(Y: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of Y (n, m), maximizing every column.

    A point is dominated if some other point is >= in all objectives and > in
    at least one.
    """
    Y = np.asarray(Y, dtype=np.float64)
    n = Y.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=bool)
    ge = np.all(Y[None, :, :] >= Y[:, None, :], axis=-1)  # ge[i,j]: j >= i everywhere
    gt = np.any(Y[None, :, :] > Y[:, None, :], axis=-1)  # gt[i,j]: j > i somewhere
    dominated = np.any(ge & gt, axis=1)
    return ~dominated


def pareto_front(Y: np.ndarray) -> np.ndarray:
    """The unique non-dominated rows, sorted by the first objective descending."""
    m = non_dominated_mask(Y)
    front = np.unique(np.asarray(Y, np.float64)[m], axis=0)
    order = np.argsort(-front[:, 0], kind="stable")
    return front[order]
