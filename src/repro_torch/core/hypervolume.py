"""Exact 2-D hypervolume and vectorized hypervolume improvement.

The paper's objectives are always two (search speed & recall, or QP$ &
recall), so the exact 2-D staircase computation is both faster and more
accurate than a general WFG implementation.  Maximization convention; points
at or below the reference point contribute nothing.
"""
from __future__ import annotations

import numpy as np


def hv_2d(front: np.ndarray, ref: np.ndarray) -> float:
    """Hypervolume of the region dominated by `front` and above `ref` (2-D)."""
    front = np.asarray(front, np.float64).reshape(-1, 2)
    ref = np.asarray(ref, np.float64).reshape(2)
    if front.size == 0:
        return 0.0
    f = front[np.all(front > ref, axis=1)]
    if f.size == 0:
        return 0.0
    # sort by f1 desc; on the Pareto staircase f2 then increases
    order = np.argsort(-f[:, 0], kind="stable")
    f = f[order]
    hv = 0.0
    # sweep from the largest f1: each point adds (f1 - ref1) * (f2 - best f2 so far)
    best_f2 = ref[1]
    for x1, x2 in f:
        if x2 > best_f2:
            hv += (x1 - ref[0]) * (x2 - best_f2)
            best_f2 = x2
    return float(hv)


def _staircase(front: np.ndarray, ref: np.ndarray):
    """Segments [a_k, b_k) along obj-1 with staircase height h_k along obj-2.

    Heights are the max obj-2 value among front points whose obj-1 >= the
    segment, i.e. the dominated-region upper boundary. Segment 0 starts at
    ref1; the final (open-ended) segment has height ref2.
    """
    front = np.asarray(front, np.float64).reshape(-1, 2)
    front = front[np.all(front > ref, axis=1)]
    if front.shape[0] == 0:
        return (
            np.array([ref[0]]),
            np.array([np.inf]),
            np.array([ref[1]]),
        )
    order = np.argsort(-front[:, 0], kind="stable")
    f = front[order]  # f1 descending
    # heights[i] = max f2 among points with f1 >= f[i,0]  (cummax along desc f1)
    heights = np.maximum.accumulate(f[:, 1])
    # ascending breakpoints: segment i = (xs[i-1], xs[i]] has height H_i where
    # H_i = max f2 over points with f1 >= any x in that segment.
    xs = np.concatenate([[ref[0]], f[::-1, 0]])  # ascending f1 breakpoints
    a = np.concatenate([xs[:-1], [xs[-1]]])
    b = np.concatenate([xs[1:], [np.inf]])
    h = np.concatenate([heights[::-1], [ref[1]]])
    return a, b, h


def hvi_2d(points: np.ndarray, front: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Exclusive hypervolume improvement of each point w.r.t. `front` (2-D).

    Vectorized over points: HVI(y) = sum over staircase segments of
    overlap([ref1, y1], seg) * max(0, y2 - seg_height).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    ref = np.asarray(ref, np.float64).reshape(2)
    a, b, h = _staircase(front, ref)
    y1 = np.maximum(pts[:, 0], ref[0])[:, None]
    y2 = pts[:, 1][:, None]
    overlap = np.clip(np.minimum(y1, b[None, :]) - a[None, :], 0.0, None)
    gain = np.clip(y2 - np.maximum(h, ref[1])[None, :], 0.0, None)
    hvi = np.sum(overlap * gain, axis=1)
    # points not strictly above ref in both objectives contribute nothing
    hvi[~np.all(pts > ref, axis=1)] = 0.0
    return hvi
