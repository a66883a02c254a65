"""Segment planning: executable semantics for the Milvus-like system params.

* ``segment_max_size`` — vectors per sealed segment. Each sealed segment gets
  its *own* index build (smaller segments → more per-segment index builds,
  more merge overhead, different nlist balance — the interdependence shown in
  the paper's Fig. 1–2).
* ``seal_proportion``  — the trailing partial segment is sealed (indexed) only
  if it reached this fraction of ``segment_max_size``; otherwise it stays
  *growing* and is searched by brute force.
* ``graceful_time``    — bounded-consistency window: the fraction of the
  growing tail a query may *skip*. Small values scan (almost) the whole
  unindexed tail (slow, complete — the paper notes small gracefulTime causes
  request blocking); large values skip recent inserts (fast, may miss them).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    n: int
    seg_size: int  # S (padded size of every sealed segment)
    n_sealed: int
    sealed_valid: np.ndarray  # (n_sealed,) number of real vectors per segment
    growing_start: int  # first id of the growing tail
    growing_searched: int  # how many tail vectors a query actually scans

    @property
    def growing_size(self) -> int:
        return self.n - self.growing_start


def plan_segments(
    n: int, segment_max_size: int, seal_proportion: float, graceful_time: float
) -> SegmentPlan:
    s = int(min(max(segment_max_size, 64), n))
    n_full = n // s
    rem = n - n_full * s
    seal_rem = rem > 0 and rem >= seal_proportion * s
    n_sealed = n_full + (1 if seal_rem else 0)
    if n_sealed == 0:  # everything growing: force at least one sealed segment
        n_sealed, s = 1, n
        rem, seal_rem = 0, False
    sealed_valid = np.full((n_sealed,), s, dtype=np.int64)
    if seal_rem:
        sealed_valid[-1] = rem
    growing_start = int(sealed_valid.sum())
    growing = n - growing_start
    searched = int(np.ceil((1.0 - float(np.clip(graceful_time, 0.0, 1.0))) * growing))
    return SegmentPlan(
        n=n,
        seg_size=s,
        n_sealed=n_sealed,
        sealed_valid=sealed_valid,
        growing_start=growing_start,
        growing_searched=searched,
    )


def live_seg_size(segment_max_size: int, seal_proportion: float) -> int:
    """Sealed-segment size under *streaming* ingestion: a growing segment
    seals (and gets its own index build) the moment it crosses
    ``seal_proportion * segment_max_size``, the live counterpart of the
    static plan's trailing-remainder rule. Clamped to >= 64 like the static
    plan, so degenerate configurations cannot make per-vector segments."""
    s = max(int(segment_max_size), 64)
    return int(min(max(int(np.ceil(float(seal_proportion) * s)), 64), s))


def stack_sealed(data: np.ndarray, plan: SegmentPlan) -> tuple[np.ndarray, np.ndarray]:
    """Pack sealed vectors into (n_sealed, S, d) with -1-id padding.

    Returns (segments, global_ids); padded slots have id -1 and zero vectors.
    """
    s, d = plan.seg_size, data.shape[1]
    segs = np.zeros((plan.n_sealed, s, d), dtype=data.dtype)
    gids = -np.ones((plan.n_sealed, s), dtype=np.int32)
    off = 0
    for z in range(plan.n_sealed):
        v = int(plan.sealed_valid[z])
        segs[z, :v] = data[off : off + v]
        gids[z, :v] = np.arange(off, off + v, dtype=np.int32)
        off += v
    return segs, gids
