"""Shared harness of the port's paper-figure benchmarks (the twin of the JAX
package's ``benchmarks/common.py``).

``REPRO_BENCH_FULL=1`` (read once, at import) selects the paper's scale:
32,768 vectors, 200 observations, wall-clock QPS on the device. The default
is the fast deterministic configuration: 6,144 vectors, 36 observations,
analytic QPS (the JAX package's CPU cost model, so it measures no device).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..core import (
    ALL_BASELINES,
    TuningSession,
    VDTuner,
    hv_2d,
    pareto_front,
)
from ..core.tuner import _WarmGPMixin
from ..device import resolve_device
from ..vdms import VDMSTuningEnv, make_dataset

# benchmark scale knobs (FULL=1 reproduces paper-scale runs)
FULL = bool(int(os.environ.get("REPRO_BENCH_FULL", "0")))
N_VECTORS = 32768 if FULL else 6144
N_ITERS = 200 if FULL else 36
MODE = "wall" if FULL else "analytic"
DATASETS = ("glove_like", "keyword_like", "georadius_like")
RECALL_FLOORS = (0.85, 0.875, 0.9, 0.925, 0.95, 0.975, 0.99)

TUNERS = dict(ALL_BASELINES, vdtuner=VDTuner)


def make_env(dataset: str, seed: int = 0, mode: Optional[str] = None,
             n: Optional[int] = None, device=None) -> VDMSTuningEnv:
    """The tuning environment of one benchmark dataset (128 queries, k 10),
    on ``device`` (the GPU unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    n = n or N_VECTORS
    if dataset == "georadius_like":
        n = max(n // 4, 2048)
    ds = make_dataset(dataset, n=n, n_queries=128, k=10, seed=seed, device=device)
    return VDMSTuningEnv(ds, mode=mode or MODE, seed=seed, device=device)


def run_method(name: str, env, space, n_iters: int, seed: int = 0, executor=None,
               device=None, **kw):
    """Drive any tuner through the one ``TuningSession`` harness; the
    GP-backed tuners (VDTuner, OtterTuneLike, QEHVI) fit on ``device``.

    Returns ``(tuner, wall_s, session)``; the session carries the
    per-iteration recommend/eval ledger (``session.ledger_dict()``).
    """
    cls = TUNERS[name]
    if issubclass(cls, _WarmGPMixin):
        kw["device"] = resolve_device(device)
    t0 = time.perf_counter()
    tuner = cls(space, env, seed=seed, **kw)
    session = TuningSession(tuner, executor=executor)
    session.run(n_iters)
    wall = time.perf_counter() - t0
    return tuner, wall, session


def norm_hv(tuner, ymax) -> float:
    return hv_2d(pareto_front(tuner.Y) / np.asarray(ymax), np.zeros(2))


def emit(name: str, us_per_call: float, derived: str):
    """CSV row in the ``name,us_per_call,derived`` format of the JAX
    package's benchmarks."""
    print(f"{name},{us_per_call:.2f},{derived}")
