"""Paper Fig. 12: user recall-rate preference, the constraint model (CEI)
and bootstrapping from a previous constraint level; the twin of the JAX
package's ``benchmarks/bench_preference.py``."""
from __future__ import annotations

import time

import numpy as np

from ..core import VDTuner
from ..device import resolve_device
from ..vdms import make_space
from .common import N_ITERS, emit, make_env


def best_feasible_speed(tuner, rlim):
    return tuner.best_speed_at_recall(rlim)


def iters_to_speed(tuner, rlim, target):
    best = -np.inf
    for o in tuner.history:
        if o.bootstrap:
            continue
        if not o.failed and o.y[1] >= rlim:
            best = max(best, o.y[0])
        if best >= target:
            return o.iteration + 1
    return None


def run(seed: int = 0, dataset: str = "glove_like", n_iters: int = N_ITERS, device=None):
    device = resolve_device(device)
    space = make_space()
    out = {}
    # phase 1: rlim = 0.85
    env = make_env(dataset, seed=seed, device=device)
    no_constraint = VDTuner(space, env, seed=seed, device=device).run(n_iters)
    t0 = time.perf_counter()
    with_constraint = VDTuner(space, env, seed=seed + 1, rlim=0.85, device=device).run(n_iters)
    w1 = time.perf_counter() - t0
    target = best_feasible_speed(no_constraint, 0.85)
    out["rlim_0.85"] = {
        "no_constraint_best": target,
        "constraint_best": best_feasible_speed(with_constraint, 0.85),
        "constraint_iters_to_match": iters_to_speed(with_constraint, 0.85, target),
    }
    # phase 2: rlim = 0.9, with and without bootstrapping from phase 1
    cold = VDTuner(space, env, seed=seed + 2, rlim=0.9, device=device).run(n_iters)
    t0 = time.perf_counter()
    warm = VDTuner(
        space, env, seed=seed + 3, rlim=0.9,
        bootstrap_history=with_constraint.history, device=device,
    ).run(n_iters)
    w3 = time.perf_counter() - t0
    target9 = best_feasible_speed(cold, 0.9)
    out["rlim_0.9"] = {
        "cold_best": target9,
        "warm_best": best_feasible_speed(warm, 0.9),
        "cold_iters_to_best": iters_to_speed(cold, 0.9, target9),
        "warm_iters_to_match_cold": iters_to_speed(warm, 0.9, target9),
    }
    emit("preference/constraint_0.85", w1 * 1e6 / n_iters,
         f"best={out['rlim_0.85']['constraint_best']:.0f};"
         f"match_iters={out['rlim_0.85']['constraint_iters_to_match']}")
    emit("preference/bootstrap_0.9", w3 * 1e6 / n_iters,
         f"warm_best={out['rlim_0.9']['warm_best']:.0f};"
         f"warm_match={out['rlim_0.9']['warm_iters_to_match_cold']};"
         f"cold_best={out['rlim_0.9']['cold_best']:.0f}")
    return out


if __name__ == "__main__":
    print(run())
