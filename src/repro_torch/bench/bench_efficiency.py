"""Paper Fig. 6 + Fig. 7: best search speed at recall floors per method, and
samples/time needed to reach the most-competitive-baseline quality (the twin
of the JAX package's ``benchmarks/bench_efficiency.py``).

Every tuner is driven through ``TuningSession`` (one harness for all
methods), and each method's ``session`` block carries the per-iteration
recommend/eval time ledger (``repro_torch.core.session.LEDGER_SCHEMA``).
The methods share one environment per dataset, so a configuration that two
methods both try is evaluated once.

Not ported: ``run_batched`` and ``--batch-sizes`` (wall-clock tuning time
against the batch size q). The port's ``VDMSTuningEnv`` has no
``evaluate_batch`` yet and evaluates a q > 1 round one configuration at a
time, so a q-speedup gate would measure nothing.

    PYTHONPATH=src python -m repro_torch.bench.bench_efficiency --device cpu --iters 12
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..vdms import make_space
from .common import DATASETS, N_ITERS, RECALL_FLOORS, emit, make_env, run_method

METHODS = ("vdtuner", "random_lhs", "ottertune", "qehvi", "opentuner")


def speed_at_floors(tuner):
    return {r: tuner.best_speed_at_recall(r) for r in RECALL_FLOORS}


def iters_to_reach(tuner, floor: float, target_speed: float):
    best = -np.inf
    for o in tuner.history:
        if not o.failed and o.y[1] >= floor:
            best = max(best, o.y[0])
        if best >= target_speed:
            return o.iteration + 1
    return None


def run(seed: int = 0, datasets=DATASETS, n_iters: int = N_ITERS, device=None):
    """Each of ``METHODS`` for ``n_iters`` observations on each dataset.
    Per dataset: ``speed_at_floor`` (method -> floor -> best speed),
    ``iters_to_match_best_baseline``, ``tradeoff_std``, ``wall_s``,
    ``session`` (method -> ledger) and ``failures`` (the configuration and
    message of each failed evaluation)."""
    space = make_space()
    out = {}
    for ds in datasets:
        env = make_env(ds, seed=seed, device=device)
        results, walls, ledgers = {}, {}, {}
        for m in METHODS:
            tuner, wall, session = run_method(m, env, space, n_iters, seed=seed, device=device)
            results[m] = tuner
            walls[m] = wall
            ledgers[m] = session.ledger_dict()
        table = {m: speed_at_floors(t) for m, t in results.items()}
        # tuning efficiency (Fig. 7): iterations for vdtuner to match the most
        # competitive baseline at each floor
        eff = {}
        for r in RECALL_FLOORS:
            base_best = max(
                (table[m][r] for m in METHODS if m != "vdtuner" and np.isfinite(table[m][r])),
                default=float("nan"),
            )
            eff[r] = iters_to_reach(results["vdtuner"], r, base_best)
        # trade-off ability (std of speeds across floors; lower = better)
        tradeoff = {
            m: float(np.nanstd([table[m][r] for r in RECALL_FLOORS])) for m in METHODS
        }
        out[ds] = {"speed_at_floor": table, "iters_to_match_best_baseline": eff,
                   "tradeoff_std": tradeoff, "wall_s": walls,
                   "session": ledgers, "failures": list(env.failures.values())}
        for m in METHODS:
            vals = ";".join(
                f"r{r}={table[m][r]:.0f}" if np.isfinite(table[m][r]) else f"r{r}=nan"
                for r in (0.85, 0.95, 0.99)
            )
            emit(f"efficiency/{ds}/{m}", walls[m] * 1e6 / n_iters, vals)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=N_ITERS,
                   help=f"observations per method (default {N_ITERS}; REPRO_BENCH_FULL=1: 200)")
    p.add_argument("--dataset", action="append", default=None, choices=DATASETS,
                   help="repeatable; default all three")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", default=None, metavar="PATH", help="write results as JSON")
    args = p.parse_args(argv)
    results = run(seed=args.seed, datasets=tuple(args.dataset or DATASETS), n_iters=args.iters,
                  device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, default=str)
    print(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
