"""Paper Fig. 6 + Fig. 7: best search speed at recall floors per method, and
samples/time needed to reach the most-competitive-baseline quality (the twin
of the JAX package's ``benchmarks/bench_efficiency.py``).

Every tuner is driven through ``TuningSession`` (one harness for all
methods), and each method's ``session`` block carries the per-iteration
recommend/eval time ledger (``repro_torch.core.session.LEDGER_SCHEMA``).
The methods share one environment per dataset, so a configuration that two
methods both try is evaluated once.

Also the batch-parallel tuning axis: ``--batch-sizes 1 4`` runs the same
VDTuner observation budget at each ``q`` (a q > 1 round goes through the
environment's ``evaluate_batch``: threaded builds in analytic mode and
same-signature instances measured together) and reports wall-clock tuning
time against q; ``--check-speedup`` exits non-zero unless every q > 1 run is
faster than q = 1. The JAX package's gate measured XLA compile amortisation
across a batch; the port compiles nothing per configuration, so what q > 1
buys here is what the batched dispatch and the threads save, if anything.

    PYTHONPATH=src python -m repro_torch.bench.bench_efficiency --device cpu --iters 12
    PYTHONPATH=src python -m repro_torch.bench.bench_efficiency --device cpu --batch-sizes 1 4 --iters 16
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..core import TuningSession, VDTuner, hv_2d, pareto_front
from ..device import resolve_device
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


def run_batched(seed: int = 0, dataset: str = "glove_like", batch_sizes=(1, 4),
                n_iters: int = N_ITERS, mode: str = "analytic", device=None):
    """Wall-clock tuning time against the batch size q at a fixed budget of
    observations. Each q gets a fresh environment, so the comparison is of
    whole tuning sessions. Reports the wall seconds, the
    recommendation/evaluation split and the normalized Pareto hypervolume,
    so a speedup cannot silently trade away tuning quality."""
    device = resolve_device(device)
    space = make_space()
    out = {}
    for q in batch_sizes:
        env = make_env(dataset, seed=seed, mode=mode, device=device)
        tuner = VDTuner(space, env, seed=seed, q=int(q), device=device)
        session = TuningSession(tuner)
        t0 = time.perf_counter()
        session.run(n_iters)
        wall = time.perf_counter() - t0
        ys = tuner.Y
        norm = ys.max(axis=0)
        norm = np.where(norm <= 0, 1.0, norm)
        hv = hv_2d(pareto_front(ys) / norm, np.zeros(2))
        out[str(q)] = {
            "q": int(q),
            "n_iters": n_iters,
            "wall_s": wall,
            "recommend_s": float(sum(o.recommend_time for o in tuner.history)),
            "replay_s": float(env.total_replay_time),
            "n_evals": int(env.n_evals),
            "hv_norm": float(hv),
            "session": session.ledger_dict(),
        }
        emit(f"efficiency_batched/{dataset}/q{q}", wall * 1e6 / n_iters,
             f"wall={wall:.2f}s;hv={hv:.3f}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=N_ITERS,
                   help=f"observations per method (default {N_ITERS}; REPRO_BENCH_FULL=1: 200)")
    p.add_argument("--dataset", action="append", default=None, choices=DATASETS,
                   help="repeatable; default all three (the batched axis: one, glove_like)")
    p.add_argument("--batch-sizes", type=int, nargs="+", default=None,
                   help="run the batched-tuning axis at these q values instead of the "
                        "method comparison")
    p.add_argument("--mode", default=None, choices=("analytic", "wall"),
                   help="measurement mode of the batched axis (default analytic)")
    p.add_argument("--check-speedup", action="store_true",
                   help="exit 1 unless every q>1 wall-clock is strictly below q=1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", default=None, metavar="PATH", help="write results as JSON")
    args = p.parse_args(argv)
    if args.batch_sizes is None:
        if args.mode is not None or args.check_speedup:
            p.error("--mode and --check-speedup only apply with --batch-sizes")
        results = run(seed=args.seed, datasets=tuple(args.dataset or DATASETS),
                      n_iters=args.iters, device=args.device)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2, default=str)
        print(results)
        return 0
    if args.dataset is not None and len(args.dataset) > 1:
        p.error("the batched axis takes one --dataset")
    results = run_batched(seed=args.seed, dataset=(args.dataset or ["glove_like"])[0],
                          batch_sizes=args.batch_sizes, n_iters=args.iters,
                          mode=args.mode or "analytic", device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    for q, r in results.items():
        print(f"q={q}: wall={r['wall_s']:.2f}s recommend={r['recommend_s']:.2f}s "
              f"replay={r['replay_s']:.2f}s hv={r['hv_norm']:.3f}")
    if args.check_speedup and "1" in results:
        base = results["1"]["wall_s"]
        slow = {q: r["wall_s"] for q, r in results.items() if r["q"] > 1 and r["wall_s"] >= base}
        if slow:
            print(f"SPEEDUP REGRESSION: q=1 wall {base:.2f}s, slower batched runs: "
                  f"{ {q: round(w, 2) for q, w in slow.items()} }", file=sys.stderr)
            return 1
        print(f"speedup check OK: q=1 {base:.2f}s > " + ", ".join(
            f"q={r['q']} {r['wall_s']:.2f}s" for r in results.values() if r["q"] > 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
