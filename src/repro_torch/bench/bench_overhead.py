"""Recommendation overhead benchmarks (the twin of the JAX package's
``benchmarks/bench_overhead.py``).

Two views:

* ``run()``: paper Table VI, the tuning-time breakdown (configuration
  recommendation against workload replay) per method, driven end to end.
* ``run_ask_overhead()``: per-iteration ``ask()`` time of the numpy
  reference path against the device-resident torch engine (warm-started GP
  refits) at a fixed history size, for q in {1, 4, 8}.

No baseline file of the port is committed: ``--check-against`` takes the
path of one taken on the card (a JSON object with
``recommend_s_per_iter_q4``).

CLI::

    python -m repro_torch.bench.bench_overhead --device cpu --quick
    python -m repro_torch.bench.bench_overhead --check-speedup     # >= 3x at q=4
    python -m repro_torch.bench.bench_overhead --check-against PATH
    python -m repro_torch.bench.bench_overhead --table-vi
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..core import VDTuner
from ..device import resolve_device, sync
from ..vdms import make_space
from .common import N_ITERS, emit, make_env, run_method

METHODS = ("vdtuner", "random_lhs", "ottertune", "qehvi", "opentuner")
ENGINES = ("numpy", "torch")


def run(seed: int = 0, dataset: str = "glove_like", n_iters: int = N_ITERS, device=None):
    space = make_space()
    out = {}
    for m in METHODS:
        env = make_env(dataset, seed=seed, device=device)
        tuner, wall, session = run_method(m, env, space, n_iters, seed=seed, device=device)
        rec = sum(o.recommend_time for o in tuner.history)
        replay = sum(o.eval_time for o in tuner.history)
        out[m] = {
            "recommend_s": rec, "replay_s": replay, "total_s": wall,
            "recommend_pct": 100 * rec / max(wall, 1e-9),
            "session": session.ledger_dict(),
        }
        emit(f"overhead/{m}", wall * 1e6 / n_iters,
             f"rec={rec:.1f}s({100*rec/max(wall,1e-9):.2f}%);replay={replay:.1f}s")
    return out


# ---------------------------------------------------------------------------
# ask-time overhead: numpy path against the torch engine
# ---------------------------------------------------------------------------
def _synthetic_history(space, n_obs: int, seed: int):
    """Deterministic (config, raw-result) pairs covering every index type:
    a cheap stand-in workload so the benchmark measures recommendation, not
    evaluation."""
    rng = np.random.default_rng(seed + 1)
    cfgs = [space.default_config(t) for t in space.type_names]
    cfgs += space.sample(rng, max(n_obs - len(cfgs), 0))
    cfgs = cfgs[:n_obs]
    out = []
    for cfg in cfgs:
        x = space.encode(cfg)
        h = float(np.sin(7.0 * x).sum())
        speed = 1000.0 * (1.2 + np.tanh(h))
        recall = 0.6 + 0.39 * (0.5 + 0.5 * np.tanh(2.0 * x.mean() + 0.3 * h))
        out.append((cfg, {"speed": speed, "recall": recall, "mem_gib": 1.0 + x.mean()}))
    return out


def _preloaded_tuner(space, history, seed, q, engine, warm_start, n_candidates, mc_samples,
                     device):
    tuner = VDTuner(
        space, seed=seed, q=q, engine=engine, warm_start=warm_start,
        n_candidates=n_candidates, mc_samples=mc_samples, device=device,
    )
    for cfg, raw in history:
        tuner.tell(cfg, raw)
    return tuner


def run_ask_overhead(
    n_obs: int = 128,
    qs: Sequence[int] = (1, 4, 8),
    n_ask: int = 5,
    seed: int = 0,
    n_candidates: int = 512,
    mc_samples: int = 64,
    warm: bool = True,
    device=None,
) -> Dict:
    """Time ``ask()`` on a preloaded history of ``n_obs`` observations.

    The numpy engine runs cold 120-step GP fits and the host-side greedy
    acquisition; the torch engine runs the device path with warm-started
    refits. Each (engine, q) cell does two untimed warm-up asks (the cold
    and the first warm fit), then reports the mean of ``n_ask`` timed asks,
    each ended by a device synchronize.
    """
    device = resolve_device(device)
    space = make_space()
    history = _synthetic_history(space, n_obs, seed)
    engines: Dict[str, Dict] = {}
    for engine in ENGINES:
        engines[engine] = {}
        for q in qs:
            tuner = _preloaded_tuner(
                space, history, seed, q, engine,
                warm_start=(engine == "torch" and warm), n_candidates=n_candidates,
                mc_samples=mc_samples, device=device,
            )
            t0 = time.perf_counter()
            tuner.ask(q)  # the cold fit
            sync(device)
            cold_s = time.perf_counter() - t0
            tuner.ask(q)  # the first warm fit
            times = []
            for _ in range(n_ask):
                sync(device)
                t0 = time.perf_counter()
                tuner.ask(q)
                sync(device)
                times.append(time.perf_counter() - t0)
            mean_s = float(np.mean(times))
            engines[engine][f"q{q}"] = {
                "ask_s_mean": mean_s,
                "ask_s_cold": float(cold_s),
                "recommend_s_per_iter": mean_s / q,
            }
            emit(
                f"ask_overhead/{engine}/q{q}", mean_s / q * 1e6,
                f"ask={mean_s*1e3:.1f}ms;cold={cold_s*1e3:.0f}ms;n={n_obs};device={device.type}",
            )
    speedups = {
        f"q{q}": (
            engines["numpy"][f"q{q}"]["recommend_s_per_iter"]
            / engines["torch"][f"q{q}"]["recommend_s_per_iter"]
        )
        for q in qs
    }
    return {
        "schema": 1,
        "device": str(device),
        "n_obs": n_obs,
        "n_ask": n_ask,
        "n_candidates": n_candidates,
        "mc_samples": mc_samples,
        "seed": seed,
        "warm_start": warm,
        "engines": engines,
        "speedup_per_iter": speedups,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--table-vi", action="store_true", help="run the paper Table VI breakdown")
    p.add_argument("--n-obs", type=int, default=128)
    p.add_argument("--qs", type=int, nargs="+", default=[1, 4, 8])
    p.add_argument("--n-ask", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-candidates", type=int, default=512)
    p.add_argument("--mc-samples", type=int, default=64)
    p.add_argument("--no-warm", action="store_true", help="disable warm-started GP refits")
    p.add_argument("--quick", action="store_true",
                   help="CI-sized budget (n_obs=64, q in {1,4}, 3 asks, 256 candidates)")
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", dest="json_path", default=None, help="write results to this path")
    p.add_argument(
        "--check-speedup", action="store_true",
        help="exit non-zero unless the torch engine is >= 3x faster per iteration at q=4",
    )
    p.add_argument(
        "--check-against", default=None, metavar="BASELINE_JSON",
        help="exit non-zero if the torch engine's q=4 recommend_s_per_iter regresses more "
        "than 2x against the baseline file's recommend_s_per_iter_q4",
    )
    args = p.parse_args(argv)

    if args.table_vi:
        print(run(seed=args.seed, device=args.device))
        return 0

    kw = dict(
        n_obs=args.n_obs, qs=tuple(args.qs), n_ask=args.n_ask, seed=args.seed,
        n_candidates=args.n_candidates, mc_samples=args.mc_samples, warm=not args.no_warm,
        device=args.device,
    )
    if args.quick:
        kw.update(n_obs=64, qs=(1, 4), n_ask=3, n_candidates=256)
    out = run_ask_overhead(**kw)
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json_path}")

    rc = 0
    if args.check_speedup:
        s = out["speedup_per_iter"].get("q4")
        if s is None or s < 3.0:
            print(f"FAIL: torch-engine speedup at q=4 is {s} (< 3x)")
            rc = 1
        else:
            print(f"OK: torch-engine speedup at q=4 is {s:.2f}x (>= 3x)")
    if args.check_against:
        with open(args.check_against) as f:
            baseline = json.load(f)
        limit = 2.0 * baseline["recommend_s_per_iter_q4"]
        cell = out["engines"]["torch"].get("q4")
        if cell is None:
            print("FAIL: --check-against needs q=4 in --qs")
            return 1
        got = cell["recommend_s_per_iter"]
        if got > limit:
            print(
                f"FAIL: torch q=4 recommend_s_per_iter {got*1e3:.1f}ms exceeds 2x "
                f"baseline ({baseline['recommend_s_per_iter_q4']*1e3:.1f}ms)"
            )
            rc = 1
        else:
            print(f"OK: torch q=4 recommend_s_per_iter {got*1e3:.1f}ms within 2x baseline")
    return rc


if __name__ == "__main__":
    sys.exit(main())
