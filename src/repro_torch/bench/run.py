"""All of the port's paper-figure benchmarks in one process (the twin of the
JAX package's ``benchmarks/run.py``). Prints ``name,us_per_call,derived``
CSV.

    Table IV/V -> bench_autoconfig     Fig. 6/7  -> bench_efficiency
    Fig. 8-10  -> bench_ablation       Fig. 12   -> bench_preference
    Fig. 13    -> bench_costaware      Table VI  -> bench_overhead
    kernels                            -> bench_kernels
    streaming drift re-tuning          -> bench_streaming
    serving control plane under drift  -> bench_serving
    guarded serving under faults       -> bench_chaos

REPRO_BENCH_FULL=1 scales to paper-size runs (200 observations, wall-clock
QPS at 32k vectors on the card; the streaming suite's full trace sizes);
the default is the fast deterministic configuration (analytic QPS).

    PYTHONPATH=src python -m repro_torch.bench.run --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from .bench_streaming import parse_index_types
from .common import FULL, N_ITERS


def main(argv=None) -> None:
    from . import (
        bench_ablation, bench_autoconfig, bench_chaos, bench_costaware, bench_efficiency,
        bench_kernels, bench_overhead, bench_preference, bench_serving, bench_streaming,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--index-types",
        default=None,
        metavar="A,B,...",
        help="restrict the registry-aware suites (autoconfig, streaming) to these index "
        "families (comma list validated against the registry; the public-hook IVF_PQR counts)",
    )
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--iters", type=int, default=N_ITERS,
                   help=f"observations per tuning run (default {N_ITERS})")
    args = p.parse_args(argv)
    try:
        index_types = parse_index_types(args.index_types)
    except ValueError as e:
        p.error(str(e))

    tuning = {"device": args.device, "n_iters": args.iters}
    print("name,us_per_call,derived")
    suites = [
        ("kernels", bench_kernels.run, {"device": args.device}),
        ("autoconfig(TabIV/V)", bench_autoconfig.run, dict(tuning, index_types=index_types)),
        ("efficiency(Fig6/7)", bench_efficiency.run, dict(tuning, datasets=("glove_like",))),
        ("ablation(Fig8-10)", bench_ablation.run, tuning),
        ("preference(Fig12)", bench_preference.run, tuning),
        ("costaware(Fig13)", bench_costaware.run, tuning),
        ("overhead(TabVI)", bench_overhead.run, tuning),
        ("streaming(drift)", bench_streaming.run, {"quick": not FULL, "index_types": index_types,
                                                   "device": args.device}),
        ("serving(control plane)", bench_serving.run, {"quick": not FULL, "device": args.device}),
        ("chaos(faults)", bench_chaos.run, {"quick": not FULL, "device": args.device}),
    ]
    failures = 0
    for name, fn, kw in suites:
        t0 = time.time()
        try:
            fn(**kw)
            print(f"# suite {name} done in {time.time()-t0:.1f}s", flush=True)
        except Exception:
            failures += 1
            print(f"# suite {name} FAILED", flush=True)
            traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
