"""All of the port's paper-figure benchmarks in one process (the twin of the
JAX package's ``benchmarks/run.py``). Prints ``name,us_per_call,derived``
CSV.

    Table IV/V -> bench_autoconfig     Fig. 6/7  -> bench_efficiency
    Fig. 8-10  -> bench_ablation       Fig. 12   -> bench_preference
    Fig. 13    -> bench_costaware      Table VI  -> bench_overhead
    kernels                            -> bench_kernels

REPRO_BENCH_FULL=1 scales to paper-size runs (200 observations, wall-clock
QPS at 32k vectors on the card); the default is the fast deterministic
configuration (analytic QPS). The streaming suite waits for the port's
streaming engine.

    PYTHONPATH=src python -m repro_torch.bench.run --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from ..vdms import ivf_pqr, registered_names
from .common import N_ITERS


def parse_index_types(value):
    """Normalize an ``--index-types`` value (comma list or sequence) and
    validate it against the registry, raising ``ValueError`` with the sorted
    registered families on unknown names. ``IVF_PQR`` counts when the
    filter names it: the autoconfig suite registers it for its own run."""
    if value is None:
        return None
    names = tuple(s.strip() for s in value.split(",")) if isinstance(value, str) else tuple(value)
    known = set(registered_names())
    if ivf_pqr.FAMILY.name in names:
        known.add(ivf_pqr.FAMILY.name)
    unknown = sorted(set(names) - known)
    if unknown:
        raise ValueError(f"unknown index types {unknown}; registered families: {sorted(known)}")
    return names


def main(argv=None) -> None:
    from . import (
        bench_ablation, bench_autoconfig, bench_costaware, bench_efficiency,
        bench_kernels, bench_overhead, bench_preference,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--index-types",
        default=None,
        metavar="A,B,...",
        help="restrict the registry-aware suite (autoconfig) to these index families "
        "(comma list validated against the registry; the public-hook IVF_PQR counts)",
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
