"""Degraded-mode serving demo on the port: breach -> fault -> degrade ->
rebuild -> recover (the twin of the JAX package's
``examples/serve_chaos.py``, at its sizes).

Replays the serving demo's drifting trace with a ``FaultPlan`` armed: a
build-crash budget arms just before two sealed segments die mid-trace, so
the first repair attempts crash and retry with backoff before succeeding.
The controller keeps serving throughout: quarantined segments drop out of
the visible set (coverage < 1), searches answer from the survivors plus the
growing tail, recall is scored against the brute-force oracle restricted to
what was searchable, and background rebuilds restore the lost segments from
the vector store. Every engine and the oracle run on the GPU unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve_chaos --device cpu

Exits 1 unless degraded mode engaged (a quarantine happened, a rebuild
completed, and coverage dipped below 1), the engine finished healthy, and
FLAT's visible-set recall is 1.0.
"""
from __future__ import annotations

import argparse
import sys

from ..serving import ControllerParams, ServingController, SLOSpec
from ..vdms import FaultEvent, FaultPlan, make_space, make_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--mode", default="analytic", choices=("analytic", "wall"))
    args = p.parse_args(argv)

    trace = make_trace(
        "glove_like", n_base=800, n_ops=640, seed=0, drift="step",
        mix=(0.20, 0.75, 0.05), mix_to=(0.65, 0.30, 0.05),
    )
    incumbent = dict(make_space().default_config("FLAT"), segment_max_size=256,
                     graceful_time=0.4)
    # the engine's fault clock ticks about once per mutation or flush (~n_ops/2 here)
    plan = FaultPlan(
        events=(
            FaultEvent(kind="build_crash", at_tick=60, fails=2),
            FaultEvent(kind="segment_loss", at_tick=90, segment=0),
            FaultEvent(kind="segment_loss", at_tick=180, segment=1),
        ),
        seed=0,
    )

    slo = SLOSpec(recall_floor=0.9, min_samples=16)
    ctrl = ServingController(slo, params=ControllerParams(check_every=24), mode=args.mode,
                             seed=0, device=args.device)
    report = ctrl.serve(trace, incumbent, guard=False, fault_plan=plan)

    for e in report["timeline"]:
        if e["event"] in ("health", "breach"):
            extra = {k: v for k, v in e.items() if k not in ("event", "op", "time")}
            print(f"op {e['op']:>4} t={e['time']:.2f} {e['event']:<8} {extra}")
    f = report["fault"]
    print(
        f"served {report['n_searches']} searches through "
        f"{f['n_injected']} injected faults: recall={report['recall']:.3f} "
        f"visible-set recall={report['visible_recall']:.3f}"
    )
    print(
        f"degraded mode: coverage dipped to {f['coverage_min']:.3f}, "
        f"{f['n_quarantines']} quarantines, {f['n_rebuilds']} rebuilds, "
        f"{f['n_seal_retries']} seal retries; final health={report['health']}"
    )

    engaged = (
        f["n_quarantines"] >= 1
        and f["n_rebuilds"] >= 1
        and f["coverage_min"] < 1.0
        and report["health"] == "healthy"
        and report["visible_recall"] == 1.0  # FLAT is exact on the visible set
    )
    if not engaged:
        print("FAILED: degraded mode never engaged (or did not recover)", file=sys.stderr)
        return 1
    print("ok: degraded, rebuilt, recovered, without lying about recall")
    return 0


if __name__ == "__main__":
    sys.exit(main())
