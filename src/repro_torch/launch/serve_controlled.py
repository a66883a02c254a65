"""Serving control plane demo on the port: SLO guardrails + shadow/canary
retune (the twin of the JAX package's ``examples/serve_controlled.py``, at
its sizes).

Replays a drifting trace (the arrival mix swings insert-heavy while the
vector distribution steps to a new family) through ``ServingController``:
the incumbent config falls through the recall floor mid-trace, the
sliding-window SLO monitor flags the breach, the session re-tunes on the
trailing trace window, the candidate is built as a *shadow* instance with
live traffic mirrored to both, and it is promoted only if it wins the
SLO-constrained score; otherwise the session rolls back checkpoint-exact.
Engines, replays and the GP run on the GPU unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.serve_controlled --device cpu

Exits 1 unless the control loop engaged (at least one breach-triggered
retune resolved as a promote or a rollback). ``--ledger-json PATH`` dumps
the metrics ledger.
"""
from __future__ import annotations

import argparse
import sys

from ..core import TuningSession, VDTuner
from ..device import resolve_device
from ..serving import ControllerParams, ServingController, SLOSpec
from ..vdms import VDMSTuningEnv, make_space, make_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ledger-json", default=None, metavar="PATH",
                   help="dump the metrics ledger as JSON")
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--mode", default="analytic", choices=("analytic", "wall"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    trace = make_trace(
        "glove_like", n_base=800, n_ops=640, seed=0, drift="step",
        mix=(0.20, 0.75, 0.05), mix_to=(0.65, 0.30, 0.05),
    )
    # healthy pre-drift, but leaning on graceful_time staleness: it loses the
    # recall floor once inserts dominate
    incumbent = dict(make_space().default_config("FLAT"), segment_max_size=256,
                     graceful_time=0.4)

    # tune on the pre-drift prefix, as the deployment that picked the
    # incumbent would have (the controller re-enters this session on breach)
    env = VDMSTuningEnv(trace=trace.window(0, 150), workload="streaming", mode="analytic",
                        seed=0, n_phases=1, device=device)
    session = TuningSession(VDTuner(make_space(), env, seed=0, warm_start=True, device=device))
    session.run(6)

    slo = SLOSpec(recall_floor=0.9, min_samples=16)
    ctrl = ServingController(
        slo,
        session=session,
        params=ControllerParams(retune_iters=6, check_every=24, canary_queries=24,
                                retune_window_ops=112, cooldown_ops=48, floor_margin=0.02),
        mode=args.mode,
        seed=0,
        device=device,
    )
    report = ctrl.serve(trace, incumbent, guard=True)

    for e in report["timeline"]:
        extra = {k: v for k, v in e.items() if k not in ("event", "op", "time")}
        print(f"op {e['op']:>4} t={e['time']:.2f} {e['event']:<16} {extra if extra else ''}")
    print(
        f"served {report['n_searches']} searches: recall={report['recall']:.3f} "
        f"p50={report['lat_p50_s'] * 1e3:.3f}ms p99={report['lat_p99_s'] * 1e3:.3f}ms"
    )
    print(
        f"SLO: {report['n_breach_events']} breach events, "
        f"{report['violation_minutes']:.2f} violation-minutes "
        f"({report['recall_under_floor_minutes']:.2f} under the recall floor)"
    )
    print(
        f"control loop: retunes={report['n_retunes']} promotes={report['n_promotes']} "
        f"rollbacks={report['n_rollbacks']} configs_served={len(report['config_history'])}"
    )
    if args.ledger_json:
        ctrl.ledger.dump_json(args.ledger_json)
        print(f"ledger -> {args.ledger_json}")

    ok = report["n_breach_events"] >= 1 and report["n_retunes"] >= 1
    ok = ok and (report["n_promotes"] + report["n_rollbacks"]) >= 1
    if not ok:
        print("SMOKE FAILED: control loop never engaged")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
