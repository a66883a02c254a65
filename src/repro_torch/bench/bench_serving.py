"""Serving control plane under drift: guarded controller vs frozen config,
scored as SLO violation-minutes (the twin of the JAX package's
``benchmarks/bench_serving.py``; every engine, replay and GP fit runs on
``--device``, the GPU unless ``--device cpu`` is given).

Both arms replay the same drifting trace (arrival mix swings from
search-heavy to insert-heavy while the vector distribution drifts) from the
same incumbent configuration and score SLO compliance with identical
accounting. The *frozen* arm never intervenes: breaches are recorded but
the config stays fixed. The *guarded* arm runs the full control loop
(``repro_torch.serving.ServingController``): sliding-window SLO evaluation, a
drift probe on the live instance, shadow/canary retune on breach, and
promotion only when the candidate wins the SLO-constrained score on
mirrored traffic — losing canaries roll back checkpoint-exact.

``BENCH_serving.json`` records, per schedule and arm, SLO
violation-minutes, recall-under-floor minutes, end-to-end recall, latency
percentiles, and the retune/promote/rollback counts; ``--ledger-json``
additionally dumps the guarded arm's metrics ledger. ``--check-improvement``
exits non-zero unless the guarded arm *strictly* reduces violation-minutes
vs frozen on the step-drift trace (any schedule if step is not run).

    PYTHONPATH=src python -m repro_torch.bench.bench_serving --device cpu --quick
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core import TuningSession, VDTuner
from ..device import resolve_device
from ..serving import ControllerParams, ServingController, SLOSpec
from ..vdms import VDMSTuningEnv, make_space, make_trace

from .common import emit

SCHEDULES = ("step", "ramp")
#: search-heavy start -> insert-heavy end (insert, search, delete)
MIX0 = (0.20, 0.75, 0.05)
MIX1 = (0.65, 0.30, 0.05)
RECALL_FLOOR = 0.9


def _sizes(quick: bool):
    if quick:
        return dict(n_base=800, n_ops=640, n_pre_ops=150, n_tune=6)
    return dict(n_base=2048, n_ops=1600, n_pre_ops=320, n_tune=12)


def _controller_params(quick: bool) -> ControllerParams:
    if quick:
        return ControllerParams(
            retune_iters=6, check_every=24, canary_queries=24,
            retune_window_ops=112, cooldown_ops=48, floor_margin=0.02,
        )
    return ControllerParams(
        retune_iters=10, check_every=48, canary_queries=48,
        retune_window_ops=288, cooldown_ops=96, floor_margin=0.02,
    )


def _incumbent_config():
    """A deployable-looking incumbent that is healthy pre-drift but leans on
    ``graceful_time`` staleness — exactly the kind of config that quietly
    falls through a recall floor once the arrival mix turns insert-heavy."""
    return dict(
        make_space().default_config("FLAT"), segment_max_size=256, graceful_time=0.4
    )


def _tuned_session(trace, n_pre_ops: int, n_tune: int, seed: int, device=None,
                   draws=None) -> TuningSession:
    """Tune on the pre-drift prefix, as the deployment that produced the
    incumbent would have (replays and the GP on ``device``; ``draws`` is
    the class of the build draws)."""
    env = VDMSTuningEnv(
        trace=trace.window(0, n_pre_ops), workload="streaming",
        mode="analytic", seed=seed, n_phases=1, device=device, draws=draws,
    )
    tuner = VDTuner(make_space(), env, seed=seed, warm_start=True, device=device)
    session = TuningSession(tuner)
    session.run(n_tune)
    return session


def _arm_summary(report) -> dict:
    return {
        "violation_minutes": report["violation_minutes"],
        "recall_under_floor_minutes": report["recall_under_floor_minutes"],
        "recall": report["recall"],
        "lat_p50_s": report["lat_p50_s"],
        "lat_p99_s": report["lat_p99_s"],
        "n_breach_events": report["n_breach_events"],
        "n_retunes": report["n_retunes"],
        "n_promotes": report["n_promotes"],
        "n_rollbacks": report["n_rollbacks"],
        "n_configs_served": len(report["config_history"]),
        "timeline": [
            {k: e[k] for k in ("op", "time", "event")} for e in report["timeline"]
        ],
    }


def run_schedule(schedule: str, seed: int = 0, quick: bool = True, mode: str = "analytic",
                 device=None, draws=None):
    device = resolve_device(device)
    sz = _sizes(quick)
    trace = make_trace(
        "glove_like", n_base=sz["n_base"], n_ops=sz["n_ops"],
        drift=schedule, seed=seed, mix=MIX0, mix_to=MIX1,
    )
    cfg = _incumbent_config()
    slo = SLOSpec(recall_floor=RECALL_FLOOR, min_samples=16)
    params = _controller_params(quick)

    # frozen arm: same SLO accounting cadence, no interventions
    frozen = ServingController(
        slo, params=ControllerParams(check_every=params.check_every),
        mode=mode, seed=seed, device=device, draws=draws,
    ).serve(trace, cfg, guard=False)

    # guarded arm: full breach -> retune -> canary -> promote/rollback loop
    session = _tuned_session(trace, sz["n_pre_ops"], sz["n_tune"], seed, device, draws)
    ctrl = ServingController(slo, session=session, params=params, mode=mode, seed=seed,
                             device=device, draws=draws)
    guarded = ctrl.serve(trace, cfg, guard=True)

    out = {
        "schedule": schedule,
        "trace": trace.name,
        "n_ops": int(trace.n_ops),
        "n_searches": int(trace.n_searches),
        "slo": guarded["slo"],
        "frozen": _arm_summary(frozen),
        "guarded": _arm_summary(guarded),
        "delta_violation_minutes": float(
            guarded["violation_minutes"] - frozen["violation_minutes"]
        ),
    }
    for arm, rep in (("frozen", frozen), ("guarded", guarded)):
        emit(
            f"serving/{schedule}/{arm}",
            rep["n_searches"],
            f"viol_min={rep['violation_minutes']:.2f};"
            f"recall={rep['recall']:.3f};promotes={rep['n_promotes']};"
            f"rollbacks={rep['n_rollbacks']}",
        )
    return out, ctrl.ledger


def run(seed: int = 0, quick: bool = True, schedules=SCHEDULES, mode: str = "analytic",
        device=None, draws=None):
    out, ledgers = {}, {}
    for s in schedules:
        out[s], ledgers[s] = run_schedule(s, seed=seed, quick=quick, mode=mode, device=device,
                                          draws=draws)
    return out, ledgers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true", help="CI-sized budgets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="analytic", choices=("analytic", "wall"))
    p.add_argument("--schedules", nargs="+", default=list(SCHEDULES), choices=("step", "ramp", "sine"))
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", default=None, metavar="PATH", help="write results as JSON (CI artifact)")
    p.add_argument(
        "--ledger-json", default=None, metavar="PATH",
        help="dump the guarded arms' metrics ledgers as JSON (CI artifact)",
    )
    p.add_argument(
        "--check-improvement", action="store_true",
        help="exit 1 unless the guarded arm strictly reduces SLO "
             "violation-minutes vs frozen on step drift",
    )
    args = p.parse_args(argv)

    schedules, ledgers = run(
        seed=args.seed, quick=args.quick, schedules=args.schedules, mode=args.mode,
        device=args.device,
    )
    out = {
        "quick": bool(args.quick), "seed": args.seed, "mode": args.mode,
        "sizes": _sizes(args.quick), "schedules": schedules,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if args.ledger_json:
        with open(args.ledger_json, "w") as f:
            json.dump({s: led.to_json() for s, led in ledgers.items()}, f, indent=2)

    wins = {}
    for s, r in schedules.items():
        g, f0 = r["guarded"], r["frozen"]
        wins[s] = g["violation_minutes"] < f0["violation_minutes"]
        print(
            f"{s}: frozen viol_min={f0['violation_minutes']:.2f} "
            f"guarded viol_min={g['violation_minutes']:.2f} "
            f"(delta {r['delta_violation_minutes']:+.2f}, "
            f"retunes={g['n_retunes']}, promotes={g['n_promotes']}, "
            f"rollbacks={g['n_rollbacks']})"
        )
    rc = 0
    if args.check_improvement:
        # the acceptance gate is anchored on step drift; fall back to
        # any-schedule only when step was not part of the run
        ok = wins["step"] if "step" in wins else any(wins.values())
        if not ok:
            print(
                "IMPROVEMENT CHECK FAILED: guarded controller did not reduce "
                "violation-minutes vs frozen",
                file=sys.stderr,
            )
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
