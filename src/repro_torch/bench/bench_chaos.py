"""Chaos benchmark: guarded serving under injected faults vs unguarded (the
twin of the JAX package's ``benchmarks/bench_chaos.py``; engines, replays,
the visible-set oracle and the GP run on ``--device``, the GPU unless
``--device cpu`` is given).

Replays the serving benchmark's drifting traces (step / ramp arrival-mix
swings) with three canned fault schedules armed (``repro_torch.vdms.faults``):
``segment_loss`` (two sealed segments die mid-trace), ``flaky_builds``
(seal/rebuild crashes with fail-count budgets plus a segment loss) and
``latency_storm`` (a latency-multiplier window, a shadow-build OOM and a
late segment loss). Both arms serve the *same* trace with the *same* plan
(fresh injectors each, so fault clocks are identical); the guarded arm runs
the full breach -> retune -> canary -> promote/rollback loop with fault
hardening (canary fault aborts, breach-storm hysteresis), the unguarded arm
only keeps the degraded-mode engine alive.

``--check-resilience`` gates three promises:

(a) **no crashes** — every serve() returns a report; faults degrade, they
    never raise out of the control loop;
(b) **honest accounting** — a direct engine replay (exact FLAT index) under
    segment loss returns only ids from ``searchable_ids()`` and matches the
    independently-computed brute-force oracle restricted to that visible
    set *exactly* (recall 1.0 by construction for an exact index);
(c) **guarding helps** — on the step-drift trace, summed over the three
    fault plans, guarded violation-minutes strictly beat unguarded.

``BENCH_chaos.json`` records the full per-case reports. ``run_case``
reports a crashed arm as a finding (gate (a)), not as an abort.

    PYTHONPATH=src python -m repro_torch.bench.bench_chaos --device cpu --quick
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

import torch

from ..device import resolve_device
from ..serving import ControllerParams, ServingController, SLOSpec
from ..serving.controller import visible_topk
from ..vdms import (
    FaultInjector,
    LiveVDMS,
    canned_fault_plans,
    make_trace,
    recall_at_k_masked,
)
from ..vdms.workload import OP_INSERT, OP_SEARCH

from .bench_serving import (
    MIX0,
    MIX1,
    RECALL_FLOOR,
    _controller_params,
    _incumbent_config,
    _sizes,
    _tuned_session,
)
from .common import emit

SCHEDULES = ("step", "ramp")
PLANS = ("segment_loss", "flaky_builds", "latency_storm")


def _fault_horizon(n_ops: int) -> int:
    """The engine fault clock ticks once per engine op (mutations plus
    batched search flushes), which lands near ``n_ops // 2`` on these
    traces — schedule the canned plans inside that range so every event
    actually fires."""
    return max(n_ops // 2, 16)


def _arm_summary(report: dict) -> dict:
    out = {
        "crashed": False,
        "violation_minutes": report["violation_minutes"],
        "recall_under_floor_minutes": report["recall_under_floor_minutes"],
        "recall": report["recall"],
        "visible_recall": report.get("visible_recall"),
        "health": report.get("health"),
        "lat_p99_s": report["lat_p99_s"],
        "n_retunes": report["n_retunes"],
        "n_promotes": report["n_promotes"],
        "n_rollbacks": report["n_rollbacks"],
    }
    if "fault" in report:
        f = report["fault"]
        out["fault"] = {
            k: f[k]
            for k in (
                "n_injected", "n_quarantines", "n_rebuilds",
                "n_rebuild_failures", "n_seal_retries",
                "n_canary_fault_aborts", "coverage_min",
            )
        }
    return out


def _crashed(e: Exception) -> dict:
    return {"crashed": True, "error": f"{type(e).__name__}: {e}"}


def run_case(schedule: str, plan_name: str, seed: int = 0, quick: bool = True,
             mode: str = "analytic", device=None, draws=None) -> dict:
    device = resolve_device(device)
    sz = _sizes(quick)
    trace = make_trace(
        "glove_like", n_base=sz["n_base"], n_ops=sz["n_ops"],
        drift=schedule, seed=seed, mix=MIX0, mix_to=MIX1,
    )
    plan = canned_fault_plans(_fault_horizon(sz["n_ops"]))[plan_name]
    cfg = _incumbent_config()
    slo = SLOSpec(recall_floor=RECALL_FLOOR, min_samples=16)
    params = _controller_params(quick)

    try:
        unguarded = _arm_summary(
            ServingController(
                slo, params=ControllerParams(check_every=params.check_every),
                mode=mode, seed=seed, device=device, draws=draws,
            ).serve(trace, cfg, guard=False, fault_plan=plan)
        )
    except Exception as e:  # gate (a): a crash is a finding, not an abort
        unguarded = _crashed(e)
    try:
        session = _tuned_session(trace, sz["n_pre_ops"], sz["n_tune"], seed, device, draws)
        ctrl = ServingController(
            slo, session=session, params=params, mode=mode, seed=seed, device=device,
            draws=draws,
        )
        guarded = _arm_summary(ctrl.serve(trace, cfg, guard=True, fault_plan=plan))
    except Exception as e:
        guarded = _crashed(e)

    out = {
        "schedule": schedule, "plan": plan_name, "fault_plan": plan.to_dict(),
        "unguarded": unguarded, "guarded": guarded,
    }
    for arm, rep in (("unguarded", unguarded), ("guarded", guarded)):
        if rep["crashed"]:
            emit(f"chaos/{schedule}/{plan_name}/{arm}", 0.0, "CRASHED")
        else:
            emit(
                f"chaos/{schedule}/{plan_name}/{arm}",
                rep["violation_minutes"],
                f"recall={rep['recall']:.3f};"
                f"vis_recall={rep['visible_recall']:.3f};"
                f"cov_min={rep['fault']['coverage_min']:.3f};"
                f"health={rep['health']}",
            )
    return out


def oracle_exactness_check(seed: int = 0, quick: bool = True, device=None,
                           draws=None) -> dict:
    """Gate (b): direct engine replay under segment loss with an exact FLAT
    index. At every flush, returned ids must come from ``searchable_ids()``
    and must match the brute-force oracle restricted to that set exactly —
    the degraded engine may answer from fewer vectors, but it must never
    misreport what it can see."""
    device = resolve_device(device)
    n_base, n_ops = (600, 400) if quick else (1500, 1000)
    trace = make_trace(
        "glove_like", n_base=n_base, n_ops=n_ops, drift="step", seed=seed,
        mix=MIX0, mix_to=MIX1,
    )
    # stretch the rebuild backoff so quarantined segments stay out of the
    # visible set across many flushes — the exactness claim is only
    # interesting while the engine is actually serving degraded
    plan = dataclasses.replace(
        canned_fault_plans(_fault_horizon(n_ops))["segment_loss"],
        backoff_base_ticks=n_ops // 8,
    )
    cfg = dict(_incumbent_config(), segment_max_size=128)
    live = LiveVDMS(cfg, trace.dim, trace.capacity, seed=seed, device=device, draws=draws)
    live.bootstrap(trace.base)
    live.arm_faults(FaultInjector(plan, scope="primary"))
    all_vecs = torch.from_numpy(trace.all_vectors()).to(device)
    k = trace.k
    n_checks, subset_ok, exact_ok, cov_min = 0, True, True, 1.0
    pending: list = []

    def check_flush() -> None:
        nonlocal n_checks, subset_ok, exact_ok, cov_min
        if not pending:
            return
        q = trace.queries[np.asarray(pending, np.int64)]
        pending.clear()
        ids, _ = live.search(q, k, mode="analytic")
        svis = live.searchable_mask()
        cov_min = min(cov_min, float(live.last_coverage))
        subset_ok &= bool(svis[ids[ids >= 0]].all())
        vis_gt = visible_topk(all_vecs, q, svis, k)
        exact_ok &= float(recall_at_k_masked(ids[:, :k], vis_gt[:, :k])) == 1.0
        n_checks += 1

    for i in range(trace.n_ops):
        kind = int(trace.kinds[i])
        if kind == OP_SEARCH:
            pending.append(int(trace.payload[i]))
            if len(pending) >= 16:
                check_flush()
        else:
            check_flush()
            row = int(trace.payload[i])
            if kind == OP_INSERT:
                live.insert(trace.inserts[row])
            else:
                live.delete(row)
    check_flush()
    stats = live.stats()
    out = {
        "n_checks": int(n_checks),
        "subset_ok": bool(subset_ok),
        "exact_ok": bool(exact_ok),
        "coverage_min": float(cov_min),
        "degraded_engaged": bool(stats["n_quarantines"] >= 1 and cov_min < 1.0),
        "n_quarantines": int(stats["n_quarantines"]),
        "n_rebuilds": int(stats["n_rebuilds"]),
    }
    emit(
        "chaos/oracle_exactness", n_checks,
        f"subset_ok={subset_ok};exact_ok={exact_ok};cov_min={cov_min:.3f}",
    )
    return out


def run(seed: int = 0, quick: bool = True, schedules=SCHEDULES, mode: str = "analytic",
        device=None, draws=None):
    cases = [
        run_case(s, pl, seed=seed, quick=quick, mode=mode, device=device, draws=draws)
        for s in schedules
        for pl in PLANS
    ]
    return {"cases": cases,
            "oracle": oracle_exactness_check(seed=seed, quick=quick, device=device, draws=draws)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true", help="CI-sized budgets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="analytic", choices=("analytic", "wall"))
    p.add_argument(
        "--schedules", nargs="+", default=list(SCHEDULES),
        choices=("step", "ramp", "sine"),
    )
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write results as JSON (CI artifact)")
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument(
        "--check-resilience", action="store_true",
        help="exit 1 unless: no serve crashed; visible-set accounting is "
             "oracle-exact; and on step drift guarded strictly beats "
             "unguarded on violation-minutes summed over fault plans",
    )
    args = p.parse_args(argv)

    res = run(seed=args.seed, quick=args.quick, schedules=args.schedules,
              mode=args.mode, device=args.device)
    out = {
        "quick": bool(args.quick), "seed": args.seed, "mode": args.mode,
        "sizes": _sizes(args.quick), **res,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)

    step_g, step_u = 0.0, 0.0
    crashes = []
    for c in res["cases"]:
        for arm in ("unguarded", "guarded"):
            if c[arm]["crashed"]:
                crashes.append(f"{c['schedule']}/{c['plan']}/{arm}: {c[arm]['error']}")
        if not (c["guarded"]["crashed"] or c["unguarded"]["crashed"]):
            tag = (
                f"g={c['guarded']['violation_minutes']:.2f} "
                f"u={c['unguarded']['violation_minutes']:.2f}"
            )
            print(f"{c['schedule']}/{c['plan']}: viol_min {tag}")
            if c["schedule"] == "step":
                step_g += c["guarded"]["violation_minutes"]
                step_u += c["unguarded"]["violation_minutes"]

    rc = 0
    if args.check_resilience:
        oracle = res["oracle"]
        checks = {
            "no_crashes": not crashes,
            "oracle_subset": oracle["subset_ok"],
            "oracle_exact": oracle["exact_ok"],
            "oracle_degraded_engaged": oracle["degraded_engaged"],
            "step_guarded_wins": step_g < step_u,
        }
        for name, ok in checks.items():
            print(f"check {name}: {'ok' if ok else 'FAILED'}")
        for line in crashes:
            print(f"  crash: {line}", file=sys.stderr)
        if not checks["step_guarded_wins"]:
            print(
                f"  step totals: guarded={step_g:.2f} unguarded={step_u:.2f}",
                file=sys.stderr,
            )
        if not all(checks.values()):
            print("RESILIENCE CHECK FAILED", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
