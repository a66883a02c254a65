"""Streaming tuning under workload drift: frozen-best vs drift-triggered
re-tuning, scored as hypervolume over time (the twin of the JAX package's
``benchmarks/bench_streaming.py``).

Both arms tune on phase 0 of a drifting trace (distribution drift toward a
different generator family + arrival-mix drift from search-heavy to
insert-heavy). The *frozen* arm deploys its phase-0 Pareto set unchanged;
the *re-tuned* arm probes its incumbent each phase through a
``DriftDetector`` and, when the trigger fires, re-enters BO warm-started
(``TuningSession.retune``: history demoted to bootstrap, GP hyperparameters
carried) on the current phase. Each phase's deployed set is re-measured
under that phase and scored as normalized hypervolume (sustained QPS x
time-aware recall; joint per-phase normalization so arms are comparable).

``--check-invariants`` gates two streaming-engine invariants on a small
trace (sealed-segment count nondecreasing; time-aware recall accounting
matching an independent brute-force oracle); ``--check-improvement`` exits
non-zero unless re-tuning beats frozen mean HV for at least one schedule.
The tuners fit and the replays run on ``--device`` (default: the GPU).

    PYTHONPATH=src python -m repro_torch.bench.bench_streaming --device cpu --quick --check-invariants
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..core import (
    DriftDetector,
    TuningSession,
    VDTuner,
    hv_2d,
    pareto_front,
    streaming_sustained,
)
from ..device import resolve_device
from ..vdms import (
    VDMSTuningEnv,
    ivf_pqr,
    make_space,
    make_trace,
    registered_names,
    replay_trace,
    time_aware_ground_truth,
    unregister_family,
)
from .common import emit

SCHEDULES = ("step", "ramp")
#: search-heavy start -> insert-heavy end (insert, search, delete)
MIX0 = (0.05, 0.90, 0.05)
MIX1 = (0.60, 0.30, 0.10)


def _sizes(quick: bool):
    if quick:
        return dict(n_base=3072, n_ops=1500, n_phases=3, n_init=10, n_retune=14, front_n=4)
    return dict(n_base=8192, n_ops=6000, n_phases=4, n_init=30, n_retune=28, front_n=6)


def _measure_points(env, spec, cfgs):
    """Objective vectors of the deployed configs under the env's current
    phase. Returns ``(points, kept_cfgs)`` aligned; configs that now fail
    drop out of the deployed set."""
    pts, kept = [], []
    for cfg in cfgs:
        try:
            pts.append(list(spec(env(cfg))))
            kept.append(cfg)
        except Exception:
            continue
    return pts, kept


def _dedupe(cfgs):
    seen, out = set(), []
    for cfg in cfgs:
        key = tuple(sorted((k, round(v, 6) if isinstance(v, float) else v) for k, v in cfg.items()))
        if key not in seen:
            seen.add(key)
            out.append(cfg)
    return out


def _make_env(trace, n_phases, mode, seed, device):
    return VDMSTuningEnv(trace=trace, workload="streaming", mode=mode, seed=seed,
                         n_phases=n_phases, device=device)


def run_schedule(
    schedule: str,
    seed: int = 0,
    quick: bool = True,
    mode: str = "analytic",
    rel_threshold: float = 0.12,
    index_types=None,
    device=None,
):
    device = resolve_device(device)
    sz = _sizes(quick)
    spec = streaming_sustained()
    space = make_space(include=index_types)
    trace = make_trace(
        "glove_like",
        n_base=sz["n_base"],
        n_ops=sz["n_ops"],
        seed=seed,
        drift=schedule,
        mix=MIX0,
        mix_to=MIX1,
    )
    P = sz["n_phases"]

    # --- frozen arm: tune once on phase 0, deploy unchanged ---------------
    env_f = _make_env(trace, P, mode, seed, device)
    tuner_f = VDTuner(space, env_f, seed=seed, warm_start=True, objective_spec=spec,
                      device=device)
    TuningSession(tuner_f).run(sz["n_init"])
    deployed_f = tuner_f.pareto_configs(max_n=sz["front_n"])
    frozen_pts = []
    for p in range(P):
        env_f.set_phase(p)
        frozen_pts.append(_measure_points(env_f, spec, deployed_f)[0])

    # --- re-tuned arm: probe incumbent, re-enter BO when drift fires ------
    env_r = _make_env(trace, P, mode, seed, device)
    tuner_r = VDTuner(space, env_r, seed=seed, warm_start=True, objective_spec=spec,
                      device=device)
    session_r = TuningSession(tuner_r)
    session_r.run(sz["n_init"])
    detector = DriftDetector(metrics=("speed", "recall"), rel_threshold=rel_threshold)
    incumbent = tuner_r.best_config()
    session_r.probe_drift(detector, incumbent)  # phase-0 reference
    deployed_r = tuner_r.pareto_configs(max_n=sz["front_n"])
    retuned_pts = []
    fired_log = [False]
    n_retunes = 0
    for p in range(P):
        env_r.set_phase(p)
        if p > 0:
            fired = session_r.probe_drift(detector, incumbent)
            fired_log.append(bool(fired))
            if fired:
                # drop stale measurements, re-anchor on the deployed front
                # re-measured under the new phase, top up with fresh BO
                session_r.retune(sz["n_retune"], reanchor=deployed_r)
                n_retunes += 1
                incumbent = tuner_r.best_config()
                # deployment keeps the live configs and *adds* the re-tuned
                # front — re-tuning augments, it doesn't undeploy
                deployed_r = _dedupe(deployed_r + tuner_r.pareto_configs(max_n=sz["front_n"]))
                detector.reset()
                session_r.probe_drift(detector, incumbent)  # re-baseline
        pts, kept = _measure_points(env_r, spec, deployed_r)
        retuned_pts.append(pts)
        # prune to the configs on the *measured* front of this phase (a
        # deployment keeps only its current winners live)
        if len(pts) > 1:
            arr = np.asarray(pts, np.float64)
            nd_front = pareto_front(arr)
            keep = [i for i, y in enumerate(arr) if any(np.allclose(y, f) for f in nd_front)]
            deployed_r = [kept[i] for i in keep[: 2 * sz["front_n"]]]

    # --- hypervolume over time: joint per-phase normalization -------------
    # an arm whose whole deployed set fails under a phase scores hv=0 there
    hv_f, hv_r = [], []
    for p in range(P):
        both = frozen_pts[p] + retuned_pts[p]
        if not both:
            hv_f.append(0.0)
            hv_r.append(0.0)
            continue
        ymax = np.asarray(both, np.float64).max(axis=0)
        ymax = np.where(ymax <= 0, 1.0, ymax)
        ref = np.zeros(2)

        def hv_of(pts):
            if not pts:
                return 0.0
            return hv_2d(pareto_front(np.asarray(pts, np.float64) / ymax), ref)

        hv_f.append(hv_of(frozen_pts[p]))
        hv_r.append(hv_of(retuned_pts[p]))

    out = {
        "schedule": schedule,
        "trace": trace.name,
        "n_phases": P,
        "frozen": {
            "phase_hv": [float(h) for h in hv_f],
            "mean_hv": float(np.mean(hv_f)),
            "n_evals": int(env_f.n_evals),
            "points": frozen_pts,
        },
        "retuned": {
            "phase_hv": [float(h) for h in hv_r],
            "mean_hv": float(np.mean(hv_r)),
            "n_evals": int(env_r.n_evals),
            "n_retunes": int(n_retunes),
            "drift_fired": fired_log,
            "probe_rel": [float(e["rel"]) for e in detector.log],
            "points": retuned_pts,
        },
        "session": session_r.ledger_dict(),
    }
    emit(
        f"streaming/{schedule}/frozen",
        out["frozen"]["n_evals"],
        f"hv={out['frozen']['mean_hv']:.3f}",
    )
    emit(
        f"streaming/{schedule}/retuned",
        out["retuned"]["n_evals"],
        f"hv={out['retuned']['mean_hv']:.3f};retunes={n_retunes}",
    )
    return out


# ---------------------------------------------------------------------------
# invariant checks (the streaming-engine gates of --check-invariants)
# ---------------------------------------------------------------------------
def _oracle_ground_truth(trace, k):
    """Independent brute-force oracle: per-query python sweep over the ids
    visible at the query's timestamp (no batching, no masking tricks)."""
    all_vec = trace.all_vectors()
    visible: set = set(range(trace.n_base))
    out = -np.ones((trace.n_searches, k), np.int32)
    n_ins = 0
    for i in range(trace.n_ops):
        kind = int(trace.kinds[i])
        if kind == 0:  # insert
            visible.add(trace.n_base + n_ins)
            n_ins += 1
        elif kind == 2:  # delete
            visible.discard(int(trace.payload[i]))
        else:
            ids = np.fromiter(sorted(visible), np.int64)
            q = trace.queries[int(trace.payload[i])]
            sims = all_vec[ids] @ q
            order = np.argsort(-sims, kind="stable")[: min(k, ids.size)]
            row = int(trace.payload[i])
            out[row, : order.size] = ids[order].astype(np.int32)
    return out


def check_invariants(seed: int = 0, mode: str = "analytic", device=None):
    """Returns ``(failures, summary)``: a list of failure strings (empty =
    all invariants hold) plus a replay summary — the engine's structured
    lifecycle snapshot (``LiveVDMS.stats()``) and the serving-facing
    throughput/latency numbers (QPS with p50/p99 percentiles)."""
    failures = []
    trace = make_trace(
        "glove_like",
        n_base=700,
        n_ops=260,
        seed=seed,
        drift="ramp",
        mix=(0.30, 0.55, 0.15),
    )
    cfg = dict(
        index_type="IVF_FLAT",
        nlist=32,
        nprobe=8,
        segment_max_size=512,
        seal_proportion=0.6,
        graceful_time=0.2,
        search_batch_size=16,
        topk_merge_width=32,
        kmeans_iters=4,
        storage_bf16=False,
    )
    device = resolve_device(device)
    result, live = replay_trace(trace, cfg, seed=seed, mode=mode, with_live=True, device=device)
    if any(b < a for a, b in zip(live.seal_history, live.seal_history[1:])):
        failures.append(f"sealed-segment count decreased: {live.seal_history}")
    if live.n_seals < 1:
        failures.append("trace too small: no seal event exercised")
    summary = {
        "stats": live.stats(),
        "qps": result["speed"],
        "lat_p50_s": result["lat_p50_s"],
        "lat_p99_s": result["lat_p99_s"],
        "recall": result["recall"],
    }

    gt_fast = time_aware_ground_truth(trace, device=device)
    gt_oracle = _oracle_ground_truth(trace, trace.k)
    for row, (a, b) in enumerate(zip(gt_fast, gt_oracle)):
        if set(a.tolist()) != set(b.tolist()):
            failures.append(f"time-aware GT row {row} mismatch: {a} vs oracle {b}")
            break
    r_fast = replay_trace(trace, cfg, seed=seed, mode=mode, ground_truth=gt_fast, device=device)
    r_oracle = replay_trace(trace, cfg, seed=seed, mode=mode, ground_truth=gt_oracle,
                            device=device)
    if abs(r_fast["recall"] - r_oracle["recall"]) > 1e-12:
        failures.append(f"recall accounting diverges from oracle: " f"{r_fast['recall']} vs {r_oracle['recall']}")
    return failures, summary


def run(seed: int = 0, quick: bool = True, schedules=SCHEDULES, mode: str = "analytic",
        index_types=None, device=None):
    index_types = parse_index_types(index_types)
    # IVF_PQR joins this suite's space only when the filter names it: scope
    # the registration so later suites in the same process keep the default
    added_pqr = (index_types is not None and ivf_pqr.FAMILY.name in index_types
                 and ivf_pqr.FAMILY.name not in registered_names())
    if added_pqr:
        ivf_pqr.register()
    try:
        return {s: run_schedule(s, seed=seed, quick=quick, mode=mode, index_types=index_types,
                                device=device) for s in schedules}
    finally:
        if added_pqr:
            unregister_family(ivf_pqr.FAMILY.name)


def parse_index_types(value):
    """Normalize an ``--index-types`` value (comma list or sequence) and
    validate it against the registry, raising ``ValueError`` with the sorted
    registered families on unknown names. ``IVF_PQR`` counts when the
    filter names it: the suites that take the filter register it for their
    own run."""
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="the small budgets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="analytic", choices=("analytic", "wall"))
    p.add_argument("--schedules", nargs="+", default=list(SCHEDULES), choices=("none", "ramp", "step", "sine"))
    p.add_argument(
        "--index-types",
        default=None,
        metavar="A,B,...",
        help="restrict tuning to these registered index families (comma list; IVF_PQR included)",
    )
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", default=None, metavar="PATH", help="write results as JSON")
    p.add_argument("--check-invariants", action="store_true", help="exit 1 unless the streaming-engine invariants hold")
    p.add_argument("--check-improvement", action="store_true",
                   help="exit 1 unless re-tuning beats frozen mean HV for "
                        ">= 1 schedule")
    args = p.parse_args(argv)
    try:
        index_types = parse_index_types(args.index_types)
    except ValueError as e:
        p.error(str(e))

    out = {"quick": bool(args.quick), "seed": args.seed, "mode": args.mode,
           "sizes": _sizes(args.quick), "index_types": args.index_types, "schedules": {}}
    if args.check_invariants:
        failures, summary = check_invariants(seed=args.seed, mode=args.mode, device=args.device)
        out["invariants"] = {"ok": not failures, "failures": failures, "replay": summary}
        for f in failures:
            print(f"INVARIANT FAILED: {f}", file=sys.stderr)
        print(
            f"invariants replay: qps={summary['qps']:.1f} "
            f"p50={summary['lat_p50_s'] * 1e3:.3f}ms "
            f"p99={summary['lat_p99_s'] * 1e3:.3f}ms "
            f"seals={summary['stats']['n_seals']} "
            f"compactions={summary['stats']['n_compactions']} "
            f"tombstones={summary['stats']['tombstone_fraction']:.3f}"
        )
    out["schedules"] = run(
        seed=args.seed,
        quick=args.quick,
        schedules=args.schedules,
        mode=args.mode,
        index_types=index_types,
        device=args.device,
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    wins = []
    for s, r in out["schedules"].items():
        d = r["retuned"]["mean_hv"] - r["frozen"]["mean_hv"]
        wins.append(d > 0)
        print(
            f"{s}: frozen hv={r['frozen']['mean_hv']:.3f} "
            f"retuned hv={r['retuned']['mean_hv']:.3f} "
            f"(delta {d:+.3f}, retunes={r['retuned']['n_retunes']}, "
            f"fired={r['retuned']['drift_fired']})"
        )
    rc = 0
    if args.check_invariants and not out["invariants"]["ok"]:
        rc = 1
    if args.check_improvement and not any(wins):
        print("IMPROVEMENT CHECK FAILED: re-tuning never beat frozen", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
