"""Fleet tuning: warm-started arrivals vs cold start under a shared budget
(the twin of the JAX package's ``benchmarks/bench_fleet.py``; each tenant's
replays and GP run on ``--device``, the GPU unless ``--device cpu`` is
given).

A four-tenant fleet spanning two workload families (``glove_like`` and
``keyword_like``, two seeds each) runs through ``repro_torch.fleet``:

1. **Establish** — the first tenant of each family tunes cold under the
   shared-budget scheduler, producing the ledgers transfer draws from.
2. **Arrive warm** — a new tenant per family joins, is warm-started from the
   most similar established tenants (``FleetSession.warm_start``: descriptor
   embedding -> ranked sources -> noise-inflated observation import), and
   tunes under the ``gain_per_cost`` scheduler.
3. **Cold baselines** — the same arrivals (identical seeds, fresh envs) tune
   solo with no transfer: the control arm.

Scoring is *eval-seconds to target hypervolume*: the cumulative analytic
evaluation cost a tenant is charged before its fresh-observation front first
reaches 90% of the cold arm's final hypervolume. Warm tenants skip the
mandatory per-index-type default sweep (their imports mark every type seen)
and start from an informed surrogate, so they should cross the target
strictly cheaper.

``--check-improvement`` exits non-zero unless, per family:

* the warm arrival reaches the target in strictly fewer eval-seconds than
  the cold baseline,
* the no-similar-tenant fallback (similarity floor at 1.0) tracks the cold
  baseline's trajectory exactly (never worse than cold start), and
* a mid-run ``state_dict`` -> restore round-trip reproduces the remaining
  rounds bit-identically (configs, objectives, charges, scheduler state).

``--json`` records per-tenant rounds, transfer reports, the crossing points
and the fleet ledger.

    PYTHONPATH=src python -m repro_torch.bench.bench_fleet --device cpu --quick --check-improvement
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core import TuningSession, VDTuner
from ..device import resolve_device
from ..fleet import (
    FleetBudget,
    FleetScheduler,
    FleetSession,
    TransferPolicy,
    describe_env,
)
from ..vdms import VDMSTuningEnv, make_space, make_trace

from .common import emit

#: (family, seed) per tenant — one established + one arrival per family
ESTABLISHED = (("glove_like", 0), ("keyword_like", 1))
ARRIVALS = (("glove_like", 7), ("keyword_like", 8))
MIX = (0.20, 0.75, 0.05)
TARGET_FRAC = 0.9  # target HV = this fraction of the cold arm's final HV


def _sizes(quick: bool):
    if quick:
        return dict(n_base=512, n_ops=160, n_iters=12)
    return dict(n_base=1024, n_ops=384, n_iters=16)


def _tenant_name(family: str, seed: int) -> str:
    return f"{family}-{seed}"


def _make_tenant(family: str, seed: int, sz, device=None, draws=None) -> tuple:
    """Fresh (session, descriptor) for one tenant — identical construction
    for warm, fallback and cold arms, so trajectories are comparable. The
    replays and the GP run on ``device``; ``draws`` is the environment's
    source of build draws (default ``BuildDraws``)."""
    trace = make_trace(
        family, n_base=sz["n_base"], n_ops=sz["n_ops"], seed=seed, mix=MIX,
    )
    env = VDMSTuningEnv(
        trace=trace, workload="streaming", mode="analytic", seed=seed, n_phases=1,
        device=device, draws=draws,
    )
    tuner = VDTuner(make_space(), env, seed=seed, warm_start=True, device=device)
    return TuningSession(tuner), describe_env(env, name=_tenant_name(family, seed))


def _round_trajectory(tenant) -> list:
    """The deterministic per-round projection two arms are compared on
    (budget_spent_s is fleet-wide, so it is excluded)."""
    return [
        (r["n_evals"], r["cost_s"], r["hv"], r["hv_gain"]) for r in tenant.rounds
    ]


def _history_projection(session) -> list:
    return [
        (o.config, [float(v) for v in o.y], o.failed, o.bootstrap, o.noise_scale)
        for o in session.tuner.history
    ]


def _seconds_to_target(tenant, target: float):
    """Cumulative charged eval-seconds at the first round whose fresh-front
    hypervolume reaches ``target`` — None when it never does."""
    cum = 0.0
    for r in tenant.rounds:
        cum += r["cost_s"]
        if r["hv"] >= target:
            return cum
    return None


def _run_cold(family: str, seed: int, sz, make) -> object:
    """Solo cold-start arm: same tenant construction, no transfer."""
    fleet = FleetSession(FleetBudget(1e9))
    session, desc = make(family, seed, sz)
    fleet.add_tenant(_tenant_name(family, seed), session, desc, n_iters=sz["n_iters"])
    fleet.run()
    return fleet.tenant(_tenant_name(family, seed))


def _build_fleet(sz, policy: TransferPolicy) -> FleetSession:
    return FleetSession(
        FleetBudget(1e9),
        scheduler=FleetScheduler("gain_per_cost"),
        transfer_policy=policy,
    )


def _establish(fleet: FleetSession, sz, make) -> None:
    for family, seed in ESTABLISHED:
        session, desc = make(family, seed, sz)
        fleet.add_tenant(_tenant_name(family, seed), session, desc, n_iters=sz["n_iters"])
    fleet.run()


def _add_arrivals(fleet: FleetSession, sz, make) -> list:
    reports = []
    for family, seed in ARRIVALS:
        session, desc = make(family, seed, sz)
        fleet.add_tenant(_tenant_name(family, seed), session, desc, n_iters=sz["n_iters"])
        reports.append(fleet.warm_start(_tenant_name(family, seed)))
    return reports


def _resume_check(fleet_state: dict, sz, policy: TransferPolicy, want: dict, make) -> bool:
    """Restore a fresh fleet from ``fleet_state`` (JSON round-tripped), run it
    to completion, and compare the deterministic projection against the
    uninterrupted run's."""
    resumed = _build_fleet(sz, policy)
    for family, seed in ESTABLISHED + ARRIVALS:
        session, desc = make(family, seed, sz)
        resumed.add_tenant(
            _tenant_name(family, seed), session, desc, n_iters=sz["n_iters"]
        )
    resumed.load_state_dict(json.loads(json.dumps(fleet_state)))
    resumed.run()
    got = {
        "scheduler": resumed.scheduler.state_dict(),
        "spent_s": resumed.budget.spent_s,
        "tenants": {
            n: {
                "rounds": _round_trajectory(resumed.tenant(n)),
                "history": _history_projection(resumed.session_of(n)),
            }
            for n in resumed.tenant_names
        },
    }
    return got == want


def run(seed: int = 0, quick: bool = True, device=None, draws=None):
    """The benchmark; every tenant's environment and tuner are built on
    ``device`` with ``draws`` (see :func:`_make_tenant`)."""
    device = resolve_device(device)

    def make(family, tseed, sz):
        return _make_tenant(family, tseed, sz, device=device, draws=draws)

    sz = _sizes(quick)
    policy = TransferPolicy()
    out = {"sizes": dict(sz), "families": {}}

    # cold baselines for the arrivals (the control arm)
    cold = {}
    for family, aseed in ARRIVALS:
        cold[family] = _run_cold(family, aseed, sz, make)

    # establish the fleet, then warm-start the arrivals off it
    fleet = _build_fleet(sz, policy)
    _establish(fleet, sz, make)
    reports = _add_arrivals(fleet, sz, make)

    # a few scheduled rounds into the arrivals' tuning, checkpoint the whole
    # fleet mid-run, then finish; the resume arm must reproduce the rest
    for _ in range(3):
        runnable = [n for n in fleet.tenant_names if fleet.tenant(n).wants_more]
        if not runnable:
            break
        fleet.run_tenant_round(fleet.scheduler.pick(fleet.tenant_names, runnable))
    mid_state = fleet.state_dict()
    fleet.run()
    want = {
        "scheduler": fleet.scheduler.state_dict(),
        "spent_s": fleet.budget.spent_s,
        "tenants": {
            n: {
                "rounds": _round_trajectory(fleet.tenant(n)),
                "history": _history_projection(fleet.session_of(n)),
            }
            for n in fleet.tenant_names
        },
    }
    resume_ok = _resume_check(mid_state, sz, policy, want, make)

    # fallback arm: a similarity floor no real tenant clears -> cold start
    fallback_policy = TransferPolicy(min_similarity=1.0)
    fb_fleet = _build_fleet(sz, fallback_policy)
    _establish(fb_fleet, sz, make)
    fb_reports = _add_arrivals(fb_fleet, sz, make)
    fb_fleet.run()

    for (family, aseed), report, fb_report in zip(ARRIVALS, reports, fb_reports):
        name = _tenant_name(family, aseed)
        warm_t = fleet.tenant(name)
        cold_t = cold[family]
        fb_t = fb_fleet.tenant(name)
        target = TARGET_FRAC * cold_t.last_hv
        warm_s = _seconds_to_target(warm_t, target)
        cold_s = _seconds_to_target(cold_t, target)
        fallback_matches_cold = (
            fb_report.fallback
            and _round_trajectory(fb_t) == _round_trajectory(cold_t)
            and _history_projection(fb_t.session) == _history_projection(cold_t.session)
        )
        out["families"][family] = {
            "tenant": name,
            "target_hv": target,
            "cold_final_hv": cold_t.last_hv,
            "warm_final_hv": warm_t.last_hv,
            "cold_seconds_to_target": cold_s,
            "warm_seconds_to_target": warm_s,
            "warm_wins": warm_s is not None
            and cold_s is not None
            and warm_s < cold_s,
            "transfer": report.to_dict(),
            "fallback_transfer": fb_report.to_dict(),
            "fallback_matches_cold": fallback_matches_cold,
            "cold_rounds": [dict(r) for r in cold_t.rounds],
            "warm_rounds": [dict(r) for r in warm_t.rounds],
        }
        emit(
            f"fleet/{family}/warm_vs_cold",
            (warm_s or 0.0) * 1e6,
            f"cold_s={cold_s};warm_s={warm_s};"
            f"imported={report.n_imported};fallback_ok={fallback_matches_cold}",
        )

    out["resume_bit_identical"] = resume_ok
    out["ledger"] = fleet.ledger_dict()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="the smaller budgets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", default=None, metavar="PATH", help="write results as JSON")
    p.add_argument(
        "--check-improvement", action="store_true",
        help="exit 1 unless warm arrivals beat cold start per family, the "
             "no-source fallback tracks cold exactly, and mid-run resume is "
             "bit-identical",
    )
    args = p.parse_args(argv)

    out = run(seed=args.seed, quick=args.quick, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)

    ok = bool(out["resume_bit_identical"])
    for family, r in out["families"].items():
        print(
            f"{family}: cold {r['cold_seconds_to_target']}s -> "
            f"warm {r['warm_seconds_to_target']}s to {TARGET_FRAC:.0%} of cold "
            f"final HV ({r['cold_final_hv']:.1f}); "
            f"imported={r['transfer']['n_imported']}, "
            f"fallback_matches_cold={r['fallback_matches_cold']}"
        )
        ok = ok and r["warm_wins"] and r["fallback_matches_cold"]
    print(f"resume_bit_identical={out['resume_bit_identical']}")

    if args.check_improvement and not ok:
        print(
            "FLEET CHECK FAILED: warm arrivals must reach target HV strictly "
            "cheaper than cold, the fallback must track cold exactly, and "
            "mid-run resume must be bit-identical",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
