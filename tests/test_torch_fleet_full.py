"""``bench_fleet`` at its full budgets (four tenants, traces of 1,024 base and
384 operations, 16 observations a tenant, analytic), the port with the JAX
package's build draws injected against the JAX package's own run.

At these budgets the JAX package's warm-wins gate fails for keyword_like:
its warm arrival reaches the target after 0.4169 eval-seconds, its cold
baseline after 0.2596. The port reproduces that crossing exactly.

The two runs do not agree in every round. glove_like's cold arm (seed 7,
the first arm the benchmark runs) parts at a BO round where both packages
hold the same candidates, front and Monte-Carlo draws, but GPs fitted on
equal inputs that differ through f32 ``exp`` drift (ROADMAP Queue 3), so
each package's EHVI ranks its own pick first. keyword_like's warm arm parts
at round 11, after both packages have crossed the target. The test asserts
every round before such a parting, that the parting comes from the
posteriors alone, the transfer reports, the crossings and the verdicts of
the three gates. Run it with ``-s`` to print the parting round, the EHVI
margins and the GP drift.
"""
import copy
import json

import numpy as np
import pytest
import torch

from test_torch_fleet import builtin_families_only  # noqa: F401  (a fixture)

CPU = "cpu"
N_BO = 16 - 7  # BO rounds of a cold arm: 16 observations, the seven defaults first
# keyword_like's warm arm parts after both packages crossed the target; its
# rounds before this one are compared exactly
KEYWORD_WARM_PARTS_AT = 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_selections(monkeypatch, tuner_mod):
    """Wrap a tuner module's q-EHVI selection: for its first ``N_BO`` calls
    (glove_like's cold arm) keep the candidates, the front, the draws the
    selection consumed, the pick, the GP's posterior on the candidates and
    its log-hyperparameters."""
    recs = []
    select = tuner_mod.fused_qehvi_select

    def recording(gp, Xc, front, ref, rng, q, n_samples=64):
        state = copy.deepcopy(rng.bit_generator.state)
        picks = select(gp, Xc, front, ref, rng, q, n_samples)
        if len(recs) < N_BO:
            replay = np.random.Generator(type(rng.bit_generator)())
            replay.bit_generator.state = state
            mean, std = gp.predict(Xc)
            params = gp.params.to_lists()
            recs.append(dict(
                Xc=np.array(Xc), front=np.array(front), picks=list(picks),
                eps=replay.standard_normal((n_samples, Xc.shape[0], 2)),
                mean=np.asarray(mean, np.float64), std=np.asarray(std, np.float64),
                params=np.concatenate([np.ravel(params[k])
                                       for k in ("log_ls", "log_sf", "log_noise")])))
        return picks

    monkeypatch.setattr(tuner_mod, "fused_qehvi_select", recording)
    return recs


def _ehvi(rec, i):
    """Monte-Carlo EHVI of candidate ``i`` under ``rec``'s posterior with
    the draws its selection used (reference point (0.5, 0.5))."""
    from repro_torch.core.acquisition import hvi_2d

    samples = rec["mean"][i][None] + rec["std"][i][None] * rec["eps"][:, i]
    return float(hvi_2d(samples, rec["front"], np.array([0.5, 0.5])).mean())


def _parting(mine, theirs):
    """The first BO round whose picks differ (None if none does), after
    checking that both packages selected from the same candidates, front and
    draws up to it and that each package's EHVI ranks its own pick first."""
    assert len(mine) == len(theirs) == N_BO
    for j, (p, r) in enumerate(zip(mine, theirs)):
        assert np.array_equal(p["Xc"], r["Xc"]), j
        assert np.array_equal(p["front"], r["front"]), j
        assert np.array_equal(p["eps"], r["eps"]), j
        if p["picks"] == r["picks"]:
            continue
        a, b = p["picks"][0], r["picks"][0]
        margins = (_ehvi(p, a) - _ehvi(p, b), _ehvi(r, b) - _ehvi(r, a))
        print(f"glove_like cold arm parts at BO round {j}: the port picks {a}, the reference "
              f"{b}; EHVI margins of each package's own pick {margins[0]:.6g} (port, "
              f"{margins[0] / _ehvi(p, a):.3%}) and {margins[1]:.6g} (reference, "
              f"{margins[1] / _ehvi(r, b):.3%}); max |posterior mean difference| "
              f"{np.abs(p['mean'] - r['mean']).max():.3g}; max |log-hyperparameter "
              f"difference| {np.abs(p['params'] - r['params']).max():.3g} (first fit "
              f"{np.abs(mine[0]['params'] - theirs[0]['params']).max():.3g})")
        assert margins[0] >= 0 and margins[1] >= 0, margins
        return j
    return None


def _trajectory(rounds):
    # budget_spent_s is fleet-wide, so one tenant's parting moves every tenant's
    return [(r["n_evals"], r["cost_s"], r["hv"], r["hv_gain"]) for r in rounds]


def test_full_bench_fleet_matches_reference_until_gp_drift(builtin_families_only,  # noqa: F811
                                                           monkeypatch):
    import repro.core.tuner as ref_tuner
    import repro_torch.core.tuner as tuner
    from benchmarks import bench_fleet as ref_bench
    from repro_torch.bench import bench_fleet
    from torch_parity import ReferenceDraws

    mine_recs = _record_selections(monkeypatch, tuner)
    theirs_recs = _record_selections(monkeypatch, ref_tuner)
    mine = bench_fleet.run(quick=False, device=CPU, draws=ReferenceDraws)
    theirs = ref_bench.run(quick=False)
    assert mine["sizes"] == theirs["sizes"] == dict(n_base=1024, n_ops=384, n_iters=16)
    assert mine["resume_bit_identical"] and theirs["resume_bit_identical"]

    j = _parting(mine_recs, theirs_recs)
    parts_at = {("glove_like", "cold_rounds"): None if j is None else j + 1,  # round 0: defaults
                ("keyword_like", "warm_rounds"): KEYWORD_WARM_PARTS_AT}
    for fam in ("glove_like", "keyword_like"):
        m, t = mine["families"][fam], json.loads(json.dumps(theirs["families"][fam]))
        for arm in ("cold_rounds", "warm_rounds"):
            upto = parts_at.get((fam, arm))
            assert _trajectory(m[arm])[:upto] == _trajectory(t[arm])[:upto], (fam, arm)
        assert m["transfer"] == t["transfer"] and m["fallback_transfer"] == t["fallback_transfer"]
        assert m["fallback_matches_cold"] and t["fallback_matches_cold"]
        assert m["warm_seconds_to_target"] == t["warm_seconds_to_target"]
        assert m["warm_wins"] == t["warm_wins"], fam
    kw, kw_ref = mine["families"]["keyword_like"], theirs["families"]["keyword_like"]
    assert kw["target_hv"] == kw_ref["target_hv"]
    assert kw["cold_seconds_to_target"] == kw_ref["cold_seconds_to_target"]
    assert not kw["warm_wins"]  # the reference's own gate fails here, and so does the port's
