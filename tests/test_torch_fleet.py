"""Fleet tuning of the port: descriptors, cross-tenant transfer, shared
budget (the twin of ``tests/test_fleet.py``, its doc-sync tests replaced by
a check of ``feature_table()`` against the JAX package's), plus parity with
the JAX package on the same inputs: descriptors, the embedding, source
ranking, observation selection, the transfer, the schedulers, the purge, and
``bench_fleet`` at its quick and its full budgets with the reference's build
draws injected, each session held up to where GP drift parts it.

Covers the four layers the fleet is built from:

1. **Descriptors/embedding** — workload fingerprints separate the dataset
   families, the PCA embedding is deterministic and JSON round-trips, and
   similarity uses the absolute characteristic scales (not fleet-relative).
2. **Core hooks** — ``SearchSpace.encoding_signature``, the GP's per-row
   ``noise_scale`` and ``prior_mean`` hooks, ``TuningSession.tell`` /
   ``import_observations`` budget semantics.
3. **Transfer policy** — source ranking, Pareto-first selection, the
   cold-start fallback (bit-identical session) and the divergence guard.
4. **FleetSession** — scheduler policies, shared-budget stop, the
   schema-versioned ledger, and a hypothesis property: ``state_dict`` ->
   restore mid-round (pending queues included) is bit-identical.

The port's tuners run their GP on the CPU here (``device="cpu"``).
"""
import copy
import dataclasses
import itertools
import json

import numpy as np
import pytest

import torch

import repro.fleet as rf
from repro_torch.core import Param, SearchSpace, StopSession, TuningSession, VDTuner
from repro_torch.core.gp import GP
from repro_torch.core.tuner import Observation
from repro_torch.fleet import (
    FEATURE_NAMES,
    FLEET_LEDGER_SCHEMA,
    DescriptorEmbedding,
    FleetBudget,
    FleetScheduler,
    FleetSession,
    TransferPolicy,
    WorkloadDescriptor,
    apply_transfer,
    check_divergence,
    describe_trace,
    divergence_score,
    feature_table,
    purge_imports,
    rank_sources,
    select_observations,
)
from repro_torch.vdms import make_trace
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

_FAST = dict(gp_fit_steps=24, n_candidates=48, mc_samples=16)
CPU = "cpu"


def _toy_objective(cfg):
    t = cfg["index_type"]
    k = cfg.get("ka", cfg.get("kb", 0.5))
    k = k / 8.0 if t == "A" else k
    sysq = 1.0 - (cfg["s1"] - 0.6) ** 2
    speed = 80 * (1 - k) * sysq if t == "A" else 50 * (1 - k) * sysq
    recall = 0.5 + 0.45 * k if t == "A" else 0.6 + 0.39 * k
    # deterministic modeled replay seconds -> deterministic fleet charges
    return {"speed": speed, "recall": recall, "search_s": 0.01 + 0.001 * k}


def _toy_space():
    return SearchSpace(
        index_types={
            "A": [Param("ka", "grid", choices=(1, 2, 4, 8), default=2)],
            "B": [Param("kb", "float", 0.0, 1.0, default=0.5)],
        },
        system_params=[
            Param("s1", "float", 0.0, 1.0, default=0.5),
            Param("s2", "cat", choices=(False, True), default=False),
        ],
    )


def _toy_session(seed=11, **kw):
    return TuningSession(VDTuner(_toy_space(), _toy_objective, seed=seed, device=CPU, **_FAST),
                         **kw)


_BASE_FEATURES = dict(
    log_corpus=4.0, log_dim=2.0, log_k=1.0,
    insert_frac=0.2, search_frac=0.75, delete_frac=0.05,
    drift=0.1, dispersion=0.9, centroid_align=0.2, coord_kurtosis=3.0,
)


def _desc(name, **over):
    return WorkloadDescriptor(name=name, features=dict(_BASE_FEATURES, **over))


# ---------------------------------------------------------------------------
# descriptors + embedding
# ---------------------------------------------------------------------------
def test_describe_trace_is_finite_and_separates_families():
    glove = describe_trace(
        make_trace("glove_like", n_base=256, n_ops=96, seed=0, mix=(0.2, 0.75, 0.05))
    )
    keyword = describe_trace(
        make_trace("keyword_like", n_base=256, n_ops=96, seed=1, mix=(0.2, 0.75, 0.05))
    )
    for d in (glove, keyword):
        v = d.vector()
        assert v.shape == (len(FEATURE_NAMES),) and np.all(np.isfinite(v))
        mix = d.features["insert_frac"] + d.features["search_frac"] + d.features["delete_frac"]
        assert mix == pytest.approx(1.0)
    # sparse keyword corpora have much heavier coordinate kurtosis
    assert keyword.features["coord_kurtosis"] > 2 * glove.features["coord_kurtosis"]


def test_descriptor_roundtrip_and_validation():
    d = _desc("t")
    assert WorkloadDescriptor.from_dict(json.loads(json.dumps(d.to_dict()))) == d
    with pytest.raises(ValueError, match="missing features"):
        WorkloadDescriptor(name="bad", features={"log_corpus": 1.0})


def test_embedding_similarity_structure():
    a1 = _desc("a1")
    a2 = _desc("a2", insert_frac=0.25, search_frac=0.7, drift=0.12)  # seed jitter
    b = _desc("b", coord_kurtosis=9.0, insert_frac=0.6, search_frac=0.35, dispersion=0.5)
    emb = DescriptorEmbedding().fit([a1, a2, b])
    assert emb.similarity(a1, a1) == pytest.approx(1.0)
    assert emb.similarity(a1, a2) == pytest.approx(emb.similarity(a2, a1))
    # same family (jitter apart) scores well above the cross-family pair:
    # fixed characteristic scales keep seed noise off the family-signal axis
    assert emb.similarity(a1, a2) > 0.5
    assert emb.similarity(a1, b) < 0.2
    # deterministic: refitting produces the identical embedding
    emb2 = DescriptorEmbedding().fit([a1, a2, b])
    assert np.array_equal(emb.embed(a1), emb2.embed(a1))


def test_embedding_state_roundtrips_exactly():
    emb = DescriptorEmbedding(n_components=3).fit([_desc("x"), _desc("y", drift=0.4)])
    state = json.loads(json.dumps(emb.state_dict()))
    emb2 = DescriptorEmbedding().load_state_dict(state)
    assert np.array_equal(emb.embed(_desc("z")), emb2.embed(_desc("z")))
    assert emb.similarity(_desc("x"), _desc("y", drift=0.4)) == emb2.similarity(
        _desc("x"), _desc("y", drift=0.4)
    )


# ---------------------------------------------------------------------------
# core hooks: encoding signature, GP noise_scale / prior_mean, tell / import
# ---------------------------------------------------------------------------
def test_encoding_signature_keys_the_uniform_encoding():
    assert _toy_space().encoding_signature() == _toy_space().encoding_signature()
    other = SearchSpace(
        index_types={
            "A": [Param("ka", "grid", choices=(1, 2, 4, 16), default=2)],  # 16 != 8
            "B": [Param("kb", "float", 0.0, 1.0, default=0.5)],
        },
        system_params=[
            Param("s1", "float", 0.0, 1.0, default=0.5),
            Param("s2", "cat", choices=(False, True), default=False),
        ],
    )
    assert other.encoding_signature() != _toy_space().encoding_signature()


def test_gp_noise_scale_ones_is_bitwise_inert():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(10, 3))
    Y = np.stack([X.sum(axis=1), X[:, 0] - X[:, 1]], axis=1)
    m0, s0 = GP(seed=0, fit_steps=40, device=CPU).fit(X, Y).predict(X)
    m1, s1 = GP(seed=0, fit_steps=40, device=CPU).fit(X, Y, noise_scale=np.ones(10)).predict(X)
    assert np.array_equal(m0, m1) and np.array_equal(s0, s1)


def test_gp_noise_scale_downweights_inflated_rows():
    X = np.linspace(0, 1, 12)[:, None]
    Y = (2.0 * X).astype(np.float64)
    Yc = Y.copy()
    Yc[5, 0] += 5.0  # one corrupted observation
    scale = np.ones(12)
    scale[5] = 100.0
    m_plain, _ = GP(seed=0, fit_steps=80, device=CPU).fit(X, Yc).predict(X[5:6])
    m_down, _ = GP(seed=0, fit_steps=80, device=CPU).fit(X, Yc, noise_scale=scale).predict(X[5:6])
    true = Y[5, 0]
    assert abs(m_down[0, 0] - true) < abs(m_plain[0, 0] - true)


def test_gp_prior_mean_guides_extrapolation():
    X = np.array([[0.1], [0.2], [0.3]])
    Y = 3.0 + 2.0 * X
    Xt = np.array([[0.9]])
    prior = lambda A: 3.0 + 2.0 * np.asarray(A)[:, :1]  # noqa: E731
    m_cold, _ = GP(seed=0, fit_steps=60, device=CPU).fit(X, Y).predict(Xt)
    m_warm, _ = GP(seed=0, fit_steps=60, device=CPU).fit(X, Y, prior_mean=prior).predict(Xt)
    true = 3.0 + 2.0 * 0.9
    assert abs(m_warm[0, 0] - true) < abs(m_cold[0, 0] - true)


def test_observation_noise_scale_serialization_is_backward_compatible():
    o = Observation(
        iteration=0, config={"index_type": "A"}, y=np.array([1.0, 2.0]), raw={},
        recommend_time=0.0, eval_time=0.0,
    )
    assert "noise_scale" not in o.to_dict()  # pre-fleet checkpoints byte-identical
    o.noise_scale = 2.5
    d = o.to_dict()
    assert d["noise_scale"] == 2.5
    assert Observation.from_dict(d).noise_scale == 2.5
    assert Observation.from_dict({k: v for k, v in d.items() if k != "noise_scale"}).noise_scale == 1.0


def test_session_tell_feeds_history_not_ledger():
    session = _toy_session().run(3)
    n_rounds = len(session.rounds)
    n_obs = session.n_observations
    cfg = session.tuner.space.default_config("A")
    obs = session.tell(cfg, _toy_objective(cfg))
    assert obs is session.tuner.history[-1] and not obs.bootstrap
    assert session.n_observations == n_obs + 1  # fresh external measurement
    boot = session.tell(cfg, _toy_objective(cfg), bootstrap=True, noise_scale=2.0)
    assert boot.bootstrap and boot.noise_scale == 2.0
    assert session.n_observations == n_obs + 1  # bootstrap stays off-budget
    assert len(session.rounds) == n_rounds  # external tells are never ledgered


def test_import_observations_skips_warmup_and_budget():
    source = _toy_session(seed=3).run(6)
    target = _toy_session(seed=4)
    sig = source.tuner.space.encoding_signature()
    n = target.import_observations(source.history, noise_scale=3.0, space_signature=sig)
    assert n == len([o for o in source.history if not o.failed])
    assert target.n_observations == 0
    assert all(o.bootstrap and o.noise_scale == 3.0 for o in target.tuner.history)
    # imports recomputed objectives through the local transform
    assert all(np.all(np.isfinite(o.y)) for o in target.tuner.history)
    # every index type is marked seen: the first ask is one BO candidate,
    # not the mandatory per-type default sweep (the warm-start win)
    assert len(target.tuner.ask(1)) == 1
    cold = _toy_session(seed=4)
    assert len(cold.tuner.ask(1)) == len(_toy_space().type_names)


def test_import_observations_refuses_signature_mismatch():
    target = _toy_session()
    with pytest.raises(ValueError, match="signature"):
        target.import_observations([], space_signature="not-the-right-space")


# ---------------------------------------------------------------------------
# transfer policy
# ---------------------------------------------------------------------------
def test_transfer_policy_validation_and_noise():
    p = TransferPolicy(noise_base=2.0, noise_ceil=8.0)
    assert p.noise_for(1.0) == 2.0
    assert p.noise_for(0.5) == 4.0
    assert p.noise_for(0.01) == 8.0  # clipped at the ceiling
    with pytest.raises(ValueError):
        TransferPolicy(k_sources=0)
    with pytest.raises(ValueError):
        TransferPolicy(noise_base=0.5)


def test_rank_sources_floor_and_order():
    a = _desc("a")
    near = _desc("near", drift=0.12)
    far = _desc("far", coord_kurtosis=9.0, insert_frac=0.6, search_frac=0.35)
    emb = DescriptorEmbedding().fit([a, near, far])
    policy = TransferPolicy(k_sources=2, min_similarity=0.3)
    ranked = rank_sources(emb, a, [("far", far), ("near", near)], policy)
    assert [n for n, _ in ranked] == ["near"]  # far fails the floor
    assert ranked[0][1] > 0.3


def test_select_observations_prefers_front_and_excludes_noise():
    def obs(i, speed, recall, failed=False, bootstrap=False):
        o = Observation(
            iteration=i, config={"index_type": "A", "ka": 2, "s1": 0.5, "s2": False},
            y=np.array([speed, recall]), raw={"speed": speed, "recall": recall},
            recommend_time=0.0, eval_time=0.0, failed=failed,
        )
        o.bootstrap = bootstrap
        return o

    history = [
        obs(0, 10.0, 0.99),   # front
        obs(1, 80.0, 0.50),   # front
        obs(2, 9.0, 0.50),    # dominated
        obs(3, 50.0, 0.90),   # front
        obs(4, 99.0, 0.99, failed=True),
        obs(5, 99.0, 0.99, bootstrap=True),
    ]
    picked = select_observations(history, 3)
    # knee first (balanced on both axes), then the extremes in stable order
    assert [o.iteration for o in picked] == [3, 0, 1]
    assert select_observations(history, 4)[-1].iteration == 2  # then the rest
    assert select_observations([], 4) == []


def test_apply_transfer_fallback_is_bit_identical():
    session = _toy_session()
    before = json.dumps(session.state_dict(), sort_keys=True)
    report = apply_transfer(session, "t", [], {}, TransferPolicy())
    assert report.fallback and report.n_imported == 0 and report.sources == []
    assert json.dumps(session.state_dict(), sort_keys=True) == before


def test_divergence_guard_purges_garbage_imports():
    target = _toy_session(seed=5)
    fake = [
        Observation(
            iteration=i,
            config={"index_type": "A", "ka": 2, "s1": 0.4 + 0.05 * i, "s2": False},
            y=np.zeros(2),
            raw={"speed": 4000.0 + 500.0 * i, "recall": 0.99, "search_s": 0.01},
            recommend_time=0.0, eval_time=0.0,
        )
        for i in range(5)
    ]
    target.import_observations(fake, noise_scale=4.0)
    policy = TransferPolicy(check_after=3)
    assert check_divergence(target, policy) is None  # no fresh evidence yet
    target.run(4)
    score = divergence_score(target, policy)
    assert score is not None and score > policy.divergence_threshold
    assert check_divergence(target, policy) is True
    assert not any(o.bootstrap and o.noise_scale != 1.0 for o in target.history)
    assert [o.iteration for o in target.history] == list(range(len(target.history)))


def test_divergence_guard_keeps_consistent_imports():
    source = _toy_session(seed=3).run(6)
    target = _toy_session(seed=6)
    target.import_observations(source.history, noise_scale=2.0)
    policy = TransferPolicy(check_after=3)
    target.run(4)
    score = divergence_score(target, policy)
    assert score is not None and score <= policy.divergence_threshold
    assert check_divergence(target, policy) is False
    assert any(o.bootstrap for o in target.history)  # imports survived


def test_purge_imports_renumbers():
    target = _toy_session(seed=7).run(2)
    source = _toy_session(seed=3).run(4)
    target.import_observations(source.history, noise_scale=2.0)
    n_imported = sum(1 for o in target.history if o.bootstrap)
    assert purge_imports(target) == n_imported
    assert [o.iteration for o in target.history] == list(range(len(target.history)))


# ---------------------------------------------------------------------------
# scheduler + budget + fleet session
# ---------------------------------------------------------------------------
def test_round_robin_scheduler_cycles_and_skips():
    s = FleetScheduler("round_robin")
    order = ["a", "b", "c"]
    assert [s.pick(order, order) for _ in range(4)] == ["a", "b", "c", "a"]
    assert s.pick(order, ["c"]) == "c"
    with pytest.raises(ValueError):
        s.pick(order, [])


def test_gain_per_cost_scheduler_allocates_to_the_winner():
    s = FleetScheduler("gain_per_cost", decay=0.5)
    order = ["a", "b"]
    assert s.pick(order, order) == "a"  # never-run optimism, in order
    s.update("a", hv_gain=1.0, cost_s=1.0)
    assert s.pick(order, order) == "b"  # b still never-run
    s.update("b", hv_gain=10.0, cost_s=1.0)
    assert s.pick(order, order) == "b"  # higher realized gain per second
    for _ in range(4):  # 10 -> 5 -> 2.5 -> 1.25 -> 0.625 < a's 1.0
        s.update("b", hv_gain=0.0, cost_s=100.0)
    assert s.pick(order, order) == "a"  # decayed estimate falls below a's
    state = json.loads(json.dumps(s.state_dict()))
    assert FleetScheduler().load_state_dict(state).state_dict() == s.state_dict()
    with pytest.raises(ValueError):
        FleetScheduler("priority")


def test_fleet_budget_bounds_the_run():
    fleet = FleetSession(FleetBudget(2.5), cost_fn=lambda o: 1.0)
    fleet.add_tenant("a", _toy_session(seed=11), _desc("a"), n_iters=50)
    fleet.run()
    assert fleet.budget.exhausted
    # each round after warm-up costs n_evals * 1.0; the loop stops at the
    # first pick once spent >= total
    assert fleet.budget.spent_s >= 2.5
    assert fleet.tenant("a").session.n_observations < 50


def test_fleet_warm_start_guards_and_ledger():
    fleet = FleetSession(FleetBudget(1e9), transfer_policy=TransferPolicy())
    fleet.add_tenant("src", _toy_session(seed=11), _desc("src"), n_iters=4)
    fleet.run()
    fleet.add_tenant("tgt", _toy_session(seed=12), _desc("tgt", drift=0.12), n_iters=4)
    report = fleet.warm_start("tgt")
    assert not report.fallback and report.n_imported > 0
    with pytest.raises(ValueError, match="already warm-started"):
        fleet.warm_start("tgt")
    fleet.run()
    with pytest.raises(ValueError, match="fresh observations"):
        fleet.warm_start("src")
    led = json.loads(json.dumps(fleet.ledger_dict()))
    assert led["schema"] == FLEET_LEDGER_SCHEMA
    assert set(led["tenants"]) == {"src", "tgt"}
    for block in led["tenants"].values():
        assert {"descriptor", "rounds", "events", "transfer", "session"} <= set(block)
    assert led["tenants"]["tgt"]["transfer"]["n_imported"] == report.n_imported
    assert led["budget"]["spent_s"] == fleet.budget.spent_s


def test_fleet_outcome_hook_lands_in_tenant_events():
    fleet = FleetSession(FleetBudget(1e9))
    fleet.add_tenant("a", _toy_session(seed=11), _desc("a"), n_iters=2)
    hook = fleet.outcome_hook("a")
    hook("promote", {"index_type": "A"}, {"recall": 0.9, "speed": 10.0})
    hook("rollback", {"index_type": "B"}, {"recall": 0.5, "speed": 90.0})
    events = fleet.tenant("a").events
    assert [e["event"] for e in events] == ["promote", "rollback"]
    assert events[0]["raw"]["recall"] == 0.9
    json.dumps(fleet.ledger_dict())  # events serialize strictly


# ---------------------------------------------------------------------------
# property: mid-round checkpoint/resume is bit-identical. Runs under
# hypothesis when installed; otherwise sweeps every cut point directly
# (same cases, deterministic).
# ---------------------------------------------------------------------------
try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # optional test dep; pip install -e .[test]
    HAVE_HYPOTHESIS = False

_N_ITERS = 6


def _build_fleet(with_stop_at=None):
    fleet = FleetSession(
        FleetBudget(1e9),
        scheduler=FleetScheduler("round_robin"),
        cost_fn=lambda o: 1.0,
    )
    for i, name in enumerate(("a", "b")):
        callbacks = []
        if with_stop_at is not None:
            def _stop(session, obs, cut=with_stop_at):
                if session.n_observations >= cut:
                    raise StopSession

            callbacks = [_stop]
        fleet.add_tenant(
            name,
            _toy_session(seed=11 + i, callbacks=callbacks),
            _desc(name, drift=0.1 + 0.02 * i),
            n_iters=_N_ITERS,
        )
    return fleet


def _fleet_projection(fleet):
    return {
        "scheduler": fleet.scheduler.state_dict(),
        "spent_s": fleet.budget.spent_s,
        "tenants": {
            n: {
                "rounds": [
                    (r["n_evals"], r["cost_s"], r["hv"], r["hv_gain"])
                    for r in fleet.tenant(n).rounds
                ],
                "history": [
                    (o.config, o.y.tolist(), o.failed, o.bootstrap, o.noise_scale)
                    for o in fleet.session_of(n).tuner.history
                ],
            }
            for n in fleet.tenant_names
        },
    }


def _check_resume_at(cut):
    # the partial fleet's sessions stop mid-drain at `cut` fresh observations,
    # so the checkpoint lands with non-empty per-tenant pending queues
    part = _build_fleet(with_stop_at=cut)
    part.run(max_rounds=3)
    state = json.loads(json.dumps(part.state_dict()))
    assert any(
        part.session_of(n).n_observations < _N_ITERS for n in part.tenant_names
    )  # the checkpoint is genuinely mid-run

    # reference arm: the original fleet simply keeps going to completion
    part.run()
    want = _fleet_projection(part)

    # resume arm: a fresh identically-built fleet restored from the JSON
    # round-tripped checkpoint must reproduce the remaining rounds exactly —
    # scheduler cursor/estimates, budget charges, round ledgers and history
    resumed = _build_fleet(with_stop_at=cut)
    resumed.load_state_dict(state)
    resumed.run()
    assert _fleet_projection(resumed) == want


if HAVE_HYPOTHESIS:

    @settings(max_examples=4, deadline=None)
    @given(cut=st.integers(1, _N_ITERS - 1))
    def test_fleet_resume_mid_round_is_bit_identical(cut):
        _check_resume_at(cut)

else:

    @pytest.mark.parametrize("cut", range(1, _N_ITERS))
    def test_fleet_resume_mid_round_is_bit_identical(cut):
        _check_resume_at(cut)


def test_fleet_restore_rejects_mismatched_tenants():
    fleet = _build_fleet()
    state = fleet.state_dict()
    other = FleetSession(FleetBudget(1e9))
    other.add_tenant("x", _toy_session(seed=1), _desc("x"), n_iters=2)
    with pytest.raises(ValueError, match="do not match"):
        other.load_state_dict(state)
    with pytest.raises(ValueError, match="version"):
        fleet.load_state_dict(dict(state, version=999))




# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------
def test_feature_table_matches_reference():
    assert feature_table() == rf.feature_table()
    assert FEATURE_NAMES == rf.FEATURE_NAMES


def _trace_pair(family, seed, **kw):
    import repro.vdms as jv

    kw = dict(n_base=256, n_ops=96, seed=seed, mix=(0.2, 0.75, 0.05), **kw)
    return make_trace(family, **kw), jv.make_trace(family, **kw)


@pytest.mark.parametrize("family,seed,drift", [
    ("glove_like", 0, "none"), ("keyword_like", 1, "ramp"), ("georadius_like", 2, "step"),
])
def test_descriptors_match_reference(family, seed, drift):
    mine, theirs = _trace_pair(family, seed, drift=drift)
    d, r = describe_trace(mine), rf.describe_trace(theirs)
    assert d.to_dict() == r.to_dict()


def _fleet_descs():
    a1 = _desc("a1")
    a2 = _desc("a2", insert_frac=0.25, search_frac=0.7, drift=0.12)
    b = _desc("b", coord_kurtosis=9.0, insert_frac=0.6, search_frac=0.35, dispersion=0.5)
    near = _desc("near", drift=0.12)
    return [a1, a2, b, near]


def _ref_desc(d):
    return rf.WorkloadDescriptor.from_dict(d.to_dict())


@pytest.mark.parametrize("n_components,config_weight", [(4, 0.5), (2, 0.0), (3, 1.0)])
def test_embedding_and_ranking_match_reference(n_components, config_weight):
    descs = _fleet_descs()
    rng = np.random.default_rng(n_components)
    summaries = [None] + [rng.uniform(size=5) for _ in descs[1:]]
    mine = DescriptorEmbedding(n_components, config_weight).fit(descs, summaries)
    theirs = rf.DescriptorEmbedding(n_components, config_weight).fit(
        [_ref_desc(d) for d in descs], summaries)
    np.testing.assert_allclose(np.asarray(mine.state_dict()["components"]),
                               np.asarray(theirs.state_dict()["components"]), rtol=0, atol=1e-12)
    for a in descs:
        for b in descs:
            assert mine.similarity(a, b) == pytest.approx(
                theirs.similarity(_ref_desc(a), _ref_desc(b)), abs=1e-12)
    for policy in (TransferPolicy(), TransferPolicy(k_sources=3, min_similarity=0.05)):
        rpolicy = rf.TransferPolicy(**dataclasses.asdict(policy))
        cands = [(d.name, d) for d in descs[1:]]
        cand_summaries = {d.name: s for d, s in zip(descs[1:], summaries[1:])}
        got = rank_sources(mine, descs[0], cands, policy, candidate_summaries=cand_summaries)
        want = rf.rank_sources(theirs, _ref_desc(descs[0]),
                               [(n, _ref_desc(d)) for n, d in cands], rpolicy,
                               candidate_summaries=cand_summaries)
        assert [n for n, _ in got] == [n for n, _ in want]
        assert [s for _, s in got] == pytest.approx([s for _, s in want], abs=1e-12)


def _obs_history(obs_cls, rng, n=14):
    out = []
    for i in range(n):
        o = obs_cls(
            iteration=i,
            config={"index_type": "A" if i % 3 else "B", "ka": 2, "kb": 0.5, "s1": 0.1 * (i % 7),
                    "s2": bool(i % 2)},
            y=np.array([float(rng.uniform(1, 90)), float(rng.uniform(0.4, 1.0))]),
            raw={"speed": 1.0, "recall": 1.0}, recommend_time=0.0, eval_time=0.0,
            failed=bool(i == 4),
        )
        o.bootstrap = bool(i == 6)
        if i % 5 == 0:  # exact ties on one axis
            o.y[1] = 0.9
        out.append(o)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 3, 8, 20])
def test_select_observations_matches_reference(seed, n):
    from repro.core.tuner import Observation as RObservation

    mine = _obs_history(Observation, np.random.default_rng(seed))
    theirs = _obs_history(RObservation, np.random.default_rng(seed))
    assert [o.iteration for o in select_observations(mine, n)] == [
        o.iteration for o in rf.select_observations(theirs, n)]


def _ref_toy_session(seed, **kw):
    from repro.core import Param as RParam, SearchSpace as RSpace, TuningSession as RSession
    from repro.core import VDTuner as RTuner

    space = RSpace(
        index_types={
            "A": [RParam("ka", "grid", choices=(1, 2, 4, 8), default=2)],
            "B": [RParam("kb", "float", 0.0, 1.0, default=0.5)],
        },
        system_params=[
            RParam("s1", "float", 0.0, 1.0, default=0.5),
            RParam("s2", "cat", choices=(False, True), default=False),
        ],
    )
    return RSession(RTuner(space, _toy_objective, seed=seed, **_FAST), **kw)


def _history_projection(session):
    return [(o.config, [float(v) for v in o.y], o.failed, o.bootstrap, o.noise_scale,
             o.iteration) for o in session.tuner.history]


def test_apply_transfer_and_purge_match_reference():
    """Sources run the seven-round toy sessions (identical in both packages
    over these rounds); the import, its report and the purge then agree."""
    src, rsrc = _toy_session(seed=3).run(6), _ref_toy_session(seed=3).run(6)
    assert _history_projection(src) == _history_projection(rsrc)
    policy = TransferPolicy(max_import_per_source=4)
    rpolicy = rf.TransferPolicy(**dataclasses.asdict(policy))
    tgt, rtgt = _toy_session(seed=4).run(2), _ref_toy_session(seed=4).run(2)
    sig = src.tuner.space.encoding_signature()
    assert sig == rsrc.tuner.space.encoding_signature()
    rep = apply_transfer(tgt, "t", [("s", 0.8)], {"s": src.history}, policy, {"s": sig})
    rrep = rf.apply_transfer(rtgt, "t", [("s", 0.8)], {"s": rsrc.history}, rpolicy, {"s": sig})
    assert rep.to_dict() == rrep.to_dict()
    assert _history_projection(tgt) == _history_projection(rtgt)
    assert purge_imports(tgt) == rf.purge_imports(rtgt) == 4
    assert _history_projection(tgt) == _history_projection(rtgt)
    with pytest.raises(ValueError, match="signature"):
        apply_transfer(tgt, "t", [("s", 0.8)], {"s": src.history}, policy, {"s": "other"})


def test_schedulers_match_reference():
    rng = np.random.default_rng(5)
    order = ["a", "b", "c", "d"]
    for policy in FleetScheduler.POLICIES:
        mine, theirs = FleetScheduler(policy, decay=0.3), rf.FleetScheduler(policy, decay=0.3)
        for _ in range(40):
            runnable = [n for n in order if rng.random() < 0.8] or ["c"]
            pick = mine.pick(order, runnable)
            assert pick == theirs.pick(order, runnable)
            gain, cost = float(rng.uniform(0, 5)), float(rng.uniform(0.1, 3))
            mine.update(pick, gain, cost)
            theirs.update(pick, gain, cost)
        assert mine.state_dict() == theirs.state_dict()


def test_fleet_session_matches_reference():
    """Two toy tenants, one warm-started, under gain_per_cost: the round
    ledgers, the transfer report and the histories equal the reference's."""
    def build(pkg, session):
        fleet = pkg.FleetSession(pkg.FleetBudget(1e9), scheduler="gain_per_cost",
                                 transfer_policy=pkg.TransferPolicy(), cost_fn=lambda o: 1.0)
        fleet.add_tenant("src", session(11), pkg.WorkloadDescriptor.from_dict(
            _desc("src").to_dict()), n_iters=6)
        fleet.run()
        fleet.add_tenant("tgt", session(12), pkg.WorkloadDescriptor.from_dict(
            _desc("tgt", drift=0.12).to_dict()), n_iters=6)
        report = fleet.warm_start("tgt")
        fleet.run()
        return fleet, report

    import repro_torch.fleet as tf

    mine, rep = build(tf, lambda s: _toy_session(seed=s))
    theirs, rrep = build(rf, lambda s: _ref_toy_session(seed=s))
    assert not rep.fallback and rep.to_dict()["sources"][0]["name"] == "src"
    for k in ("similarity", "noise_scale"):
        assert rep.sources[0][k] == pytest.approx(rrep.sources[0][k], abs=1e-12)
    assert rep.n_imported == rrep.n_imported
    assert mine.scheduler.state_dict()["n"] == theirs.scheduler.state_dict()["n"]
    for n in ("src", "tgt"):
        assert _history_projection(mine.session_of(n)) == _history_projection(
            theirs.session_of(n))
        got = [(r["n_evals"], r["cost_s"]) for r in mine.tenant(n).rounds]
        assert got == [(r["n_evals"], r["cost_s"]) for r in theirs.tenant(n).rounds]
        assert [r["hv"] for r in mine.tenant(n).rounds] == pytest.approx(
            [r["hv"] for r in theirs.tenant(n).rounds], rel=1e-12)


class SelectionLog:
    """Every q-EHVI selection of one package's ``bench_fleet`` run, keyed by
    session (fleet, tenant): the round it fell in, the candidates, the
    front, the Monte-Carlo draws it consumed, its pick, the GP's posterior
    on the candidates and its log-hyperparameters. Fleets are numbered in
    the order the benchmark builds them; a fleet restored from a state dict
    (the resume arm, a self-consistency gate of each package) is left out.
    Also kept: the sources' histories at each warm start."""

    def __init__(self, monkeypatch, fleet_mod, tuner_mod):
        self.sessions = {}
        self.warm_starts = {}  # (fleet, arrival) -> {source: history projection}
        # id -> build order; a freed fleet's id may come back for a later one
        self._fleets, self._built, self._resumed, self._at = {}, itertools.count(), set(), None
        fs_cls, select = fleet_mod.FleetSession, tuner_mod.fused_qehvi_select
        init, run_round = fs_cls.__init__, fs_cls.run_tenant_round
        load, warm_start = fs_cls.load_state_dict, fs_cls.warm_start
        log = self

        def init_(fs, *a, **kw):
            log._fleets[id(fs)] = next(log._built)
            init(fs, *a, **kw)

        def load_(fs, state):
            log._resumed.add(log._fleets[id(fs)])
            return load(fs, state)

        def warm_start_(fs, name):
            log.warm_starts[(log._fleets[id(fs)], name)] = {
                n: _history_projection(fs.session_of(n)) for n in fs.tenant_names if n != name}
            return warm_start(fs, name)

        def run_round_(fs, name):
            log._at = (log._fleets[id(fs)], name, len(fs.tenant(name).rounds))
            try:
                return run_round(fs, name)
            finally:
                log._at = None

        def select_(gp, Xc, front, ref, rng, q, n_samples=64):
            state = copy.deepcopy(rng.bit_generator.state)
            picks = select(gp, Xc, front, ref, rng, q, n_samples)
            fleet, name, rnd = log._at
            if fleet not in log._resumed:
                replay = np.random.Generator(type(rng.bit_generator)())
                replay.bit_generator.state = state
                mean, std = gp.predict(Xc)
                params = gp.params.to_lists()
                log.sessions.setdefault((fleet, name), []).append(dict(
                    round=rnd, Xc=np.array(Xc), front=np.array(front), picks=list(picks),
                    eps=replay.standard_normal((n_samples, Xc.shape[0], 2)),
                    mean=np.asarray(mean, np.float64), std=np.asarray(std, np.float64),
                    params=np.concatenate([np.ravel(params[k])
                                           for k in ("log_ls", "log_sf", "log_noise")])))
            return picks

        monkeypatch.setattr(fs_cls, "__init__", init_)
        monkeypatch.setattr(fs_cls, "load_state_dict", load_)
        monkeypatch.setattr(fs_cls, "warm_start", warm_start_)
        monkeypatch.setattr(fs_cls, "run_tenant_round", run_round_)
        monkeypatch.setattr(tuner_mod, "fused_qehvi_select", select_)


def _ehvi(rec, i):
    """Monte-Carlo EHVI of candidate ``i`` under ``rec``'s posterior with
    the draws its selection used (reference point (0.5, 0.5))."""
    from repro_torch.core.acquisition import hvi_2d

    samples = rec["mean"][i][None] + rec["std"][i][None] * rec["eps"][:, i]
    return float(hvi_2d(samples, rec["front"], np.array([0.5, 0.5])).mean())


def partings(mine: SelectionLog, theirs: SelectionLog):
    """Per session, the round of its first difference from the reference
    (None if its selections never differ), after checking where it comes
    from. GP fits on equal inputs drift apart through f32 ``exp`` (ROADMAP
    Queue 3), so a session may part where both packages hold the same
    candidates, front and draws and each package's EHVI ranks its own pick
    first. The only other allowed difference is in an arrival warm-started
    from sources whose histories already differed (their sessions parted
    before it): its imports differ, so may its selections, their count and
    the divergence guard's verdict. Anything else fails."""
    out = {}
    for key in sorted(mine.sessions.keys() | theirs.sessions.keys()):
        m, t = mine.sessions.get(key, []), theirs.sessions.get(key, [])
        inherited = key in theirs.warm_starts and mine.warm_starts.get(key) != theirs.warm_starts[key]
        out[key] = None
        for j in range(max(len(m), len(t))):
            p, r = (m[j] if j < len(m) else None), (t[j] if j < len(t) else None)
            if p is None or r is None or p["round"] != r["round"] or not (
                    np.array_equal(p["Xc"], r["Xc"]) and np.array_equal(p["front"], r["front"])
                    and np.array_equal(p["eps"], r["eps"])):
                assert inherited, f"session {key}: selection {j} differs in its inputs without a cause"
                print(f"session {key} differs from its selection {j}: it imported from sources "
                      f"whose histories had parted")
                out[key] = (p or r)["round"]
                break
            if p["picks"] == r["picks"]:
                continue
            a, b = p["picks"][0], r["picks"][0]
            margins = (_ehvi(p, a) - _ehvi(p, b), _ehvi(r, b) - _ehvi(r, a))
            print(f"session {key} parts at round {p['round']} (its selection {j}): the port picks "
                  f"{a}, the reference {b}; EHVI margins of each package's own pick "
                  f"{margins[0]:.6g} (port) and {margins[1]:.6g} (reference); max |posterior mean "
                  f"difference| {np.abs(p['mean'] - r['mean']).max():.3g}; max |log-hyperparameter "
                  f"difference| {np.abs(p['params'] - r['params']).max():.3g} (its first fit "
                  f"{np.abs(m[0]['params'] - t[0]['params']).max():.3g})")
            assert margins[0] >= 0 and margins[1] >= 0, (key, margins)
            out[key] = p["round"]
            break
    return out


def _trajectory(rounds):
    # budget_spent_s is fleet-wide, so one tenant's parting moves every tenant's
    return [(r["n_evals"], r["cost_s"], r["hv"], r["hv_gain"]) for r in rounds]


def hold_bench_to_reference(mine, theirs, mlog, tlog):
    """``bench_fleet.run`` of the port against the JAX package's, each
    session held up to its parting (see :func:`partings`): every round of
    every arm before it; the transfer reports exactly where the sources'
    histories were equal at the warm start, else their structure; each
    crossing and verdict whose arms did not part; the fleet's ledger where
    no session of the fleet parted; the fallback and resume gates of both
    packages. Returns the partings."""
    from repro_torch.bench.bench_fleet import ARRIVALS

    theirs = json.loads(json.dumps(theirs))
    parted = partings(mlog, tlog)
    # a session that parts through GP drift alone held at least its first
    # selection, so a host where every fit parts at once cannot pass
    # holding nothing
    for key, sel in sorted(mlog.sessions.items()):
        at = parted.get(key)
        held = sum(1 for x in sel if at is None or x["round"] < at)
        inherited = key in tlog.warm_starts and mlog.warm_starts.get(key) != tlog.warm_starts[key]
        print(f"session {key}: {held} of {len(sel)} selections held")
        assert held >= 1 or inherited, f"session {key} parts at its first selection"
    assert mine["sizes"] == theirs["sizes"]
    assert mine["resume_bit_identical"] and theirs["resume_bit_identical"]
    # fleets in build order: one cold arm per arrival, the fleet, its resumed
    # copy, the fallback fleet
    main = len(ARRIVALS)
    for i, (fam, seed) in enumerate(ARRIVALS):
        m, t = mine["families"][fam], theirs["families"][fam]
        name = m["tenant"]
        assert name == t["tenant"] == f"{fam}-{seed}"
        cold_at, warm_at = parted.get((i, name)), parted.get((main, name))
        for arm, at in (("cold_rounds", cold_at), ("warm_rounds", warm_at)):
            assert _trajectory(m[arm])[:at] == _trajectory(t[arm])[:at], (fam, arm)
        srcs = mlog.warm_starts[(main, name)], tlog.warm_starts[(main, name)]
        if srcs[0] == srcs[1]:
            assert m["transfer"] == t["transfer"], fam
        else:
            def shape(rep):
                return (rep["target"], rep["fallback"], rep["n_imported"],
                        [(x["name"], x["n_imported"]) for x in rep["sources"]])
            assert shape(m["transfer"]) == shape(t["transfer"]), fam
        assert m["fallback_transfer"] == t["fallback_transfer"]
        assert m["fallback_matches_cold"] and t["fallback_matches_cold"]
        if cold_at is None:
            for k in ("target_hv", "cold_final_hv", "cold_seconds_to_target"):
                assert m[k] == t[k], (fam, k)
        if warm_at is None and srcs[0] == srcs[1]:
            assert m["warm_final_hv"] == t["warm_final_hv"], fam
            if cold_at is None:
                assert m["warm_seconds_to_target"] == t["warm_seconds_to_target"], fam
                assert m["warm_wins"] == t["warm_wins"], fam
        print(f"{fam}: warm wins in the port {m['warm_wins']}, in the reference {t['warm_wins']}; "
              f"cold arm parts at {cold_at}, warm arm at {warm_at}")
    if not any(at is not None for (fleet, _), at in parted.items() if fleet == main):
        got, want = _bench_projection(mine), _bench_projection(theirs)
        assert {k: got[k] for k in ("budget", "scheduler", "tenants", "session_rounds")} == \
            {k: want[k] for k in ("budget", "scheduler", "tenants", "session_rounds")}
    return parted


def _bench_projection(out):
    led = out["ledger"]
    return {
        "families": {f: {k: r[k] for k in ("tenant", "target_hv", "cold_final_hv",
                                          "warm_final_hv", "cold_seconds_to_target",
                                          "warm_seconds_to_target", "warm_wins", "transfer",
                                          "fallback_transfer", "fallback_matches_cold",
                                          "cold_rounds", "warm_rounds")}
                     for f, r in out["families"].items()},
        "resume": out["resume_bit_identical"],
        "budget": led["budget"],
        "scheduler": led["scheduler"],
        "tenants": {n: {k: t[k] for k in ("descriptor", "n_iters", "charged_s", "hv", "rounds",
                                          "events", "transfer")}
                    for n, t in led["tenants"].items()},
        "session_rounds": {n: [[[e["iteration"], e["failed"]] for e in r["evals"]]
                               for r in t["session"]["rounds"]]
                           for n, t in led["tenants"].items()},
    }


@pytest.fixture
def builtin_families_only():
    """Both registries hold the seven built-in families for the test: the
    tenants' ``make_space()`` spans the registered families, and a module
    run earlier in the same process may have left IVF_PQR registered."""
    import repro.vdms as jv
    import repro_torch.vdms as tv
    from repro.vdms import ivf_pqr as j_pqr
    from repro_torch.vdms import ivf_pqr as t_pqr

    removed = []
    for pkg, reg in ((jv, j_pqr), (tv, t_pqr)):
        if reg.FAMILY.name in pkg.registered_names():
            pkg.unregister_family(reg.FAMILY.name)
            removed.append(reg)
    yield
    for reg in removed:
        reg.register()


def test_quick_bench_fleet_ledger_matches_reference(builtin_families_only, monkeypatch):
    """``bench_fleet.run(quick=True)`` of the port, with the reference's
    build draws injected, against the JAX package's, held as
    :func:`hold_bench_to_reference` holds it: every round of every session
    before its parting (the crossings, the transfer reports, evaluations,
    charges and hypervolumes), the scheduler and the budget where no session
    of the fleet parted, and the three gates. On a CPU host with jax 0.9.0
    and torch 2.13 glove_like's cold arm parts at its third BO round
    through GP drift alone (the same with one or eight torch threads);
    everything else is equal. Run it with ``-s`` to print the partings."""
    import repro.core.tuner as ref_tuner
    import repro.fleet.fleet as ref_fleet
    import repro_torch.core.tuner as tuner
    import repro_torch.fleet.fleet as fleet
    from benchmarks import bench_fleet as ref_bench
    from repro_torch.bench import bench_fleet
    from torch_parity import ReferenceDraws

    mlog = SelectionLog(monkeypatch, fleet, tuner)
    tlog = SelectionLog(monkeypatch, ref_fleet, ref_tuner)
    mine = bench_fleet.run(quick=True, device=CPU, draws=ReferenceDraws)
    theirs = ref_bench.run(quick=True)
    hold_bench_to_reference(mine, theirs, mlog, tlog)
    for r in mine["families"].values():
        assert r["warm_wins"] and r["fallback_matches_cold"]


def test_full_bench_fleet_matches_reference_until_gp_drift(builtin_families_only, monkeypatch):
    """``bench_fleet`` at its full budgets (four tenants, traces of 1,024 base
    and 384 operations, 16 observations a tenant, analytic), the port with
    the JAX package's build draws injected against the JAX package's own
    run, held as :func:`hold_bench_to_reference` holds it.

    Which sessions part through GP drift depends on the host's floating
    point: on a CPU host with jax 0.9.0 and torch 2.13 keyword_like's cold arm and
    the established keyword_like-1 part, so the keyword_like arrival imports
    from a source whose history differs, its warm arm differs from its first
    round, and both packages' transfer reports differ in their similarities
    (glove_like's in the last bits, through the embedding's fit on every
    source). Run it with ``-s`` to print the partings, the EHVI margins and
    the GP drift. (It lives in this module, the largest of the fleet's, so
    that the parallel runner, which hands out the largest modules first,
    starts its five minutes early.)"""
    import repro.core.tuner as ref_tuner
    import repro.fleet.fleet as ref_fleet
    import repro_torch.core.tuner as tuner
    import repro_torch.fleet.fleet as fleet
    from benchmarks import bench_fleet as ref_bench
    from repro_torch.bench import bench_fleet
    from torch_parity import ReferenceDraws

    mlog = SelectionLog(monkeypatch, fleet, tuner)
    tlog = SelectionLog(monkeypatch, ref_fleet, ref_tuner)
    mine = bench_fleet.run(quick=False, device=CPU, draws=ReferenceDraws)
    theirs = ref_bench.run(quick=False)
    assert mine["sizes"] == dict(n_base=1024, n_ops=384, n_iters=16)
    hold_bench_to_reference(mine, theirs, mlog, tlog)
    # the JAX package's own verdict at these budgets: keyword_like's warm
    # arrival does not win
    assert not theirs["families"]["keyword_like"]["warm_wins"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card path")
def test_bench_fleet_needs_a_device_without_gpu():
    from repro_torch.bench import bench_fleet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_fleet.run(quick=True)
