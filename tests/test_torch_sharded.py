"""Sharded segment serving of the port (the twin of ``tests/test_sharded.py``,
its five doc-sync tests replaced by checks of ``shard_invariants_table()``
and ``shard_pipeline_table()`` against the JAX package's), plus:

* the batched per-shard ``partial_topk`` against a loop of per-shard calls,
  bit for bit;
* stacks that are mostly padding (more shards than sealed segments) for
  every family with a kernel, composed and fused;
* the port's ``ShardedVDMS`` against the JAX package's at 1, 2 and 4 shards
  (IVF_SQ8, IVF_PQ, IVF_PQR, FLAT; composed and fused; static, and
  ``from_live`` with a quarantined segment) on the same inputs, the
  reference's bundles carried across or its build draws injected.

The merge regression cases hold the port's ``merge_topk`` against the JAX
package's on the same adversarial inputs; the rest are the reference's cases
run on the port (on the CPU).
"""
import numpy as np
import pytest
import torch

import repro.vdms as jv
import repro_torch.vdms as V
from repro.vdms import ivf_pqr as j_pqr
from repro.vdms.merge import merge_topk as j_merge_topk
from repro.vdms.sharded import ShardedVDMS as JShardedVDMS
from repro_torch.vdms import ivf_pqr
from repro_torch.vdms.merge import merge_topk, partial_topk, shard_partial_topk
from repro_torch.vdms.sharded import SHARD_INVARIANTS, ShardedVDMS, shard_invariants_table
from repro_torch.vdms.workload import make_query_streams, poisson_arrivals, replay_query_streams
from torch_parity import (ReferenceDraws, assert_ids_match, assert_topk_match, carry,
                          default_config, port_dataset, reference_dataset, reference_instance)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

CPU = "cpu"

BASE = {
    "segment_max_size": 512, "seal_proportion": 1.0, "graceful_time": 0.2,
    "search_batch_size": 16, "topk_merge_width": 32, "kmeans_iters": 3,
    "storage_bf16": False,
}


@pytest.fixture
def pipeline_guard():
    prev, jprev = V.get_search_pipeline(), jv.get_search_pipeline()
    yield
    V.set_search_pipeline(prev)
    jv.set_search_pipeline(jprev)


@pytest.fixture
def with_pqr():
    """IVF_PQR registered in both packages for the test only."""
    added = [reg for reg, names in ((j_pqr, jv.registered_names()),
                                    (ivf_pqr, V.registered_names()))
             if reg.FAMILY.name not in names]
    for reg in added:
        reg.register()
    yield
    if ivf_pqr in added:
        V.unregister_family(ivf_pqr.FAMILY.name)
    if j_pqr in added:
        jv.unregister_family(j_pqr.FAMILY.name)


def _dataset(n=4096, dim=32, nq=16, seed=0):
    return V.make_dataset("glove_like", n=n, n_queries=nq, dim=dim, k=10, seed=seed, device=CPU)


def _instance(ds, seed=0, **over):
    cfg = dict(BASE, index_type="IVF_SQ8", nlist=16, nprobe=8, **over)
    return V.VDMSInstance(ds, cfg, seed=seed, device=CPU)


# ---------------------------------------------------------------------------
# 1. merge_topk equals the JAX package's, bit for bit
# ---------------------------------------------------------------------------
def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _random_merge_case(rng, n_seg, b, ks, dim, n_grow, n_gids, tie_prob=0.3):
    """Adversarial candidates: -1 pads, dead segments, duplicated (tied)
    scores, a tail with -1 (pad) gid rows."""
    ids = rng.integers(0, n_gids, size=(n_seg, b, ks)).astype(np.int32)
    dead = rng.random((n_seg, b, ks)) < 0.25
    ids = np.where(dead, -1, ids)
    sims = rng.standard_normal((n_seg, b, ks)).astype(np.float32)
    # force score ties so the lowest-flat-index tie-break is exercised
    ties = rng.random((n_seg, b, ks)) < tie_prob
    sims = np.where(ties, np.float32(0.5), sims)
    sims = np.where(dead, -np.inf, sims)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    growing = rng.standard_normal((n_grow, dim)).astype(np.float32)
    ggids = rng.integers(0, n_gids, size=n_grow).astype(np.int32)
    ggids[rng.random(n_grow) < 0.3] = -1
    return ids, sims, q, growing, ggids


@pytest.mark.parametrize("n_grow", [0, 7, 32])
@pytest.mark.parametrize("topk", [4, 10, 64])
def test_merge_topk_matches_reference_static_merge(n_grow, topk):
    rng = np.random.default_rng(hash(("static", n_grow, topk)) % 2**32)
    for _ in range(5):
        ids, sims, q, growing, ggids = _random_merge_case(
            rng, n_seg=4, b=3, ks=6, dim=8, n_grow=n_grow, n_gids=64
        )
        got = merge_topk(*_t(ids, sims, q, growing, ggids), topk)
        want = j_merge_topk(ids, sims, q, growing, ggids, topk)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_grow", [0, 7, 32])
@pytest.mark.parametrize("topk", [4, 10, 64])
def test_merge_topk_matches_reference_live_merge(n_grow, topk):
    rng = np.random.default_rng(hash(("live", n_grow, topk)) % 2**32)
    for _ in range(5):
        ids, sims, q, growing, ggids = _random_merge_case(
            rng, n_seg=4, b=3, ks=6, dim=8, n_grow=n_grow, n_gids=64
        )
        alive = rng.random(65) < 0.8
        alive[-1] = False  # the always-dead sentinel slot
        got = merge_topk(*_t(ids, sims, q, growing, ggids), topk, alive=torch.from_numpy(alive))
        want = j_merge_topk(ids, sims, q, growing, ggids, topk, alive=alive)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_merge_topk_all_dead_returns_minus_one():
    ids = np.zeros((2, 3, 4), np.int32)
    sims = np.full((2, 3, 4), -np.inf, np.float32)
    q = np.zeros((3, 8), np.float32)
    growing = np.empty((0, 8), np.float32)
    ggids = np.empty((0,), np.int32)
    alive = torch.zeros(11, dtype=torch.bool)
    out = merge_topk(*_t(ids, sims, q, growing, ggids), 5, alive=alive).numpy()
    assert (out == -1).all()


# ---------------------------------------------------------------------------
# 2. single shard is byte-identical to the unsharded engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["composed", "fused"])
def test_one_shard_bitwise_equals_instance(mode, pipeline_guard):
    ds = _dataset()
    inst = _instance(ds)
    V.set_search_pipeline(mode)
    want = inst.search(ds.queries, 10)
    sharded = ShardedVDMS.from_instance(inst, n_shards=1)
    assert sharded.dispatch == "direct"
    got, elapsed = sharded.search(ds.queries, 10, mode="analytic")
    assert np.array_equal(got, want)
    assert elapsed > 0


@pytest.mark.parametrize("mode", ["composed", "fused"])
def test_one_shard_bitwise_equals_live(mode, pipeline_guard):
    ds = _dataset()
    cfg = dict(BASE, index_type="IVF_SQ8", nlist=16, nprobe=8)
    live = V.LiveVDMS(cfg, dim=ds.dim, capacity=ds.n, seed=0, device=CPU)
    live.insert(ds.data[:3000])
    rng = np.random.default_rng(0)
    for g in rng.choice(2500, 200, replace=False):
        live.delete(int(g))
    V.set_search_pipeline(mode)
    want, _ = live.search(ds.queries, 10)
    sharded = ShardedVDMS.from_live(live, n_shards=1)
    got, _ = sharded.search(ds.queries, 10, mode="analytic")
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# 3. property sweep: shard count never changes the (gid, score) sets
# ---------------------------------------------------------------------------
def _gid_score_sets(ids, scores):
    return [
        frozenset(
            (int(g), int(b)) for g, b in zip(ri, rb.view(np.int32)) if g >= 0
        )
        for ri, rb in zip(ids, scores)
    ]


@pytest.mark.parametrize("case", range(6))
def test_property_shard_count_invariant_result_sets(case, pipeline_guard):
    """Seeded randomized property (hypothesis is unavailable here): random
    corpus size / segment size / topk / pipeline, shard counts 1..4 via the
    vmap dispatch — the per-query (gid, score) sets must be identical, and
    the id arrays are bitwise identical too."""
    rng = np.random.default_rng(1000 + case)
    n = int(rng.integers(1536, 4096))
    seg = int(rng.choice([256, 512, 1024]))
    topk = int(rng.choice([5, 10, 17]))
    V.set_search_pipeline(str(rng.choice(["composed", "fused"])))
    ds = _dataset(n=n, nq=8, seed=case)
    inst = _instance(ds, segment_max_size=seg)
    ref = None
    for n_shards in (1, 2, 3, 4):
        sharded = ShardedVDMS.from_instance(
            inst, n_shards=n_shards, dispatch="vmap" if n_shards > 1 else "direct"
        )
        ids, scores, _ = sharded.search(
            ds.queries, topk, mode="analytic", return_scores=True
        )
        if ref is None:
            ref = (ids, _gid_score_sets(ids, scores))
        else:
            assert _gid_score_sets(ids, scores) == ref[1], (
                f"(gid, score) sets changed at n_shards={n_shards}"
            )
            assert np.array_equal(ids, ref[0])


# ---------------------------------------------------------------------------
# 4. degenerate shard shapes
# ---------------------------------------------------------------------------
def test_more_shards_than_segments(pipeline_guard):
    V.set_search_pipeline("fused")
    ds = _dataset(n=2048)
    inst = _instance(ds, segment_max_size=1024)  # 2 sealed segments
    want = inst.search(ds.queries, 10)
    sharded = ShardedVDMS.from_instance(inst, n_shards=4, dispatch="vmap")
    assert inst.plan.n_sealed == 2 and sharded.n_pad == 2
    got, _ = sharded.search(ds.queries, 10, mode="analytic")
    assert np.array_equal(got, want)
    segs = sharded.shard_segments()
    assert segs.tolist() == [1, 1, 0, 0]
    cov = sharded.shard_coverage()
    assert cov[2] == 0.0 and cov[3] == 0.0  # padding-only shards report honestly


def test_one_shard_fully_tombstoned(pipeline_guard):
    """Delete every vector of the segments landing on shard 0; results must
    equal the live engine's (which sees the same tombstones) and shard 0's
    coverage must read 0."""
    V.set_search_pipeline("composed")
    cfg = dict(BASE, index_type="IVF_SQ8", nlist=16, nprobe=8)
    ds = _dataset()
    live = V.LiveVDMS(cfg, dim=ds.dim, capacity=ds.n, seed=0, device=CPU)
    live.insert(ds.data[:3100])  # seals segments, leaves a tail
    n_shards = 2
    per = -(-live.n_sealed // n_shards)
    for z in range(min(per, live.n_sealed)):  # shard 0's segments
        for g in live.seg_gids[z]:
            if g >= 0 and live.alive[g]:
                live.delete(int(g))
    want, _ = live.search(ds.queries, 10)
    sharded = ShardedVDMS.from_live(live, n_shards=n_shards, dispatch="vmap")
    got, _ = sharded.search(ds.queries, 10, mode="analytic")
    assert np.array_equal(got, want)
    assert sharded.shard_coverage()[0] == 0.0
    assert sharded.stats()["min_shard_coverage"] == 0.0


def test_nothing_sealed_raises():
    cfg = dict(BASE, index_type="IVF_SQ8", nlist=16, nprobe=8)
    live = V.LiveVDMS(cfg, dim=16, capacity=1024, seed=0, device=CPU)
    live.insert(np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="nothing sealed"):
        ShardedVDMS.from_live(live, n_shards=2)


def test_analytic_model_reduces_to_engine_at_one_shard():
    ds = _dataset()
    inst = _instance(ds)
    sharded = ShardedVDMS.from_instance(inst, n_shards=1)
    assert sharded._analytic_seconds_per_chunk() == pytest.approx(
        inst._analytic_seconds_per_chunk()
    )
    s4 = ShardedVDMS.from_instance(inst, n_shards=4, dispatch="vmap")
    assert s4._analytic_seconds_per_chunk() < sharded._analytic_seconds_per_chunk()


def test_search_streams_splits_per_stream(pipeline_guard):
    V.set_search_pipeline("fused")
    ds = _dataset()
    inst = _instance(ds)
    sharded = ShardedVDMS.from_instance(inst, n_shards=2, dispatch="vmap")
    streams = [ds.queries[:5], ds.queries[5:8], ds.queries[8:16]]
    outs, elapsed = sharded.search_streams(streams, 10)
    assert [o.shape for o in outs] == [(5, 10), (3, 10), (8, 10)]
    whole, _ = sharded.search(ds.queries[:16], 10)
    assert np.array_equal(np.concatenate(outs), whole)


# ---------------------------------------------------------------------------
# Poisson multi-stream replay
# ---------------------------------------------------------------------------
def test_poisson_arrivals_properties():
    t = poisson_arrivals(100.0, 5000, seed=1)
    assert t.shape == (5000,) and (np.diff(t) > 0).all()
    assert np.mean(np.diff(t)) == pytest.approx(0.01, rel=0.1)
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(0.0, 10)


def test_make_query_streams_superposition():
    q = np.zeros((32, 8), np.float32)
    streams = make_query_streams(q, 4, rate=80.0, n_per_stream=50, seed=0)
    assert len(streams) == 4
    rows = np.concatenate([r for _, r in streams])
    assert set(rows.tolist()) == set(range(32))  # round-robin covers the pool
    merged = np.sort(np.concatenate([t for t, _ in streams]))
    # superposed rate ~ aggregate
    assert 1.0 / np.mean(np.diff(merged)) == pytest.approx(80.0, rel=0.25)


def test_replay_query_streams_accounting(pipeline_guard):
    V.set_search_pipeline("fused")
    ds = _dataset()
    inst = _instance(ds)
    sharded = ShardedVDMS.from_instance(inst, n_shards=2, dispatch="vmap")
    qps = ds.queries.shape[0] / sharded.search(ds.queries, 10, mode="analytic")[1]
    rep = replay_query_streams(
        sharded, ds.queries, rate=0.5 * qps, n_streams=4, n_per_stream=16, topk=10
    )
    assert rep["n_queries"] == 64
    assert rep["min_stream_queries"] == 16
    assert rep["served_qps"] > 0 and rep["utilization"] <= 1.0 + 1e-9
    assert rep["sojourn_p50_s"] <= rep["sojourn_p95_s"] <= rep["sojourn_p99_s"]
    # overload: a rate far beyond capacity must flag saturation
    hot = replay_query_streams(
        sharded, ds.queries, rate=50 * qps, n_streams=4, n_per_stream=64, topk=10
    )
    assert hot["saturated"] == 1.0


def test_sharded_search_hooks_fire(pipeline_guard):
    V.set_search_pipeline("fused")
    ds = _dataset()
    inst = _instance(ds)
    sharded = ShardedVDMS.from_instance(inst, n_shards=2, dispatch="vmap")
    seen = []
    sharded.search_hooks.append(lambda nq, lat, el: seen.append((nq, lat.size, el)))
    sharded.search(ds.queries, 10, mode="analytic")
    assert seen and seen[0][0] == ds.queries.shape[0] == seen[0][1]


def test_sharded_ledger_attach(pipeline_guard):
    from repro_torch.serving import attach_sharded, serving_ledger

    V.set_search_pipeline("fused")
    ds = _dataset()
    inst = _instance(ds)
    sharded = ShardedVDMS.from_instance(inst, n_shards=2, dispatch="vmap")
    led = serving_ledger()
    attach_sharded(led, sharded)
    sharded.search(ds.queries, 10, mode="analytic")
    assert led.get("vdms_shards").value == 2.0
    assert led.get("vdms_queries_total").value == ds.queries.shape[0]
    assert led.get("vdms_shard_min_coverage").value == 1.0




# ---------------------------------------------------------------------------
# the tables the JAX package's docs embed
# ---------------------------------------------------------------------------
def test_shard_invariants_table_matches_reference():
    from repro.vdms import sharded as j_sharded

    assert SHARD_INVARIANTS == j_sharded.SHARD_INVARIANTS
    assert shard_invariants_table() == j_sharded.shard_invariants_table()


def test_shard_pipeline_table_matches_reference(with_pqr):
    assert V.shard_pipeline_table() == jv.shard_pipeline_table()
    assert "IVF_PQR" in V.shard_pipeline_table()


# ---------------------------------------------------------------------------
# the batched leaves equal a loop of per-shard partial_topk calls
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards,per", [(1, 5), (2, 3), (3, 2), (4, 1), (4, 4)])
@pytest.mark.parametrize("live", [False, True])
def test_batched_partial_topk_equals_per_shard_loop(n_shards, per, live):
    rng = np.random.default_rng(n_shards * 10 + per + live)
    for k in (1, 5, 12, 1000):
        ids, sims, *_ = _random_merge_case(rng, n_seg=n_shards * per, b=3, ks=6, dim=8,
                                           n_grow=0, n_gids=64)
        sims[:, 1, :] = 0.0  # a row of ties only
        sims[-1, 0, :] = -0.0  # signed zeros rank below +0.0
        ids_t, sims_t = torch.from_numpy(ids), torch.from_numpy(sims)
        alive = None
        if live:
            a = rng.random(65) < 0.7
            a[-1] = False
            alive = torch.from_numpy(a)
        kk = min(k, per * 6)
        got_i, got_s = shard_partial_topk(ids_t, sims_t, n_shards, k, alive=alive)
        want = [partial_topk(ids_t[s * per:(s + 1) * per], sims_t[s * per:(s + 1) * per], k,
                             alive=alive) for s in range(n_shards)]
        assert got_i.shape == (3, n_shards * kk)
        assert torch.equal(got_i, torch.cat([w[0] for w in want], dim=1))
        assert torch.equal(got_s.view(torch.int32),
                           torch.cat([w[1] for w in want], dim=1).view(torch.int32))


# ---------------------------------------------------------------------------
# stacks that are mostly padding
# ---------------------------------------------------------------------------
PAD_CONFIGS = {
    "FLAT": {},
    "IVF_SQ8": {"nlist": 8, "nprobe": 4},
    "IVF_PQ": {"nlist": 8, "nprobe": 4, "m": 8, "nbits": 4},
    "IVF_PQR": {"nlist": 8, "nprobe": 4, "m": 8, "nbits": 4, "reorder_k": 32},
}


@pytest.mark.parametrize("family", sorted(PAD_CONFIGS))
def test_mostly_padding_stack(family, with_pqr, pipeline_guard):
    """One sealed segment on eight shards (seven padding segments: zero
    centroids and codes, every member and gid -1): every shard count returns
    the unsharded ids, composed and fused, and no padding id leaks."""
    ds = _dataset(n=1300, dim=32)
    cfg = dict(BASE, index_type=family, segment_max_size=1024, **PAD_CONFIGS[family])
    inst = V.VDMSInstance(ds, cfg, seed=0, device=CPU)
    assert inst.plan.n_sealed == 1
    for mode in ("composed", "fused"):
        V.set_search_pipeline(mode)
        want = inst.search(ds.queries, 10)
        for n in (1, 2, 8):
            sharded = ShardedVDMS.from_instance(inst, n_shards=n)
            assert sharded.n_pad == n - 1
            got, scores, _ = sharded.search(ds.queries, 10, return_scores=True)
            assert np.array_equal(got, want), (mode, n)
            assert np.isfinite(scores[got >= 0]).all()
        assert sharded.shard_segments().tolist() == [1] + [0] * 7
        assert sharded.shard_coverage().tolist() == [1.0] + [0.0] * 7


# ---------------------------------------------------------------------------
# the port against the JAX package's ShardedVDMS
# ---------------------------------------------------------------------------
PARITY_FAMILIES = ("FLAT", "IVF_SQ8", "IVF_PQ", "IVF_PQR")


def _check_parity(mine, theirs, data, queries):
    """Per query: the same ids as sets (near-ties at the k-th exact score
    aside) and the same scores within TOL."""
    ids, scores, _ = mine
    jids, jscores, _ = theirs
    assert_ids_match(ids, jids, data, queries)
    assert_topk_match(ids, np.where(ids >= 0, scores, -np.inf), jids,
                      np.where(jids >= 0, jscores, -np.inf))


@pytest.mark.parametrize("family", PARITY_FAMILIES)
def test_static_sharded_matches_reference(family, with_pqr, pipeline_guard):
    """The reference's instance (3,000 vectors: two full segments of 1,024
    and a partial one) carried across: at 1, 2 and 4 shards, composed and
    fused, the port returns the reference's ids and scores; its own ids
    equal its 1-shard ids, which equal its unsharded instance's."""
    j = reference_instance(family)
    ds = port_dataset()
    inst = V.VDMSInstance(ds, default_config(family), seed=0, device=CPU,
                          bundle=carry(j.bundle))
    q, k = ds.queries, ds.k
    for mode in ("composed", "fused"):
        V.set_search_pipeline(mode)
        jv.set_search_pipeline(mode)
        unsharded = inst.search(q, k)
        sets = set()
        for n in (1, 2, 4):
            mine = ShardedVDMS.from_instance(inst, n_shards=n).search(q, k, return_scores=True)
            theirs = JShardedVDMS.from_instance(j, n_shards=n).search(q, k, return_scores=True)
            _check_parity(mine, theirs, ds.data, q)
            assert np.array_equal(mine[0], unsharded), (mode, n)
            sets.add(tuple(_gid_score_sets(mine[0], mine[1])))
        assert len(sets) == 1  # the same (gid, score-bit) sets at every shard count


def _live_state(pkg, family, draws=None):
    """A live instance of the reference dataset's first 2,700 vectors at
    segments of 512 (five sealed, a tail of 140), 150 deletes, then
    segment 1 lost at the first search (no rebuild inside the test)."""
    ds = reference_dataset()
    cfg = dict(default_config(family), segment_max_size=512, seal_proportion=1.0)
    kw = dict(device=CPU, draws=draws) if pkg is V else {}
    live = pkg.LiveVDMS(cfg, dim=ds.dim, capacity=ds.n, seed=0, **kw)
    live.bootstrap(ds.data[:2700])
    live.arm_faults(pkg.FaultInjector(pkg.FaultPlan(
        events=(pkg.FaultEvent(kind="segment_loss", at_tick=1, segment=1),),
        backoff_base_ticks=100_000)))
    for g in np.random.default_rng(3).choice(2700, 150, replace=False):
        live.delete(int(g))
    ids, _ = live.search(ds.queries, ds.k)
    assert list(live.quarantined) == [1] and live.n_sealed == 5
    return live, ids


@pytest.mark.parametrize("family", PARITY_FAMILIES)
def test_live_sharded_matches_reference(family, with_pqr, pipeline_guard):
    """``from_live`` on a degraded live state (reference draws injected): at
    1, 2 and 4 shards, composed and fused, the port's snapshot returns what
    its ``live.search`` returned, and the reference's ids and scores; shard
    coverage drops below 1 on the lost segment's shard."""
    ds = reference_dataset()
    q, k = ds.queries, ds.k
    for mode in ("composed", "fused"):
        V.set_search_pipeline(mode)
        jv.set_search_pipeline(mode)
        live, want = _live_state(V, family, draws=ReferenceDraws)
        jlive, jwant = _live_state(jv, family)
        assert_ids_match(want, jwant, ds.data, q)
        sets = set()
        for n in (1, 2, 4):
            snap = ShardedVDMS.from_live(live, n_shards=n)
            mine = snap.search(q, k, return_scores=True)
            theirs = JShardedVDMS.from_live(jlive, n_shards=n).search(q, k, return_scores=True)
            assert np.array_equal(mine[0], want), (mode, n)
            _check_parity(mine, theirs, ds.data, q)
            st = snap.stats()
            assert st["min_shard_coverage"] < 1.0 and st["coverage"] == pytest.approx(
                JShardedVDMS.from_live(jlive, n_shards=n).stats()["coverage"])
            lost = set(live.seg_gids[1][live.seg_gids[1] >= 0].tolist())
            assert not lost & set(mine[0][mine[0] >= 0].tolist())
            sets.add(tuple(_gid_score_sets(mine[0], mine[1])))
        assert len(sets) == 1  # the same (gid, score-bit) sets at every shard count


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card path")
def test_sharded_entry_points_need_a_device_without_gpu():
    from repro_torch.bench import bench_sharded
    from repro_torch.launch import serve_sharded

    ds = _dataset(n=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedVDMS(ds, dict(BASE, index_type="FLAT"), n_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_sharded.run(quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_sharded.main([])


def test_dispatch_modes():
    """``shard_map`` needs a process group (one shard a rank) and raises
    without one; ``tests/test_torch_shard_dist.py`` runs it over one."""
    ds = _dataset(n=2048)
    inst = _instance(ds, segment_max_size=512)
    with pytest.raises(ValueError, match="shard_map.*process group, and none is initialised"):
        ShardedVDMS.from_instance(inst, n_shards=2, dispatch="shard_map")
    with pytest.raises(ValueError, match="direct"):
        ShardedVDMS.from_instance(inst, n_shards=2, dispatch="direct")
    with pytest.raises(ValueError, match="unknown dispatch"):
        ShardedVDMS.from_instance(inst, n_shards=2, dispatch="pmap")
    with pytest.raises(ValueError, match=">= 1"):
        ShardedVDMS.from_instance(inst, n_shards=0)
    from repro_torch.distributed import make_shard_mesh

    one = ShardedVDMS.from_instance(inst, mesh=make_shard_mesh(device=CPU))
    assert one.n_shards == 1 and one.dispatch == "direct" and one.mesh.size == 1
    built = ShardedVDMS(ds, dict(BASE, index_type="IVF_SQ8", nlist=16, nprobe=8,
                                 segment_max_size=512), n_shards=4, device=CPU)
    assert built.dispatch == "vmap" and built.measure()["n_shards"] == 4.0
    assert built.measure()["recall"] == inst.measure(mode="analytic")["recall"]


# ---------------------------------------------------------------------------
# the benchmark and the launch twin
# ---------------------------------------------------------------------------
SMALL = dict(n_base=16384, dim=64, n_queries=32, k=10)


def test_bench_sharded_matches_reference(monkeypatch):
    """``bench_sharded.run`` at a small corpus (four sealed segments of
    4,096), the reference's build draws injected, against the JAX package's
    run at the same size: analytic QPS and scaling, recall, placement stats
    and the Poisson replay equal; every invariant but the 1 M floor holds."""
    from benchmarks import bench_sharded as ref_bench
    from repro_torch.bench import bench_sharded

    monkeypatch.setattr(ref_bench, "_sizes", lambda quick: dict(SMALL))
    keep = {}
    mine = bench_sharded.run(device=CPU, sizes=dict(SMALL), keep=keep, draws=ReferenceDraws)
    theirs = ref_bench.run(quick=True)
    assert keep["instance"].plan.n_sealed == mine["n_sealed"] == theirs["n_sealed"] == 4
    assert bench_sharded.check_invariants(mine) == ["n_base=16384 below the 1M-vector floor"]
    for n, rec in mine["shards"].items():
        ref = theirs["shards"][n]
        assert rec["dispatch"] == ("direct" if n == "1" else "vmap")
        assert rec["equals_unsharded"] and rec["bitwise_identical"]
        for key in ("qps_analytic", "qps_scaling_vs_1", "recall", "mem_gib"):
            assert rec[key] == pytest.approx(ref[key], rel=1e-12), (n, key)
        assert rec["stats"]["per_shard"] == ref["stats"]["per_shard"]
        for key in ("offered_qps", "served_qps", "n_batches", "sojourn_p99_s", "utilization"):
            assert rec["poisson"][key] == pytest.approx(ref["poisson"][key], rel=1e-9), (n, key)


def test_serve_sharded_cli(capsys):
    from repro_torch.launch import serve_sharded

    assert serve_sharded.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "invariants hold" in out and out.rstrip().endswith("OK")
