"""Fused against composed search on the port's live engine (the twin of
``tests/test_fused_pipelines.py``'s live cases and engine internals): with
tombstones, a fully dead segment and compaction padding, the live search
through a family's fused hook (``mask_dead=False``, the alive-gated merge)
returns exactly the composed search's ids, and the same id sets as the JAX
package's live search when the port builds with the reference's draws. The
degraded search of a quarantined segment is this path with the
quarantined rows cleared from the alive mask."""
import numpy as np
import pytest

import repro.vdms as jv
from repro.vdms import ivf_pqr as j_pqr
from repro_torch import vdms as V
from repro_torch.vdms import ivf_pqr
from torch_parity import ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

CPU = "cpu"


BASE = {
    "segment_max_size": 512, "seal_proportion": 0.75, "graceful_time": 0.2,
    "search_batch_size": 16, "topk_merge_width": 32, "kmeans_iters": 4,
    "storage_bf16": False,
}
FUSED_CONFIGS = {
    "IVF_SQ8": {"nlist": 8, "nprobe": 4},
    "IVF_PQ": {"nlist": 8, "nprobe": 4, "m": 8, "nbits": 4},
    "IVF_PQR": {"nlist": 8, "nprobe": 4, "m": 8, "nbits": 4, "reorder_k": 32},
}


@pytest.fixture
def fused_mode():
    prev, jprev = V.get_search_pipeline(), jv.get_search_pipeline()
    yield
    V.set_search_pipeline(prev)
    jv.set_search_pipeline(jprev)


@pytest.fixture(autouse=True)
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


def _data(seed=5):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((1200, 48)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.standard_normal((12, 48)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return data, queries


def _live_pair(fam, deletes, compact_threshold=1.1, seed=5, draws=None):
    data, queries = _data(seed)
    cfg = dict(BASE, index_type=fam, **FUSED_CONFIGS[fam])
    outs = {}
    for mode in ("composed", "fused"):
        V.set_search_pipeline(mode)
        live = V.LiveVDMS(cfg, dim=48, capacity=2048, seed=0,
                          compact_threshold=compact_threshold, device=CPU, draws=draws)
        live.bootstrap(data)
        for g in deletes:
            live.delete(int(g))
        ids, _ = live.search(queries, 10, mode="analytic")
        outs[mode] = ids
    return outs["composed"], outs["fused"]


def _reference_live(fam, deletes, compact_threshold=1.1, seed=5):
    data, queries = _data(seed)
    cfg = dict(BASE, index_type=fam, **FUSED_CONFIGS[fam])
    jv.set_search_pipeline("fused")
    live = jv.LiveVDMS(cfg, dim=48, capacity=2048, seed=0, compact_threshold=compact_threshold)
    live.bootstrap(data)
    for g in deletes:
        live.delete(int(g))
    return live.search(queries, 10, mode="analytic")[0]


def _sets_match(a, b):
    return all(set(x[x >= 0]) == set(y[y >= 0]) for x, y in zip(a, b))


@pytest.mark.parametrize("fam", sorted(FUSED_CONFIGS))
def test_live_tombstones_fused_equals_composed(fam, fused_mode):
    deletes = range(50, 500, 3)
    a, b = _live_pair(fam, deletes=deletes)
    assert np.array_equal(a, b)
    assert not set(deletes) & set(b[b >= 0].tolist())
    # with the reference's draws, the JAX package's live search agrees
    _, got = _live_pair(fam, deletes=deletes, draws=ReferenceDraws)
    assert _sets_match(got, _reference_live(fam, deletes))


def test_live_fully_dead_segment(fused_mode):
    """Every vector of sealed segment 0 tombstoned (compaction disabled):
    the fused live merge drops the whole segment exactly like composed."""
    seg = V.live_seg_size(BASE["segment_max_size"], BASE["seal_proportion"])
    a, b = _live_pair("IVF_SQ8", deletes=range(0, seg))
    assert np.array_equal(a, b)
    assert not set(range(seg)) & set(a[a >= 0].tolist())


def test_live_compaction_padding(fused_mode):
    """Deletes past the compaction threshold rebuild a segment with -1
    padding; the live fused search never clamps, so the padded slots keep
    taking up width and the two modes agree."""
    seg = V.live_seg_size(BASE["segment_max_size"], BASE["seal_proportion"])
    a, b = _live_pair("IVF_SQ8", deletes=range(0, seg // 2), compact_threshold=0.3)
    assert np.array_equal(a, b)
    _, got = _live_pair("IVF_SQ8", deletes=range(0, seg // 2), compact_threshold=0.3,
                        draws=ReferenceDraws)
    assert _sets_match(got, _reference_live("IVF_SQ8", range(0, seg // 2),
                                            compact_threshold=0.3))


def test_clamp_ok_matches_plan():
    ds_full = V.make_dataset("glove_like", n=1280, dim=32, n_queries=4, k=5, seed=6, device=CPU)
    ds_part = V.make_dataset("glove_like", n=1450, dim=32, n_queries=4, k=5, seed=6, device=CPU)
    cfg = dict(BASE, index_type="IVF_SQ8", nlist=8, nprobe=4)
    full = V.VDMSInstance(ds_full, cfg, seed=0, device=CPU)
    part = V.VDMSInstance(ds_part, cfg, seed=0, device=CPU)
    assert full._clamp_ok
    assert not part._clamp_ok
    assert bool(np.all(part.plan.sealed_valid == part.plan.seg_size)) is False
    # the same verdicts as the reference's plans
    assert full._clamp_ok == jv.VDMSInstance(jv.make_dataset(
        "glove_like", n=1280, dim=32, n_queries=4, k=5, seed=6), cfg, seed=0)._clamp_ok


def test_measure_wall_both_modes(fused_mode):
    """measure(mode='wall') runs under either pipeline and reports identical
    recall (same result sets)."""
    ds = V.make_dataset("glove_like", n=1280, dim=32, n_queries=16, k=5, seed=7, device=CPU)
    cfg = dict(BASE, index_type="IVF_SQ8", nlist=8, nprobe=4)
    inst = V.VDMSInstance(ds, cfg, seed=0, device=CPU)
    V.set_search_pipeline("composed")
    r_c = inst.measure(topk=5, repeats=1, mode="wall")
    V.set_search_pipeline("fused")
    r_f = inst.measure(topk=5, repeats=1, mode="wall")
    assert r_c["recall"] == pytest.approx(r_f["recall"])


@pytest.mark.parametrize("fam", ["IVF_SQ8", "IVF_PQ"])
def test_degraded_fused_equals_composed(fam, fused_mode):
    """A quarantined segment served through the fused hook and through the
    composed path: the same ids, none from the quarantined segment."""
    data, queries = _data()
    cfg = dict(BASE, index_type=fam, **FUSED_CONFIGS[fam])
    plan = V.FaultPlan(events=(V.FaultEvent(kind="segment_loss", at_tick=1, segment=0),),
                       backoff_base_ticks=1000)
    outs = {}
    for mode in ("composed", "fused"):
        V.set_search_pipeline(mode)
        live = V.LiveVDMS(cfg, dim=48, capacity=2048, seed=0, device=CPU)
        live.bootstrap(data)
        live.arm_faults(V.FaultInjector(plan))
        for g in range(600, 700, 2):
            live.delete(g)
        outs[mode] = live.search(queries, 10, mode="analytic")[0]
        assert live.quarantined and live.last_coverage < 1.0
    assert np.array_equal(outs["composed"], outs["fused"])
    lost = set(live.seg_gids[0][live.seg_gids[0] >= 0].tolist())
    assert not lost & set(outs["fused"][outs["fused"] >= 0].tolist())
