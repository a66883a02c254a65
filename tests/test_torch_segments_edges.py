"""The port's segment planning edges and live-lifecycle properties (the twin
of ``tests/test_segments_edges.py``), with the plans held against the JAX
package's."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="optional test dep; pip install -e .[test]")
from hypothesis import given, settings, strategies as st

import repro.vdms as jv
from repro_torch.vdms import live_seg_size, make_trace, plan_segments, replay_trace
from repro_torch.vdms.workload import OP_DELETE
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


def _same_plan(*args):
    got, want = plan_segments(*args), jv.plan_segments(*args)
    for f in ("n", "seg_size", "n_sealed", "growing_start", "growing_searched"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.sealed_valid, want.sealed_valid)
    return got


def test_seal_proportion_exactly_at_boundary():
    # rem == seal_proportion * seg_size: the trailing remainder seals (>=)
    plan = _same_plan(1500, 1000, 0.5, 0.0)
    assert plan.n_sealed == 2 and plan.sealed_valid.tolist() == [1000, 500]
    assert plan.growing_size == 0
    plan = _same_plan(1500, 1000, 0.5001, 0.0)  # above the remainder: it stays growing
    assert plan.n_sealed == 1 and plan.growing_size == 500


def test_graceful_time_extremes():
    assert _same_plan(1500, 1000, 0.9, 0.0).growing_searched == 500  # the whole tail
    assert _same_plan(1500, 1000, 0.9, 0.9).growing_searched == int(np.ceil(0.1 * 500))
    # out-of-range graceful values clamp
    assert _same_plan(1500, 1000, 0.9, 2.0).growing_searched == 0
    assert _same_plan(1500, 1000, 0.9, -1.0).growing_searched == 500


def test_n_smaller_than_segment_max_size():
    plan = _same_plan(500, 4096, 0.75, 0.2)  # the segment size clamps to n
    assert plan.seg_size == 500 and plan.n_sealed == 1 and plan.growing_size == 0


@settings(max_examples=80, deadline=None)
@given(st.integers(1, 400), st.integers(64, 8192), st.floats(0.1, 1.0), st.floats(0.0, 0.9))
def test_single_sealed_segment_invariant(n, smax, seal, graceful):
    plan = _same_plan(n, smax, seal, graceful)
    assert plan.n_sealed >= 1
    assert plan.sealed_valid.sum() + plan.growing_size == n
    assert 0 <= plan.growing_searched <= plan.growing_size
    assert live_seg_size(smax, seal) == jv.live_seg_size(smax, seal)


def test_live_seg_size_bounds_and_monotonicity():
    assert live_seg_size(1024, 0.5) == 512
    assert live_seg_size(1, 0.1) == 64  # clamps to the static minimum
    assert live_seg_size(8192, 1.0) == 8192
    sizes = [live_seg_size(4096, p) for p in (0.1, 0.3, 0.5, 0.8, 1.0)]
    assert sizes == sorted(sizes) and all(64 <= s <= 4096 for s in sizes)


FLAT_CFG = dict(
    index_type="FLAT",
    seal_proportion=0.5,
    graceful_time=0.0,
    search_batch_size=8,
    topk_merge_width=32,
    kmeans_iters=4,
    storage_bf16=False,
)


@settings(max_examples=6, deadline=None)
@given(st.integers(80, 250), st.integers(64, 512), st.sampled_from(["none", "ramp", "step"]),
       st.integers(0, 3))
def test_replay_visible_set_matches_replan_from_scratch(n_base, smax, drift, seed):
    trace = make_trace("glove_like", n_base=n_base, n_ops=60, seed=seed, drift=drift,
                       mix=(0.35, 0.45, 0.20), dim=16)
    cfg = dict(FLAT_CFG, segment_max_size=smax)
    _, live = replay_trace(trace, cfg, mode="analytic", with_live=True, device="cpu")
    # the sealed-segment count never decreases over the lifecycle
    assert all(b >= a for a, b in zip(live.seal_history, live.seal_history[1:]))
    deleted = {int(trace.payload[i]) for i in range(trace.n_ops) if trace.kinds[i] == OP_DELETE}
    expected = set(range(trace.capacity)) - deleted
    assert set(live.visible_ids().tolist()) == expected
    # re-planning from scratch over the surviving corpus partitions the same set
    plan = _same_plan(len(expected), smax, cfg["seal_proportion"], cfg["graceful_time"])
    assert plan.sealed_valid.sum() + plan.growing_size == len(expected)
