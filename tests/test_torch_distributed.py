"""Sharding rules and segment placement of the port (the twin of the rule
tests of ``tests/test_distributed.py``), held against the JAX package's
``distributed/sharding.py`` on duck-typed meshes."""
import types

import numpy as np
import pytest
import torch

from repro.distributed import sharding as ref
from repro_torch.distributed import (
    ShardingRules,
    ShardMesh,
    constrain,
    current_rules,
    make_shard_mesh,
    param_axes_for,
    segment_placement,
    use_rules,
)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


def _mesh(**axes):
    """A mesh as both packages read it: ``axis_names`` and a ``shape``."""
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


# ---------------------------------------------------------------------------
# twins of the reference's rule tests
# ---------------------------------------------------------------------------
def test_rules_no_mesh_is_noop():
    rules = ShardingRules(None)
    assert rules.sharding(("batch", None)) is None


def test_param_axes_inference():
    assert param_axes_for(("layers", "attn", "wq"), (4, 128, 256)) == ("layers", "fsdp", "heads")
    assert param_axes_for(("embed",), (1024, 64)) == ("vocab", "fsdp")
    assert param_axes_for(("norm", "scale"), (64,)) == (None,)
    # unknown names fall back to replicated
    assert param_axes_for(("mystery",), (3, 4)) == (None, None)


@pytest.mark.parametrize("path,shape", [
    (("layers", "attn", "wq"), (4, 128, 256)), (("embed",), (1024, 64)),
    (("norm", "scale"), (64,)), (("mystery",), (3, 4)), (("moe", "we_up"), (2, 8, 16, 32)),
    (("ssm", "conv_w"), (4, 64)), (("head",), (64, 1000, 3)),
])
def test_param_axes_match_reference(path, shape):
    assert param_axes_for(path, shape) == ref.param_axes_for(path, shape)


# ---------------------------------------------------------------------------
# spec() against the reference on duck-typed meshes, odd dims included
# ---------------------------------------------------------------------------
MESHES = [
    dict(data=2, model=4), dict(pod=2, data=3, model=2), dict(shard=4), dict(shard=3),
    dict(data=8), dict(pod=4, data=2), dict(model=16),
]
AXES = [
    ("batch", "seq", "embed"), ("fsdp", "heads"), ("experts", "ff"), ("ff", "experts"),
    ("vocab", "fsdp"), ("kv_heads", "head_dim"), ("segments", None, None),
    ("seq_sp", "kv_seq"), ("layers", "fsdp", "ff"), ("seq_act", "embed"), (None, "mystery"),
]
SHAPES = [(8, 12, 16), (6, 7, 5), (24, 48, 96), (3, 5, 7), (12, 9, 4), (16, 16, 16)]


@pytest.mark.parametrize("mesh_axes", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("fsdp,seq_parallel", [(True, True), (False, False)])
def test_spec_matches_reference(mesh_axes, fsdp, seq_parallel):
    mesh = _mesh(**mesh_axes)
    mine = ShardingRules(mesh, fsdp=fsdp, seq_parallel=seq_parallel)
    theirs = ref.ShardingRules(mesh, fsdp=fsdp, seq_parallel=seq_parallel)
    assert mine.logical == theirs.logical
    for axes in AXES:
        assert mine.spec(axes) == tuple(theirs.spec(axes))
        for shape in SHAPES:
            shape = shape[: len(axes)]
            assert mine.spec(axes, shape) == tuple(theirs.spec(axes, shape)), (axes, shape)
    assert mine.fallbacks == theirs.fallbacks


def test_sharding_carries_the_spec():
    mesh = _mesh(shard=4)
    s = ShardingRules(mesh).sharding(("segments", None), (8, 3))
    assert s.mesh is mesh and s.spec == ("shard", None)
    # a segment count the mesh does not divide stays replicated, and says so
    rules = ShardingRules(mesh)
    assert rules.spec(("segments", None), (6, 3)) == (None, None)
    assert rules.fallbacks == ["segments:dim6"]


# ---------------------------------------------------------------------------
# placement, meshes, constraints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_seg", [0, 1, 2, 5, 7, 64, 1000])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_segment_placement_matches_reference(n_seg, n_shards):
    per, n_pad, shard_of = segment_placement(n_seg, n_shards)
    rper, rpad, rshard = ref.segment_placement(n_seg, n_shards)
    assert (per, n_pad) == (rper, rpad)
    assert np.array_equal(shard_of, rshard) and shard_of.dtype == rshard.dtype
    assert per * n_shards == n_seg + n_pad
    counts = np.bincount(shard_of, minlength=n_shards)
    assert counts.sum() == n_seg and counts.max(initial=0) <= per


def test_segment_placement_rejects_bad_input():
    with pytest.raises(ValueError):
        segment_placement(-1, 2)
    with pytest.raises(ValueError):
        segment_placement(4, 0)


def test_make_shard_mesh_cpu():
    mesh = make_shard_mesh(device="cpu")
    assert isinstance(mesh, ShardMesh)
    assert mesh.axis_names == ("shard",) and mesh.shape == {"shard": 1} and mesh.size == 1
    assert mesh.devices == (torch.device("cpu"),)
    assert ShardingRules(mesh).spec(("segments",), (4,)) == ("shard",)
    with pytest.raises(ValueError, match="exceeds"):
        make_shard_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_shard_mesh(0, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card path")
def test_make_shard_mesh_needs_a_card_by_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_shard_mesh()


def test_constrain_is_identity_and_rules_context():
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, "batch", "embed") is x
    rules = ShardingRules(_mesh(data=2, model=2))
    assert current_rules() is None
    with use_rules(rules) as r:
        assert r is rules and current_rules() is rules
        assert constrain(x, "batch", "embed") is x
    assert current_rules() is None
