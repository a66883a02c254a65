"""The port's ``dispatch="shard_map"``: sharded serving over a process group
of spawned ``gloo`` ranks on the CPU, one shard a rank, held against the
JAX package's ``shard_map`` over four forced host devices.

The reference runs once, in a subprocess (``XLA_FLAGS`` must be set before
JAX is imported, and this process imported it long ago), and hands over its
dataset, its built bundles and its results. Each test then spawns one group
(``distributed.spawn_ranks``) that runs all its cases
(``tests/torch_shard_ranks.py``) and pickles what every rank saw; the
assertions run here:

* every rank returns the same ids, scores, timing, hook arguments and
  placement telemetry;
* the ids equal the port's ``vmap`` dispatch and its unsharded search (or
  ``live.search`` for a live snapshot);
* ids and scores agree with the reference's ``shard_map`` to the standard
  of ``tests/test_torch_sharded.py::_check_parity``;

for FLAT, IVF_SQ8, IVF_PQ and IVF_PQR, composed and fused, on a static
instance over 4 and over 3 ranks (five sealed segments: uneven blocks, one
rank of padding only at 4) and on a degraded live state over 4 ranks; two
sealed segments on 4 ranks; the refusals; and the spawning mode of
``serve_sharded`` and ``bench_sharded``.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_shard_ranks as R
from repro_torch.distributed import sharding
from repro_torch.vdms import ShardedVDMS
from torch_parity import TOL, assert_ids_match, assert_topk_match
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"

REFERENCE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    import repro.vdms as jv
    import repro_torch.vdms as V
    from repro.vdms import ivf_pqr as j_pqr
    from repro.vdms.sharded import ShardedVDMS
    from repro_torch.vdms import ivf_pqr
    import torch_shard_ranks as R
    from torch_parity import default_config, reference_dataset

    j_pqr.register()
    ivf_pqr.register()
    assert len(jax.devices()) == 4
    ds = reference_dataset()
    q, k = ds.queries, ds.k
    out = dict(data=dict(data=ds.data, queries=q, ground_truth=ds.ground_truth, k=k),
               configs={}, bundles={}, static={}, live={})
    for fam in R.FAMILIES:
        cfg = R.static_config(default_config(fam))
        inst = jv.VDMSInstance(ds, cfg, seed=0)
        assert inst.plan.n_sealed == 5
        b = inst.bundle
        out["configs"][fam] = default_config(fam)
        out["bundles"][fam] = (b.kind, {n: np.asarray(a) for n, a in b.arrays.items()},
                               dict(b.static))
        live = R.live_state(jv, default_config(fam), ds.data, q, k)
        for mode in R.MODES:
            jv.set_search_pipeline(mode)
            for n in (4, 3):
                sh = ShardedVDMS.from_instance(inst, n_shards=n, dispatch="shard_map")
                out["static"][(fam, mode, n)] = sh.search(q, k, return_scores=True)[:2]
            sh = ShardedVDMS.from_live(live, n_shards=4, dispatch="shard_map")
            out["live"][(fam, mode)] = sh.search(q, k, return_scores=True)[:2]
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's dataset, bundles and ``shard_map`` results, and a work
    directory holding the ranks' inputs."""
    work = tmp_path_factory.mktemp("shard_dist")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(work / "reference.pkl")],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = pickle.loads((work / "reference.pkl").read_bytes())
    inputs = dict(data=ref["data"], bundles=ref["bundles"],
                  configs={f: R.static_config(c) for f, c in ref["configs"].items()})
    ref["work"] = work
    ref["inputs"] = inputs
    return ref


def _spawn(fn, world, work, inputs):
    work.mkdir(parents=True, exist_ok=True)
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    sharding.spawn_ranks(fn, world, backend="gloo", device=CPU, args=(str(work),),
                         join_timeout_s=300)
    return [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same_on_every_rank(recs):
    """Ids, score bits, the elapsed seconds, the hooks' arguments (the wall
    search's latencies are the root's, broadcast) and the telemetry."""
    first = recs[0]
    for r, rec in enumerate(recs[1:], 1):
        assert np.array_equal(rec["ids"], first["ids"]), f"rank {r} ids"
        assert np.array_equal(_bits(rec["scores"]), _bits(first["scores"])), f"rank {r} scores"
        assert rec["elapsed"] == first["elapsed"] and rec["hooks"] == first["hooks"], r
        assert rec["stats"] == first["stats"], r
        assert np.array_equal(rec["segments"], first["segments"]), r
        assert np.array_equal(rec["coverage"], first["coverage"]), r
    assert len(first["hooks"]) == 2 and first["hooks"][1][2] > 0  # the wall search's root clock


def _check_parity(ids, scores, jids, jscores, data, queries):
    assert_ids_match(ids, jids, data, queries)
    assert_topk_match(ids, np.where(ids >= 0, scores, -np.inf), jids,
                      np.where(jids >= 0, jscores, -np.inf), atol=TOL)


@pytest.mark.parametrize("world", [4, 3])
def test_static_shard_map_matches_vmap_and_reference(world, reference, tmp_path):
    """Static instances over ``world`` gloo ranks: the same results on every
    rank, equal to ``vmap`` (ids and score bits) and to the unsharded
    instance (ids), and to the reference's ``shard_map`` within TOL. At 4
    ranks the blocks are 2 + 2 + 1 + 0 segments, at 3 2 + 2 + 1. Also two
    sealed segments on the group, and the refusals inside a group."""
    recs = _spawn(R.static_ranks, world, tmp_path / "work", reference["inputs"])
    data = reference["data"]
    for r, rec in enumerate(recs):
        assert rec["mesh"] == (world, r, "gloo", ["cpu"] * world)
        assert set(rec["errors"]) == {2, world + 1}
        assert all("one rank a shard" in m for m in rec["errors"].values())
        assert rec["auto_dispatch"] == "shard_map"
    for (fam, mode), root in recs[0]["cases"].items():
        case = [rec["cases"][(fam, mode)] for rec in recs]
        _same_on_every_rank(case)
        assert root["dispatch"] == "shard_map"
        vids, vscores, velapsed = root["vmap"]
        assert np.array_equal(root["ids"], vids), (fam, mode)
        assert np.array_equal(_bits(root["scores"]), _bits(vscores)), (fam, mode)
        assert root["elapsed"] == velapsed  # the analytic model does not see the dispatch
        assert np.array_equal(root["ids"], root["unsharded"]), (fam, mode)
        stats = {k: v for k, v in root["stats"].items()
                 if k not in ("queries_served", "dispatch")}
        assert stats == {k: root["vmap_stats"][k] for k in stats}
        segs = root["segments"].tolist()
        assert segs == ([2, 2, 1, 0] if world == 4 else [2, 2, 1])
        assert [rec["cases"][(fam, mode)]["block_bytes"] for rec in recs] == \
            [root["block_bytes"]] * world  # every rank holds per_shard segments
        jids, jscores = reference["static"][(fam, mode, world)]
        _check_parity(root["ids"], root["scores"], jids, jscores, data["data"], data["queries"])
    pad = [rec["padding"] for rec in recs]
    _same_on_every_rank(pad)
    assert pad[0]["n_sealed"] == 2 and pad[0]["n_pad"] == world - 2
    assert np.array_equal(pad[0]["ids"], pad[0]["unsharded"])
    assert pad[0]["segments"].tolist() == [1, 1] + [0] * (world - 2)
    assert pad[0]["coverage"].tolist() == [1.0, 1.0] + [0.0] * (world - 2)
    assert all(p["measure"] == pad[0]["vmap_measure"] for p in pad)


def test_live_shard_map_matches_live_search_and_reference(reference, tmp_path):
    """Degraded live states (segment 1 quarantined, 150 deletes, a tail of
    140) with the reference's draws, snapshotted over 4 gloo ranks: the same
    results on every rank, equal to ``live.search`` and ``vmap``, to the
    reference's ``from_live`` under ``shard_map`` within TOL; no id of the
    lost segment served."""
    recs = _spawn(R.live_ranks, 4, tmp_path / "work", reference["inputs"])
    data = reference["data"]
    for (fam, mode), root in recs[0]["cases"].items():
        _same_on_every_rank([rec["cases"][(fam, mode)] for rec in recs])
        assert np.array_equal(root["ids"], root["live"]), (fam, mode)
        assert np.array_equal(root["ids"], root["vmap"][0]), (fam, mode)
        assert np.array_equal(_bits(root["scores"]), _bits(root["vmap"][1])), (fam, mode)
        assert not set(root["lost"].tolist()) & set(root["ids"][root["ids"] >= 0].tolist())
        assert root["stats"]["min_shard_coverage"] < 1.0 and root["coverage_total"] < 1.0
        jids, jscores = reference["live"][(fam, mode)]
        _check_parity(root["ids"], root["scores"], jids, jscores, data["data"], data["queries"])


def test_shard_map_refusals_without_a_group(monkeypatch):
    """No process group: ``shard_map`` raises and ``auto`` stays ``vmap``;
    ``nccl`` is refused on the CPU and where ranks would share a device,
    before anything is spawned; an unknown backend is refused."""
    import repro_torch.vdms as V

    ds = V.make_dataset("glove_like", device=CPU, **R.PAD)
    inst = V.VDMSInstance(ds, R.PAD_CONFIG, seed=0, device=CPU)
    assert sharding.group_world_size() is None
    with pytest.raises(ValueError, match="process group"):
        ShardedVDMS.from_instance(inst, n_shards=2, dispatch="shard_map")
    assert ShardedVDMS.from_instance(inst, n_shards=2).dispatch == "vmap"
    with pytest.raises(ValueError, match="needs CUDA"):
        sharding.spawn_ranks(R.static_ranks, 4, backend="nccl", device=CPU, args=("",))
    with pytest.raises(ValueError, match="backend must be"):
        sharding.check_backend("mpi", 4, CPU)
    monkeypatch.setattr(sharding, "resolve_device", lambda device=None: __import__(
        "torch").device("cuda"))
    monkeypatch.setattr(sharding.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share a device"):
        sharding.spawn_ranks(R.static_ranks, 4, backend="nccl", args=("",))
    sharding.check_backend("nccl", 1)  # one rank a card is what NCCL takes
    sharding.check_backend("gloo", 4)  # gloo ranks may share the card


def test_spawned_entry_points(capfd):
    """``serve_sharded --ranks 4`` on the CPU (its corpus, 65,536 vectors)
    and ``bench_sharded.run_ranks(4)`` at 16,384 vectors (``--ranks`` at
    ``--quick``, 1 M vectors, takes ~30 s here): four gloo ranks, the
    shard-count invariants at ``shard_map`` against ``vmap`` and
    ``direct``, every rank's hook result in its record, rank 0 printing,
    exit 0."""
    from repro_torch.bench import bench_sharded
    from repro_torch.launch import serve_sharded

    assert serve_sharded.main(["--ranks", "4", "--device", CPU]) == 0
    out = capfd.readouterr().out
    assert "4 ranks (shard_map)" in out and "invariants hold" in out
    assert out.rstrip().endswith("OK")
    rec = bench_sharded.run_ranks(4, device=CPU, sizes=dict(n_base=16384, dim=64, n_queries=32,
                                                            k=10), hook=R.block_hook)
    assert bench_sharded.check_rank_invariants(rec) == ["n_base=16384 below the 1M-vector floor"]
    assert [r["rank"] for r in rec["ranks"]] == [0, 1, 2, 3] and rec["per_shard"] == 1
    assert {r["block_bytes"] for r in rec["ranks"]} == {rec["ranks"][0]["block_bytes"]}
    assert [r["hook"] for r in rec["ranks"]] == [
        dict(rank=r["rank"], per_shard=1, n_queries=32, block_bytes=r["block_bytes"])
        for r in rec["ranks"]]
    assert rec["dispatches"]["shard_map"]["dispatch"] == "shard_map"
    assert rec["dispatches"]["vmap"]["analytic_s"] == rec["dispatches"]["shard_map"]["analytic_s"]
    bench_sharded.print_ranks(rec)
    assert "gather" in capfd.readouterr().out


@pytest.mark.parametrize("how", ["raises", "exits", "hangs"])
def test_failed_rank_fails_the_run(how):
    """A rank that raises, exits non-zero or outlives the join's deadline
    ends the run with ``RuntimeError``; the other ranks are stopped."""
    match = "did not finish" if how == "hangs" else "rank 2 exit 1"
    with pytest.raises(RuntimeError, match=match):
        sharding.spawn_ranks(R.failing_rank, 4, backend="gloo", device=CPU, args=(how,),
                             join_timeout_s=8 if how == "hangs" else 120, timeout_s=60)
