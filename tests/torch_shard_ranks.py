"""What the ranks of ``tests/test_torch_shard_dist.py`` run, and the states
that both its reference subprocess and its ranks build.

A spawned rank imports its function by name, so these live in a module of
their own that imports no JAX at the top: a rank starts with torch and the
port only. Each rank function takes its rank first (``spawn_ranks``), runs
every case of its test in one process group, and pickles what it saw to
``work/rank{r}.pkl``; the test process asserts on those files.
"""
import pickle
from pathlib import Path

import numpy as np

FAMILIES = ("FLAT", "IVF_SQ8", "IVF_PQ", "IVF_PQR")
MODES = ("composed", "fused")
# 3,000 vectors in segments of 576: five sealed segments, so 4 ranks hold
# 2 + 2 + 1 + 0 (rank 3 only padding) and 3 ranks 2 + 2 + 1
STATIC_SEG = 576
# 2,048 vectors in segments of 1,024: two sealed segments on four ranks
PAD = dict(n=2048, n_queries=16, k=10, seed=0, dim=32)
PAD_CONFIG = dict(index_type="IVF_SQ8", nlist=16, nprobe=8, segment_max_size=1024,
                  seal_proportion=1.0, graceful_time=0.2, search_batch_size=16,
                  topk_merge_width=32, kmeans_iters=3, storage_bf16=False)


def static_config(base):
    """A family's default configuration (``torch_parity.default_config``)
    at :data:`STATIC_SEG`."""
    return dict(base, segment_max_size=STATIC_SEG)


def live_state(pkg, config, data, queries, k, draws=None, device=None):
    """The degraded live state of ``tests/test_torch_sharded.py``: the first
    2,700 vectors at segments of 512 (five sealed, a tail of 140), segment 1
    lost at the first search (no rebuild), 150 deletes. ``pkg`` is
    ``repro.vdms`` or ``repro_torch.vdms``."""
    cfg = dict(config, segment_max_size=512, seal_proportion=1.0)
    kw = {} if device is None else dict(device=device, draws=draws)
    live = pkg.LiveVDMS(cfg, dim=data.shape[1], capacity=data.shape[0], seed=0, **kw)
    live.bootstrap(data[:2700])
    live.arm_faults(pkg.FaultInjector(pkg.FaultPlan(
        events=(pkg.FaultEvent(kind="segment_loss", at_tick=1, segment=1),),
        backoff_base_ticks=100_000)))
    for g in np.random.default_rng(3).choice(2700, 150, replace=False):
        live.delete(int(g))
    live.search(queries, k)
    assert list(live.quarantined) == [1] and live.n_sealed == 5
    return live


def _setup():
    import repro_torch.vdms as V
    from repro_torch.vdms import ivf_pqr

    if ivf_pqr.FAMILY.name not in V.registered_names():
        ivf_pqr.register()  # registrations are per process: every rank registers
    return V


def _served(sharded, queries, k, root):
    """A search with scores, then one in wall mode with a hook attached:
    what every rank must see the same."""
    seen = []
    sharded.search_hooks.append(
        lambda nq, lat, elapsed: seen.append((nq, lat.tolist(), elapsed)))
    ids, scores, elapsed = sharded.search(queries if root else None, k, return_scores=True)
    sharded.search(queries if root else None, k, mode="wall")
    return dict(ids=ids, scores=scores, elapsed=elapsed, hooks=list(seen), stats=sharded.stats(),
                segments=sharded.shard_segments(), coverage=sharded.shard_coverage(),
                block_bytes=sharded.block_bytes())


def static_ranks(rank, work):
    """Every family's carried reference instance, composed and fused, under
    ``shard_map`` over the group; the root adds the port's ``vmap`` and
    unsharded results. Then the padding case, and the two refusals a group
    can show (a world size other than ``n_shards``)."""
    import torch.distributed as dist

    from repro_torch.distributed import make_shard_mesh
    from repro_torch.vdms import ShardedVDMS, VDMSInstance, VectorDataset, bundle_from_numpy

    V = _setup()
    work = Path(work)
    root = rank == 0
    world = dist.get_world_size()
    inp = pickle.loads((work / "inputs.pkl").read_bytes()) if root else None
    mesh = make_shard_mesh(device="cpu")
    out = dict(mesh=(mesh.size, mesh.rank, mesh.backend, [str(d) for d in mesh.devices]),
               cases={})
    for fam in FAMILIES:
        inst = None
        if root:
            d = inp["data"]
            ds = VectorDataset("parity", d["data"], d["queries"], d["ground_truth"], d["k"])
            kind, arrays, static = inp["bundles"][fam]
            inst = VDMSInstance(ds, inp["configs"][fam], seed=0, device="cpu",
                                bundle=bundle_from_numpy(kind, arrays, static, "cpu"))
        for mode in MODES:
            V.set_search_pipeline(mode)
            sharded = ShardedVDMS.from_instance(inst, n_shards=world, dispatch="shard_map",
                                                device="cpu")
            rec = _served(sharded, ds.queries if root else None, 10, root)
            rec["dispatch"] = sharded.dispatch
            if root:
                vmap = ShardedVDMS.from_instance(inst, n_shards=world, dispatch="vmap")
                rec["vmap"] = vmap.search(ds.queries, 10, return_scores=True)
                rec["vmap_stats"] = vmap.stats()
                rec["unsharded"] = inst.search(ds.queries, 10)
            out["cases"][(fam, mode)] = rec
    # two sealed segments on the group: the ranks past the first two hold padding
    V.set_search_pipeline("fused")
    inst = pad_ds = None
    if root:
        pad_ds = V.make_dataset("glove_like", device="cpu", **PAD)
        inst = V.VDMSInstance(pad_ds, PAD_CONFIG, seed=0, device="cpu")
    sharded = ShardedVDMS.from_instance(inst, n_shards=world, dispatch="shard_map", device="cpu")
    out["padding"] = _served(sharded, pad_ds.queries if root else None, 10, root)
    out["padding"]["n_pad"] = sharded.n_pad
    # measure() is collective too; every rank scores recall on the root's dataset
    out["padding"]["measure"] = {k: v for k, v in sharded.measure().items()
                                 if k != "compile_time"}
    if root:
        out["padding"]["unsharded"] = inst.search(pad_ds.queries, 10)
        out["padding"]["n_sealed"] = inst.plan.n_sealed
        vmap = ShardedVDMS.from_instance(inst, n_shards=world, dispatch="vmap").measure()
        out["padding"]["vmap_measure"] = {k: v for k, v in vmap.items() if k != "compile_time"}
    # refusals inside a group: checked before any collective, on every rank
    errors = {}
    for n in (2, world + 1):
        try:
            ShardedVDMS.from_instance(inst, n_shards=n, dispatch="shard_map", device="cpu")
        except ValueError as e:
            errors[n] = str(e)
    auto = ShardedVDMS.from_instance(inst, n_shards=world, device="cpu")
    out["errors"] = errors
    out["auto_dispatch"] = auto.dispatch
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    return 0


def live_ranks(rank, work):
    """Every family's degraded live state, built by the root with the
    reference's draws, snapshotted by ``from_live`` under ``shard_map``,
    composed and fused; the root adds ``live.search`` and ``vmap``."""
    import torch.distributed as dist

    from repro_torch.vdms import ShardedVDMS

    V = _setup()
    work = Path(work)
    root = rank == 0
    world = dist.get_world_size()
    inp = pickle.loads((work / "inputs.pkl").read_bytes()) if root else None
    out = dict(cases={})
    for fam in FAMILIES:
        live = None
        if root:
            from torch_parity import ReferenceDraws

            d = inp["data"]
            live = live_state(V, inp["configs"][fam], d["data"], d["queries"], d["k"],
                              draws=ReferenceDraws, device="cpu")
        for mode in MODES:
            V.set_search_pipeline(mode)
            snap = ShardedVDMS.from_live(live, n_shards=world, dispatch="shard_map",
                                         device="cpu")
            q = inp["data"]["queries"] if root else None
            rec = _served(snap, q, 10, root)
            rec["coverage_total"] = snap.coverage
            if root:
                rec["live"] = live.search(q, 10)[0]
                rec["vmap"] = ShardedVDMS.from_live(live, n_shards=world, dispatch="vmap").search(
                    q, 10, return_scores=True)
                lost = live.seg_gids[1]
                rec["lost"] = lost[lost >= 0]
            out["cases"][(fam, mode)] = rec
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    return 0


def block_hook(rank, sharded, queries):
    """``bench_sharded.run_ranks``' hook in the entry-point test: what the
    rank was handed."""
    return dict(rank=rank, per_shard=sharded.per_shard, n_queries=int(queries.shape[0]),
                block_bytes=sharded.block_bytes())


def failing_rank(rank, how):
    """Rank 2 raises, returns 1, or waits past the join's deadline; the
    others wait for it in a collective."""
    import time

    import torch.distributed as dist

    if rank == 2:
        if how == "raises":
            raise RuntimeError("rank 2 fails")
        if how == "exits":
            return 1
        time.sleep(600)
    dist.barrier()
    return 0
