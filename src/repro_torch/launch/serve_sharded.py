"""Sharded serving on the port: place a sealed corpus on 1, 2 and 4 shards
and drive it (the twin of the JAX package's ``examples/serve_sharded.py``,
at its sizes; the shards are emulated on one device, the GPU unless
``--device cpu`` is given).

1. bulk-build a corpus with :class:`~repro_torch.vdms.engine.VDMSInstance`;
2. place its sealed segments across 1/2/4 shards
   (:class:`~repro_torch.vdms.sharded.ShardedVDMS`) and verify the
   shard-count invariants — identical ids, identical recall, analytic QPS
   scaling;
3. attach the serving metrics ledger (``attach_sharded``) and offer
   multi-stream Poisson load (:func:`~repro_torch.vdms.replay_query_streams`);
4. snapshot a tombstoned :class:`~repro_torch.vdms.engine.LiveVDMS` with
   ``from_live`` and confirm the 1- and 4-shard snapshots serve what
   ``live.search`` serves.

With ``--ranks N`` the same corpus is served by N spawned processes, one
shard a rank (``dispatch="shard_map"`` over a ``torch.distributed`` group):
rank 0 builds the corpus and the live engine, the others receive their
blocks; the ids must be the same on every rank and equal to ``vmap`` at N
shards, ``direct`` at one and the unsharded instance; the Poisson replay
and the live snapshot run over the ranks. Rank 0 prints. The group is
gloo, which runs the ranks on the CPU or shares one card among them.

    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu --ranks 4

Exits non-zero on failure, also when a rank fails or the ranks do not
finish.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..device import resolve_device
from ..distributed.sharding import rank_device, spawn_ranks
from ..serving import attach_sharded, serving_ledger
from ..vdms import (LiveVDMS, ShardedVDMS, VDMSInstance, make_dataset, recall_at_k,
                    replay_query_streams)

CONFIG = dict(
    index_type="IVF_SQ8", nlist=32, nprobe=8, kmeans_iters=3,
    segment_max_size=2048, seal_proportion=1.0, search_batch_size=32,
    graceful_time=0.2, topk_merge_width=32, storage_bf16=False,
)


def _live(ds, device):
    """A tombstoned live engine over the corpus's first 20,000 vectors."""
    live = LiveVDMS(CONFIG, dim=64, capacity=65536, seed=0, device=device)
    live.insert(ds.data[:20000])
    rng = np.random.default_rng(0)
    for g in rng.choice(16000, 800, replace=False):
        live.delete(int(g))
    return live


def _rank(rank: int, device_arg) -> int:
    """One rank of ``--ranks N``: every rank places, searches and replays
    in the same order; rank 0 holds the corpus and checks and prints."""
    import torch.distributed as dist

    world = dist.get_world_size()
    root = rank == 0
    device = rank_device(device_arg)
    ds = inst = None

    def fail(msg):
        print(f"FAILED: {msg}", file=sys.stderr)
        return 1

    def agree(ids) -> bool:  # the same ids on every rank
        seen = [None] * world
        dist.all_gather_object(seen, ids.tobytes())
        return all(s == seen[0] for s in seen)

    if root:
        print(f"== {world} ranks, one shard each; rank 0 on {device} builds ==")
        ds = make_dataset("glove_like", n=65536, n_queries=64, dim=64, k=10, seed=0,
                          device=device)
        inst = VDMSInstance(ds, CONFIG, seed=0, device=device)
        print(f"   built {inst.plan.n_sealed} sealed segments over {ds.n} vectors")
    # the root's queries on every rank, so every rank makes the same calls
    box = [ds.queries if root else None]
    dist.broadcast_object_list(box, src=0)
    queries = box[0]
    sharded = ShardedVDMS.from_instance(inst, n_shards=world, device=device_arg)
    ids, scores, elapsed = sharded.search(queries, 10, mode="analytic", return_scores=True)
    same = agree(ids)
    if root:
        print(f"== shard-count invariants: {world} ranks (shard_map) against vmap and direct ==")
        print(f"   {world} ranks ({sharded.dispatch}): blocks of {sharded.per_shard} segments, "
              f"{sharded.block_bytes()} bytes on rank 0, qps={queries.shape[0] / elapsed:.0f} "
              f"recall={recall_at_k(ids, ds.ground_truth):.3f}")
        if sharded.dispatch != "shard_map" or not same:
            return fail("the ranks returned different ids")
        vids, vscores, _ = ShardedVDMS.from_instance(
            inst, n_shards=world, dispatch="vmap").search(queries, 10, return_scores=True)
        dids = ShardedVDMS.from_instance(inst, n_shards=1).search(queries, 10)[0]
        if not (np.array_equal(ids, vids) and np.array_equal(ids, dids)
                and np.array_equal(ids, inst.search(queries, 10))):
            return fail("shard_map ids differ from vmap, direct or the unsharded instance")
        if not np.array_equal(scores.view(np.int32), vscores.view(np.int32)):
            return fail("shard_map scores differ from vmap's")
        print("   invariants hold: the same ids on every rank, equal to vmap, direct and "
              "the unsharded instance")
    ledger = serving_ledger()
    attach_sharded(ledger, sharded)
    rep = replay_query_streams(sharded, queries, rate=0.5 * queries.shape[0] / elapsed,
                               n_streams=8, n_per_stream=16, topk=10)
    if root:
        print(f"== Poisson multi-stream serving over the ranks: offered="
              f"{rep['offered_qps']:.0f}/s served={rep['served_qps']:.0f}/s "
              f"p99={rep['sojourn_p99_s'] * 1e3:.2f}ms; ledger shards="
              f"{ledger.get('vdms_shards').value:.0f} queries="
              f"{ledger.get('vdms_queries_total').value:.0f}")
        if ledger.get("vdms_shards").value != world:
            return fail("the ledger saw the wrong shard count")
    live = _live(ds, device) if root else None
    snap = ShardedVDMS.from_live(live, n_shards=world, device=device_arg)
    ids, _ = snap.search(queries, 10)
    same = agree(ids)
    if root:
        if not (same and np.array_equal(ids, live.search(queries, 10)[0])):
            return fail(f"the {world}-rank live snapshot differs from live.search")
        print(f"== live snapshot over {world} ranks = live.search (min shard coverage "
              f"{snap.stats()['min_shard_coverage']:.3f}) ==")
        print("OK")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--ranks", type=int, default=0,
                   help="serve over this many spawned ranks, one shard each")
    args = p.parse_args(argv)
    if args.ranks:
        try:
            spawn_ranks(_rank, args.ranks, backend="gloo", device=args.device,
                        args=(args.device,))
        except RuntimeError as e:
            print(f"FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    device = resolve_device(args.device)

    print(f"== device: {device}; shards beyond one emulated on it ==")
    ds = make_dataset("glove_like", n=65536, n_queries=64, dim=64, k=10, seed=0, device=device)
    inst = VDMSInstance(ds, CONFIG, seed=0, device=device)
    print(f"   built {inst.plan.n_sealed} sealed segments over {ds.n} vectors")

    print("== shard-count invariants (1 -> 2 -> 4 shards) ==")
    results = {}
    for n in (1, 2, 4):
        sharded = ShardedVDMS.from_instance(inst, n_shards=n)
        ids, elapsed = sharded.search(ds.queries, 10, mode="analytic")
        recall = recall_at_k(ids, ds.ground_truth)
        results[n] = (ids, elapsed, recall, sharded)
        print(
            f"   {n} shards ({sharded.dispatch}): qps={ds.queries.shape[0] / elapsed:.0f} "
            f"recall={recall:.3f}"
        )
    ids1 = results[1][0]
    if not all(np.array_equal(results[n][0], ids1) for n in (2, 4)):
        print("FAILED: shard count changed the returned ids", file=sys.stderr)
        return 1
    if len({results[n][2] for n in (1, 2, 4)}) != 1:
        print("FAILED: recall diverged", file=sys.stderr)
        return 1
    if not results[4][1] < results[1][1]:
        print("FAILED: 4 shards must be faster than 1 (analytic)", file=sys.stderr)
        return 1
    print("   invariants hold: identical ids, identical recall, QPS scales")

    print("== Poisson multi-stream serving with the metrics ledger ==")
    sharded = results[4][3]
    ledger = serving_ledger()
    attach_sharded(ledger, sharded)
    qps = ds.queries.shape[0] / results[4][1]
    rep = replay_query_streams(
        sharded, ds.queries, rate=0.5 * qps, n_streams=8, n_per_stream=16, topk=10,
    )
    print(
        f"   offered={rep['offered_qps']:.0f}/s served={rep['served_qps']:.0f}/s "
        f"p99={rep['sojourn_p99_s'] * 1e3:.2f}ms util={rep['utilization']:.2f}"
    )
    if not (ledger.get("vdms_queries_total").value > 0 and ledger.get("vdms_shards").value == 4.0):
        print("FAILED: the ledger saw no queries or the wrong shard count", file=sys.stderr)
        return 1
    print(f"   ledger: shards={ledger.get('vdms_shards').value:.0f} "
          f"queries={ledger.get('vdms_queries_total').value:.0f} "
          f"skew={ledger.get('vdms_shard_skew').value:.2f}")

    print("== live snapshot: tombstones + growing tail, sharded ==")
    live = _live(ds, device)
    live_ids, _ = live.search(ds.queries, 10)
    snap_ids, _ = ShardedVDMS.from_live(live, n_shards=1).search(ds.queries, 10)
    if not np.array_equal(snap_ids, live_ids):
        print("FAILED: the 1-shard live snapshot differs from live.search", file=sys.stderr)
        return 1
    snap4 = ShardedVDMS.from_live(live, n_shards=4)
    ids4, _ = snap4.search(ds.queries, 10)
    if not np.array_equal(ids4, live_ids):
        print("FAILED: the 4-shard live snapshot changed results", file=sys.stderr)
        return 1
    st = snap4.stats()
    print(
        f"   live snapshot serves identically at 4 shards "
        f"(min shard coverage {st['min_shard_coverage']:.3f}, "
        f"tail {st['growing_size']} rows)"
    )
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
