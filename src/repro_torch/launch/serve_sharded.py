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

    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu

Exits non-zero on failure.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..device import resolve_device
from ..serving import attach_sharded, serving_ledger
from ..vdms import (LiveVDMS, ShardedVDMS, VDMSInstance, make_dataset, recall_at_k,
                    replay_query_streams)

CONFIG = dict(
    index_type="IVF_SQ8", nlist=32, nprobe=8, kmeans_iters=3,
    segment_max_size=2048, seal_proportion=1.0, search_batch_size=32,
    graceful_time=0.2, topk_merge_width=32, storage_bf16=False,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
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
    live = LiveVDMS(CONFIG, dim=64, capacity=65536, seed=0, device=device)
    live.insert(ds.data[:20000])
    rng = np.random.default_rng(0)
    for g in rng.choice(16000, 800, replace=False):
        live.delete(int(g))
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
