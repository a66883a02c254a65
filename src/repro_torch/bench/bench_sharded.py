"""Sharded segment serving at realistic corpus size (the twin of the JAX
package's ``benchmarks/bench_sharded.py``; the dataset's ground truth, the
build and every search run on ``--device``, the GPU unless ``--device cpu``
is given).

Builds one IVF_SQ8 corpus at ``n_base >= 1M`` (256+ sealed segments), places
it at increasing shard counts with :class:`~repro_torch.vdms.sharded.ShardedVDMS`
(on one device: ``direct`` at one shard, the shards emulated by ``vmap``
beyond), and measures per shard count:

* **QPS** in the deterministic analytic mode (the gated number: leaf work
  charges the critical shard, the root merge charges the shard count) with
  wall-clock reported alongside;
* **recall** against the brute-force oracle — gated to match the unsharded
  engine *exactly* (sharding must never change what is returned);
* **(gid, score) result sets** — gated identical across every shard count;
* a **Poisson multi-stream replay** (``repro_torch.vdms.replay_query_streams``)
  offered at ~70% of the measured analytic capacity: served QPS, sojourn
  percentiles, utilization, saturation flag;
* the **kernel launches** of that shard count's searches alone
  (``repro_torch.kernels.ops.launch_counts``; none on the CPU).

``--check-invariants`` exits non-zero unless the recall/result-set
invariants hold AND the 1→4-shard analytic scaling clears
``MIN_QPS_SCALING_1_TO_4`` (when a 4-shard point is in the run).

With ``--ranks N`` (:func:`run_ranks`) the corpus is served instead by N
spawned processes, one shard a rank (``dispatch="shard_map"`` over a
``torch.distributed`` group over gloo, which also lets the ranks share one
card): rank 0 builds it, the others receive their blocks, and each rank's block bytes, kernel launches and result digest are
gathered. Rank 0 also serves the corpus at ``direct`` (one shard) and
``vmap`` (N emulated shards) and records wall seconds of each dispatch and
the ms of one ``all_gather`` of a chunk's partial lists;
``--check-invariants`` then gates equal ids on every rank, ids and
(gid, score) sets equal across the three dispatches and the unsharded
engine, and the 1 M floor (and on the card, the SQ8 kernel launched on
every rank).

    PYTHONPATH=src python -m repro_torch.bench.bench_sharded --device cpu --quick --check-invariants
    PYTHONPATH=src python -m repro_torch.bench.bench_sharded --device cpu --quick --ranks 4 \
        --check-invariants
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device, sync
from ..distributed.sharding import rank_device, spawn_ranks
from ..kernels import ops
from ..vdms import ShardedVDMS, VDMSInstance, make_dataset, recall_at_k, replay_query_streams
from ..vdms.sharded import MIN_QPS_SCALING_1_TO_4, gather_partials
from .common import emit

SHARD_COUNTS = (1, 2, 4)


def _sizes(quick: bool):
    if quick:
        return dict(n_base=1_048_576, dim=64, n_queries=64, k=10)
    return dict(n_base=4_194_304, dim=64, n_queries=256, k=10)


def _config(quick: bool):
    return dict(
        index_type="IVF_SQ8",
        nlist=64,
        nprobe=8,
        kmeans_iters=4,
        segment_max_size=4096,
        seal_proportion=1.0,
        search_batch_size=32,
        graceful_time=0.2,
        topk_merge_width=32,
        storage_bf16=False,
    )


def _result_set(ids: np.ndarray, scores: np.ndarray):
    """Per-query frozenset of (gid, score-bits) — the shard-count invariant
    compares exact float bit patterns, not approximate equality."""
    bits = scores.view(np.int32)
    return [
        frozenset((int(g), int(b)) for g, b in zip(row_i, row_b) if g >= 0)
        for row_i, row_b in zip(ids, bits)
    ]


def run(seed: int = 0, quick: bool = True, shard_counts=SHARD_COUNTS, device=None,
        sizes=None, keep=None, draws=None):
    """The benchmark; ``sizes`` overrides :func:`_sizes`, ``draws`` is the
    build's source of random draws (default ``BuildDraws``), and a ``keep``
    dict receives the built ``instance`` and ``dataset`` (for a caller that
    holds the kernels on them)."""
    device = resolve_device(device)
    sz = sizes or _sizes(quick)
    t0 = time.perf_counter()
    ds = make_dataset(
        "glove_like", n=sz["n_base"], n_queries=sz["n_queries"],
        dim=sz["dim"], k=sz["k"], seed=seed, device=device,
    )
    dataset_s = time.perf_counter() - t0
    cfg = _config(quick)
    t0 = time.perf_counter()
    inst = VDMSInstance(ds, cfg, seed=seed, device=device, draws=draws)
    build_s = time.perf_counter() - t0

    out = {
        "n_base": sz["n_base"],
        "dim": sz["dim"],
        "n_queries": sz["n_queries"],
        "k": sz["k"],
        "n_sealed": int(inst.plan.n_sealed),
        "n_devices": 1,
        "device": str(device),
        "dataset_s": dataset_s,
        "build_s": build_s,
        "min_qps_scaling_1_to_4": MIN_QPS_SCALING_1_TO_4,
        "shards": {},
    }
    # the unsharded engine's ids: the 1-shard run must equal them byte for byte
    unsharded = inst.search(ds.queries, sz["k"])

    baseline = None
    for n in shard_counts:
        sharded = ShardedVDMS.from_instance(inst, n_shards=n)
        before = ops.launch_counts()  # this shard count's searches alone are counted
        ids, scores, _ = sharded.search(ds.queries, sz["k"], mode="analytic", return_scores=True)
        _, analytic_s = sharded.search(ds.queries, sz["k"], mode="analytic")
        _, wall_s = sharded.search(ds.queries, sz["k"], mode="wall")
        qps = sz["n_queries"] / max(analytic_s, 1e-12)
        recall = float(recall_at_k(ids[:, : ds.k], ds.ground_truth))
        rec = {
            "dispatch": sharded.dispatch,
            "qps_analytic": float(qps),
            "qps_wall": float(sz["n_queries"] / max(wall_s, 1e-12)),
            "wall_s": float(wall_s),
            "compile_s": float(sharded.compile_s),
            "recall": recall,
            "mem_gib": float(sharded.memory_gib()),
            "stats": sharded.stats(),
            "equals_unsharded": bool(np.array_equal(ids, unsharded)),
        }
        if baseline is None:
            baseline = {"qps": qps, "recall": recall, "sets": _result_set(ids, scores),
                        "ids": ids}
            rec["qps_scaling_vs_1"] = 1.0
            rec["recall_matches_unsharded"] = True
            rec["result_sets_match"] = True
            rec["bitwise_identical"] = True
        else:
            rec["qps_scaling_vs_1"] = float(qps / baseline["qps"])
            rec["recall_matches_unsharded"] = bool(recall == baseline["recall"])
            rec["result_sets_match"] = bool(_result_set(ids, scores) == baseline["sets"])
            rec["bitwise_identical"] = bool(np.array_equal(ids, baseline["ids"]))
        # Poisson multi-stream replay at ~70% of analytic capacity
        rec["poisson"] = replay_query_streams(
            sharded, ds.queries, rate=0.7 * qps, n_streams=8,
            n_per_stream=32 if quick else 64, topk=sz["k"], seed=seed,
        )
        rec["launches"] = {k: c - before[k] for k, c in ops.launch_counts().items()}
        out["shards"][str(n)] = rec
        emit(
            f"sharded/{n}",
            analytic_s / sz["n_queries"] * 1e6,
            f"qps={qps:.0f};scale={rec['qps_scaling_vs_1']:.2f};"
            f"recall={recall:.3f};dispatch={sharded.dispatch}",
        )
    if keep is not None:
        keep.update(instance=inst, dataset=ds)
    return out


def check_invariants(out) -> list:
    """The gate: returns a list of violation strings (empty = pass)."""
    bad = []
    for n, rec in out["shards"].items():
        if not rec["recall_matches_unsharded"]:
            bad.append(f"{n} shards: recall diverged from the unsharded engine")
        if not rec["result_sets_match"]:
            bad.append(f"{n} shards: (gid, score) result sets changed")
    rec1 = out["shards"].get("1")
    if rec1 is not None and not rec1["equals_unsharded"]:
        bad.append("1 shard: ids differ from the unsharded engine's")
    rec4 = out["shards"].get("4")
    if rec4 is not None:
        if rec4["qps_scaling_vs_1"] < out["min_qps_scaling_1_to_4"]:
            bad.append(
                f"1->4 shard scaling {rec4['qps_scaling_vs_1']:.2f}x below the "
                f"{out['min_qps_scaling_1_to_4']}x gate"
            )
    if out["n_base"] < 1_000_000:
        bad.append(f"n_base={out['n_base']} below the 1M-vector floor")
    return bad


# ---------------------------------------------------------------------------
# one shard a rank: the spawned mode
# ---------------------------------------------------------------------------
GATHER_REPEATS = 20


def _served(sharded, queries, k):
    """One dispatch's record: its ids and scores (analytic), wall seconds
    (first run of the shape apart) and the kernel launches of its searches
    (this process's counts set to 0 just before and read just after)."""
    ops.reset_launch_counts()
    ids, scores, analytic_s = sharded.search(queries, k, mode="analytic", return_scores=True)
    _, wall_s = sharded.search(queries, k, mode="wall")
    launches = ops.launch_counts()
    return ids, scores, dict(dispatch=sharded.dispatch, analytic_s=float(analytic_s),
                             wall_s=float(wall_s), compile_s=float(sharded.compile_s),
                             launches=launches)


def _rank(rank: int, quick: bool, seed: int, device_arg, sizes, work: str, hook) -> int:
    """One rank of :func:`run_ranks`; rank 0 writes ``work/out.json``."""
    import torch.distributed as dist

    world = dist.get_world_size()
    root = rank == 0
    device = rank_device(device_arg)
    sz = sizes or _sizes(quick)
    ds = inst = None
    out = {}
    if root:
        t0 = time.perf_counter()
        ds = make_dataset("glove_like", n=sz["n_base"], n_queries=sz["n_queries"],
                          dim=sz["dim"], k=sz["k"], seed=seed, device=device)
        out["dataset_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inst = VDMSInstance(ds, _config(quick), seed=seed, device=device)
        out["build_s"] = time.perf_counter() - t0
    box = [ds.queries if root else None]
    dist.broadcast_object_list(box, src=0)
    queries = box[0]
    t0 = time.perf_counter()
    sharded = ShardedVDMS.from_instance(inst, n_shards=world, dispatch="shard_map",
                                        device=device_arg)
    place_s = time.perf_counter() - t0
    ids, scores, rec = _served(sharded, queries, sz["k"])
    # one all_gather of a chunk's partial lists, as the dispatch makes it
    b, ks = min(sharded.batch, queries.shape[0]), min(sz["k"], sharded.per_shard * sharded.k_seg)
    pid = torch.zeros((b, ks), dtype=torch.int32, device=device)
    psc = torch.zeros((b, ks), dtype=torch.float32, device=device)
    gather_partials(pid, psc, sharded.mesh)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(GATHER_REPEATS):
        gather_partials(pid, psc, sharded.mesh)
    sync(device)
    gather_ms = (time.perf_counter() - t0) / GATHER_REPEATS * 1e3
    digest = hashlib.sha256(ids.tobytes() + scores.tobytes()).hexdigest()
    mine = dict(rank=rank, device=str(device), block_bytes=sharded.block_bytes(),
                place_s=place_s, gather_ms=gather_ms, digest=digest, **rec,
                hook=hook(rank, sharded, queries) if hook else None)
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    if not root:
        return 0
    unsharded = inst.search(queries, sz["k"])
    sets = _result_set(ids, scores)
    recall = float(recall_at_k(ids[:, : ds.k], ds.ground_truth))
    dispatches = {"shard_map": dict(rec, recall=recall, equals_unsharded=bool(
        np.array_equal(ids, unsharded)), result_sets_match=True, ids_equal=True)}
    for name, n in (("direct", 1), ("vmap", world)):
        other = ShardedVDMS.from_instance(inst, n_shards=n, dispatch=name)
        o_ids, o_scores, o_rec = _served(other, queries, sz["k"])
        dispatches[name] = dict(o_rec, recall=float(recall_at_k(o_ids[:, : ds.k],
                                                                 ds.ground_truth)),
                                equals_unsharded=bool(np.array_equal(o_ids, unsharded)),
                                result_sets_match=_result_set(o_ids, o_scores) == sets,
                                ids_equal=bool(np.array_equal(o_ids, ids)))
        del other
    out.update(n_base=sz["n_base"], dim=sz["dim"], n_queries=sz["n_queries"], k=sz["k"],
               n_sealed=int(inst.plan.n_sealed), n_ranks=world, per_shard=sharded.per_shard,
               n_pad=sharded.n_pad, batch=sharded.batch, device=str(device),
               backend=sharded.mesh.backend, dispatches=dispatches, ranks=ranks)
    (Path(work) / "out.json").write_text(json.dumps(out))
    return 0


def run_ranks(world: int, *, quick: bool = True, seed: int = 0, device=None, sizes=None,
              join_timeout_s: float = 900.0, hook=None):
    """The benchmark over ``world`` spawned gloo ranks, one shard each (see
    the module docstring); ``sizes`` overrides :func:`_sizes`. ``hook``, a
    module-level function (it is pickled to the ranks), is called on every
    rank as ``hook(rank, sharded, queries)`` after the counted searches and
    its result stands under ``"hook"`` in that rank's record. Returns rank
    0's record; raises ``RuntimeError`` when a rank fails or the ranks do
    not finish within ``join_timeout_s``."""
    work = tempfile.mkdtemp(prefix="bench-sharded-")
    try:
        spawn_ranks(_rank, world, backend="gloo", device=device,
                    args=(quick, seed, device, sizes, work, hook),
                    join_timeout_s=join_timeout_s)
        return json.loads((Path(work) / "out.json").read_text())
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_rank_invariants(out) -> list:
    """The gate of the spawned mode: returns violation strings (empty =
    pass)."""
    bad = []
    if len({r["digest"] for r in out["ranks"]}) != 1:
        bad.append("the ranks returned different ids or scores")
    for name, rec in out["dispatches"].items():
        if not rec["equals_unsharded"]:
            bad.append(f"{name}: ids differ from the unsharded engine's")
        if not (rec["ids_equal"] and rec["result_sets_match"]):
            bad.append(f"{name}: ids or (gid, score) sets differ from shard_map's")
        if rec["recall"] != out["dispatches"]["shard_map"]["recall"]:
            bad.append(f"{name}: recall differs from shard_map's")
    if out["device"].startswith("cuda"):
        for r in out["ranks"]:
            if r["launches"]["fused_ivf_sq8_topk"] == 0:
                bad.append(f"rank {r['rank']}: the SQ8 kernel was not launched")
    if out["n_base"] < 1_000_000:
        bad.append(f"n_base={out['n_base']} below the 1M-vector floor")
    return bad


def print_ranks(out) -> None:
    n_chunks = -(-out["n_queries"] // out["batch"])
    for name, rec in out["dispatches"].items():
        print(f"{name}: wall {rec['wall_s'] / n_chunks * 1e3:.3f} ms a chunk of {out['batch']}, "
              f"analytic QPS {out['n_queries'] / rec['analytic_s']:.0f}, recall "
              f"{rec['recall']:.3f}, ids = unsharded {rec['equals_unsharded']}")
    for r in out["ranks"]:
        print(f"rank {r['rank']} ({r['device']}): block {r['block_bytes']} bytes, placed in "
              f"{r['place_s']:.3f} s, gather {r['gather_ms']:.4f} ms, launches "
              f"{ {k: c for k, c in r['launches'].items() if c} }")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="the smaller corpus (1M vectors)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shards", nargs="+", type=int, default=list(SHARD_COUNTS),
                   help="shard counts to measure (emulated on one device beyond one)")
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--json", default=None, metavar="PATH", help="write results as JSON")
    p.add_argument("--check-invariants", action="store_true",
                   help="exit 1 unless recall/result-set invariants hold and 1->4 "
                        "scaling clears the gate")
    p.add_argument("--ranks", type=int, default=0,
                   help="serve over this many spawned ranks, one shard each")
    args = p.parse_args(argv)
    if args.ranks:
        try:
            out = run_ranks(args.ranks, quick=args.quick, seed=args.seed, device=args.device)
        except RuntimeError as e:
            print(f"FAILED: {e}", file=sys.stderr)
            return 1
        return _finish(out, check_rank_invariants(out), args, print_ranks)

    out = run(seed=args.seed, quick=args.quick, shard_counts=tuple(args.shards),
              device=args.device)
    return _finish(out, check_invariants(out), args, print_shards)


def _finish(out, violations, args, show) -> int:
    out["invariant_violations"] = violations
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    show(out)
    for v in violations:
        print(f"INVARIANT VIOLATION: {v}", file=sys.stderr)
    return 1 if (args.check_invariants and violations) else 0


def print_shards(out) -> None:
    for n, rec in out["shards"].items():
        po = rec["poisson"]
        print(
            f"{n} shards ({rec['dispatch']}): qps={rec['qps_analytic']:.0f} "
            f"(scale {rec['qps_scaling_vs_1']:.2f}x) wall qps={rec['qps_wall']:.0f} "
            f"recall={rec['recall']:.3f} poisson served={po['served_qps']:.0f}/"
            f"{po['offered_qps']:.0f} p99={po['sojourn_p99_s'] * 1e3:.2f}ms "
            f"util={po['utilization']:.2f}"
        )


if __name__ == "__main__":
    sys.exit(main())
