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

    PYTHONPATH=src python -m repro_torch.bench.bench_sharded --device cpu --quick --check-invariants
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..device import resolve_device
from ..kernels import ops
from ..vdms import ShardedVDMS, VDMSInstance, make_dataset, recall_at_k, replay_query_streams
from ..vdms.sharded import MIN_QPS_SCALING_1_TO_4
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
    args = p.parse_args(argv)

    out = run(seed=args.seed, quick=args.quick, shard_counts=tuple(args.shards),
              device=args.device)
    violations = check_invariants(out)
    out["invariant_violations"] = violations
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)

    for n, rec in out["shards"].items():
        po = rec["poisson"]
        print(
            f"{n} shards ({rec['dispatch']}): qps={rec['qps_analytic']:.0f} "
            f"(scale {rec['qps_scaling_vs_1']:.2f}x) wall qps={rec['qps_wall']:.0f} "
            f"recall={rec['recall']:.3f} poisson served={po['served_qps']:.0f}/"
            f"{po['offered_qps']:.0f} p99={po['sojourn_p99_s'] * 1e3:.2f}ms "
            f"util={po['utilization']:.2f}"
        )
    for v in violations:
        print(f"INVARIANT VIOLATION: {v}", file=sys.stderr)
    return 1 if (args.check_invariants and violations) else 0


if __name__ == "__main__":
    sys.exit(main())
