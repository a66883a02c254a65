"""Streaming workload traces: timestamped insert/delete/search streams (the
counterpart of the JAX package's ``vdms/workload.py``; the trace generation
is its numpy code, so one seed gives the same arrays).

A :class:`WorkloadTrace` is the replayable unit: a pre-replay corpus plus an
operation stream with configurable arrival mixes and a *drift schedule* — a
map from normalized time to a blend weight that moves the distribution of
inserted vectors (and queries) from the base dataset toward a drift target
(by default a different Table-III-style generator, the hardest kind of shift
for a tuned index configuration).

:func:`replay_trace` drives a :class:`~repro_torch.vdms.engine.LiveVDMS` through a
trace — growing-tail appends, seal-and-index events, tombstone deletes with
compaction — and scores recall against *time-aware* ground truth: the exact
top-k over the vectors visible (inserted and not deleted) at each query's
timestamp, computed by :func:`time_aware_ground_truth`.

:func:`replay_query_streams` is the serving-side driver: many concurrent
query streams with Poisson arrivals (:func:`poisson_arrivals`) offered at a
target aggregate rate against any engine exposing the ``search(queries,
topk, mode) -> (ids, elapsed)`` contract (``LiveVDMS``) —
arrivals queue, dispatch in engine-batch-sized multi-stream micro-batches,
and every query is charged its full sojourn (queue wait + service), which is
what makes saturation visible: offered rates above capacity show up as
unbounded sojourn growth, not as a flattering served-QPS number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import topk_stable
from .datasets import blend_vectors, default_dim, raw_vectors, recall_at_k_masked
from .engine import LiveVDMS

OP_INSERT, OP_SEARCH, OP_DELETE = 0, 1, 2

#: Named drift schedules: normalized time in [0, 1] -> blend weight in [0, 1].
DRIFT_SCHEDULES: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "none": lambda t: np.zeros_like(t),
    "ramp": lambda t: t,
    "step": lambda t: (t >= 0.5).astype(np.float64),
    "sine": lambda t: 0.5 - 0.5 * np.cos(2.0 * np.pi * t),
}


@dataclasses.dataclass(frozen=True)
class WorkloadTrace:
    """A replayable operation stream over a live VDMS.

    Global vector ids are assignment-ordered: the pre-replay corpus occupies
    ``0..n_base-1`` and the j-th insert op creates id ``n_base + j``.
    ``payload[i]`` is the row of :attr:`inserts` / :attr:`queries` for
    insert/search ops, and the victim *global id* for delete ops.
    """

    name: str
    dim: int
    k: int
    base: np.ndarray  # (n_base, d) float32, L2-normalized
    kinds: np.ndarray  # (n_ops,) int8 in {OP_INSERT, OP_SEARCH, OP_DELETE}
    payload: np.ndarray  # (n_ops,) int32
    times: np.ndarray  # (n_ops,) float64, nondecreasing, normalized to [0, 1]
    inserts: np.ndarray  # (n_inserts, d) float32, L2-normalized
    queries: np.ndarray  # (n_searches, d) float32, L2-normalized

    @property
    def n_base(self) -> int:
        return self.base.shape[0]

    @property
    def n_ops(self) -> int:
        return self.kinds.shape[0]

    @property
    def n_inserts(self) -> int:
        return self.inserts.shape[0]

    @property
    def n_searches(self) -> int:
        return self.queries.shape[0]

    @property
    def capacity(self) -> int:
        return self.n_base + self.n_inserts

    # ------------------------------------------------------------------
    def all_vectors(self) -> np.ndarray:
        """(capacity, d) vectors in global-id order."""
        return np.concatenate([self.base, self.inserts], axis=0)

    def window(self, lo: int, hi: int) -> "WorkloadTrace":
        """The sub-trace covering ops ``[lo, hi)``: the prefix's inserts and
        deletes are folded into the new base corpus (global ids re-assigned
        densely), so replaying the window starts from exactly the visible
        state at op ``lo``."""
        if not 0 <= lo <= hi <= self.n_ops:
            raise ValueError(f"bad window [{lo}, {hi}) for {self.n_ops} ops")
        all_vec = self.all_vectors()
        dead = np.zeros(self.capacity, dtype=bool)
        n_vis = self.n_base
        for i in range(lo):
            if self.kinds[i] == OP_INSERT:
                n_vis += 1
            elif self.kinds[i] == OP_DELETE:
                dead[self.payload[i]] = True
        vis_ids = np.flatnonzero(~dead[:n_vis])
        new_gid = np.full(self.capacity, -1, np.int64)
        new_gid[vis_ids] = np.arange(vis_ids.size)
        n_base2 = vis_ids.size

        kinds2, payload2, times2 = [], [], []
        ins_rows: List[int] = []
        q_rows: List[int] = []
        for i in range(lo, hi):
            kind = int(self.kinds[i])
            p = int(self.payload[i])
            if kind == OP_INSERT:
                # insert op number within the full trace is recoverable from
                # its global id; here we only need the source row order
                new_gid[self.n_base + p] = n_base2 + len(ins_rows)
                payload2.append(len(ins_rows))
                ins_rows.append(p)
            elif kind == OP_SEARCH:
                payload2.append(len(q_rows))
                q_rows.append(p)
            else:
                mapped = int(new_gid[p])
                if mapped < 0:  # victim already gone before the window
                    continue
                payload2.append(mapped)
            kinds2.append(kind)
            times2.append(float(self.times[i]))
        return WorkloadTrace(
            name=f"{self.name}[{lo}:{hi}]",
            dim=self.dim,
            k=self.k,
            base=all_vec[vis_ids],
            kinds=np.asarray(kinds2, np.int8),
            payload=np.asarray(payload2, np.int32),
            times=np.asarray(times2, np.float64),
            inserts=self.inserts[ins_rows] if ins_rows else np.empty((0, self.dim), np.float32),
            queries=self.queries[q_rows] if q_rows else np.empty((0, self.dim), np.float32),
        )

    def split(self, n_phases: int) -> List["WorkloadTrace"]:
        """Equal-op-count phase windows (the drifting workload's time axis)."""
        if n_phases < 1:
            raise ValueError("n_phases must be >= 1")
        bounds = np.linspace(0, self.n_ops, n_phases + 1).astype(int)
        return [self.window(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------
def _norm_mix(mix, label: str) -> np.ndarray:
    arr = np.asarray(mix, np.float64)
    if arr.shape != (3,) or (arr < 0).any() or arr.sum() <= 0:
        raise ValueError(f"{label} must be 3 nonnegative weights, got {mix!r}")
    return arr / arr.sum()


def make_trace(
    name: str,
    n_base: int = 4096,
    n_ops: int = 1024,
    mix: Tuple[float, float, float] = (0.25, 0.70, 0.05),
    drift: str = "none",
    drift_to: Optional[str] = None,
    mix_to: Optional[Tuple[float, float, float]] = None,
    k: int = 10,
    dim: Optional[int] = None,
    seed: int = 0,
) -> WorkloadTrace:
    """Generate a streaming trace over a Table-III-style dataset.

    ``mix`` is the (insert, search, delete) arrival mix; op kinds are drawn
    iid and timestamps from a Poisson-like arrival process (normalized to
    [0, 1]). ``drift`` names a :data:`DRIFT_SCHEDULES` entry driving two
    drift axes with the schedule's weight at each op's timestamp:

    * *distribution* drift — inserted vectors and queries blend toward
      ``drift_to`` (default: a different generator family, the shift that
      moves which index parameters work);
    * *arrival-mix* drift — with ``mix_to`` given, the op-kind probabilities
      interpolate from ``mix`` to ``mix_to`` (e.g. search-heavy to
      insert-heavy: the insert-pressure shift that moves the seal-policy /
      graceful-window optimum, paper Fig. 1–2).
    """
    if drift not in DRIFT_SCHEDULES:
        raise ValueError(f"unknown drift {drift!r}; choose from {sorted(DRIFT_SCHEDULES)}")
    mix_arr = _norm_mix(mix, "mix")
    mix_to_arr = _norm_mix(mix_to, "mix_to") if mix_to is not None else mix_arr
    if n_base < 1:
        raise ValueError("n_base must be >= 1 (deletes need a victim pool)")
    rng = np.random.default_rng(seed)
    dim = dim or default_dim(name)
    if drift_to is None:
        drift_to = "keyword_like" if name != "keyword_like" else "glove_like"
    schedule = DRIFT_SCHEDULES[drift]

    gaps = rng.exponential(1.0, size=n_ops)
    times = np.cumsum(gaps)
    times = times / times[-1] if n_ops else times
    w_ops = schedule(times)[:, None]
    p = (1.0 - w_ops) * mix_arr[None, :] + w_ops * mix_to_arr[None, :]
    u = rng.random(n_ops)
    kinds = np.where(u < p[:, 0], OP_INSERT, np.where(u < p[:, 0] + p[:, 1], OP_SEARCH, OP_DELETE)).astype(np.int8)

    base = blend_vectors(raw_vectors(name, rng, n_base, dim), np.zeros((n_base, dim)), np.zeros(n_base))

    ins_idx = np.flatnonzero(kinds == OP_INSERT)
    q_idx = np.flatnonzero(kinds == OP_SEARCH)
    n_ins, n_q = ins_idx.size, q_idx.size
    a_ins = raw_vectors(name, rng, n_ins, dim) if n_ins else np.empty((0, dim))
    b_ins = raw_vectors(drift_to, rng, n_ins, dim) if n_ins else np.empty((0, dim))
    a_q = raw_vectors(name, rng, n_q, dim) if n_q else np.empty((0, dim))
    b_q = raw_vectors(drift_to, rng, n_q, dim) if n_q else np.empty((0, dim))
    inserts = (blend_vectors(a_ins, b_ins, schedule(times[ins_idx])) if n_ins else np.empty((0, dim), np.float32))
    queries = (blend_vectors(a_q, b_q, schedule(times[q_idx])) if n_q else np.empty((0, dim), np.float32))

    # payloads: sequential rows for inserts/searches; sampled victims for
    # deletes (uniform over the currently-alive ids, never repeated)
    payload = np.zeros(n_ops, np.int32)
    payload[ins_idx] = np.arange(n_ins, dtype=np.int32)
    payload[q_idx] = np.arange(n_q, dtype=np.int32)
    alive: List[int] = list(range(n_base))
    n_inserted = 0
    dropped: List[int] = []
    for i in np.flatnonzero(kinds != OP_SEARCH):
        if kinds[i] == OP_INSERT:
            alive.append(n_base + n_inserted)
            n_inserted += 1
        elif alive:
            j = int(rng.integers(len(alive)))
            payload[i] = alive.pop(j)
        else:  # victim pool exhausted under a delete-heavy mix: drop the op
            dropped.append(int(i))
    if dropped:
        keep = np.ones(n_ops, dtype=bool)
        keep[dropped] = False
        kinds, payload, times = kinds[keep], payload[keep], times[keep]
    return WorkloadTrace(
        name=f"{name}/{drift}->{drift_to}",
        dim=dim,
        k=k,
        base=base,
        kinds=kinds,
        payload=payload,
        times=times,
        inserts=inserts,
        queries=queries,
    )


# ---------------------------------------------------------------------------
# time-aware ground truth
# ---------------------------------------------------------------------------
def time_aware_ground_truth(trace: WorkloadTrace, k: Optional[int] = None,
                            device=None) -> np.ndarray:
    """Exact top-k for every search op over the vectors *visible at its
    timestamp*: inserted before it and not yet deleted. Rows are ordered by
    search op (aligned with ``trace.queries``); short visible sets pad with
    -1. The oracle the engine's bounded-consistency searches are scored
    against. The scores are one matrix product on ``device`` (the GPU
    unless the caller passes ``device="cpu"``) per run of searches, equal
    scores keeping the lowest id.
    """
    k = k or trace.k
    dev = resolve_device(device)
    all_vec = torch.from_numpy(trace.all_vectors()).to(dev)
    dead = torch.zeros(trace.capacity, dtype=torch.bool, device=dev)
    n_vis, n_dead = trace.n_base, 0
    out = -np.ones((trace.n_searches, k), np.int32)
    pending: List[int] = []  # search payload rows awaiting the current state

    def flush():
        if not pending:
            return
        k_eff = min(k, n_vis - n_dead)
        rows = np.asarray(pending, np.int64)
        pending.clear()
        if k_eff <= 0:
            return
        step = max(1, (1 << 26) // n_vis)  # bounds the (rows, n_vis) score block
        for lo in range(0, rows.size, step):
            r = rows[lo : lo + step]
            q = torch.from_numpy(trace.queries[r]).to(dev)
            sims = (q @ all_vec[:n_vis].T).masked_fill(dead[:n_vis], float("-inf"))
            out[r, :k_eff] = topk_stable(sims, k_eff)[1].cpu().numpy()

    for i in range(trace.n_ops):
        kind = int(trace.kinds[i])
        if kind == OP_SEARCH:
            pending.append(int(trace.payload[i]))
            continue
        flush()
        if kind == OP_INSERT:
            n_vis += 1
        else:
            dead[int(trace.payload[i])] = True
            n_dead += 1
    flush()
    return out


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------
def replay_trace(
    trace: WorkloadTrace,
    config: Dict[str, Any],
    seed: int = 0,
    mode: str = "analytic",
    topk: Optional[int] = None,
    ground_truth: Optional[np.ndarray] = None,
    compact_threshold: float = 0.3,
    with_live: bool = False,
    search_hooks: Sequence[Callable] = (),
    device=None,
    draws=None,
    fault_injector=None,
):
    """Replay a trace under one configuration on ``device`` (the GPU unless
    the caller passes ``device="cpu"``) and measure the paper's objectives
    in the streaming regime.

    Returns a flat float dict (an ``EvalBackend`` raw result): ``speed`` is
    search throughput (consecutive searches are micro-batched,
    insert/delete barriers respected), ``recall`` is time-aware recall@k
    against :func:`time_aware_ground_truth`, ``mem_gib`` is the peak
    footprint, ``lat_p50_s``/``lat_p95_s``/``lat_p99_s`` are per-query
    latency percentiles over the whole replay, and the ingest side reports
    ``seal_build_s`` (incremental seal + compaction builds), ``n_seals`` and
    ``n_compactions``; ``upload_s`` is the time the searches spent uploading
    the alive mask and the visible tail (not in ``search_s``).
    ``search_hooks`` are attached to the live instance's per-search
    instrumentation (``fn(n_queries, latencies, elapsed)``). ``draws`` is
    the class of the build draws (default ``BuildDraws``). With
    ``with_live=True`` also returns the finished :class:`LiveVDMS` as a
    second value. ``fault_injector`` arms a
    :class:`~repro_torch.vdms.faults.FaultInjector` on the live instance
    *after* bootstrap (the fault clock ticks over replayed ops, not bulk-load
    inserts); the result then also reports ``coverage_min``,
    ``n_quarantines`` and ``n_rebuilds``, keys absent without an injector.
    """
    device = resolve_device(device)
    k = topk or trace.k
    gt = ground_truth if ground_truth is not None else time_aware_ground_truth(trace, k, device)
    live = LiveVDMS(config, trace.dim, trace.capacity, seed=seed,
                    compact_threshold=compact_threshold, device=device, draws=draws)
    live.search_hooks.extend(search_hooks)
    live.bootstrap(trace.base)
    if fault_injector is not None:
        live.arm_faults(fault_injector)
    coverage_min = 1.0
    preds = -np.ones((trace.n_searches, k), np.int32)
    lat_all: List[np.ndarray] = []
    search_s = 0.0
    peak_mem = live.memory_gib()
    pending: List[int] = []

    def flush():
        nonlocal search_s, coverage_min
        if not pending:
            return
        rows = np.asarray(pending, np.int64)
        ids, secs = live.search(trace.queries[rows], k, mode=mode)
        preds[rows] = ids
        lat_all.append(live.last_latencies)
        search_s += secs
        coverage_min = min(coverage_min, live.last_coverage)
        pending.clear()

    for i in range(trace.n_ops):
        kind = int(trace.kinds[i])
        if kind == OP_SEARCH:
            pending.append(int(trace.payload[i]))
            continue
        flush()
        if kind == OP_INSERT:
            live.insert(trace.inserts[trace.payload[i]])
        else:
            live.delete(int(trace.payload[i]))
        peak_mem = max(peak_mem, live.memory_gib())
    flush()
    peak_mem = max(peak_mem, live.memory_gib())

    n_searches = trace.n_searches
    stats = live.stats()
    lats = np.concatenate(lat_all) if lat_all else np.empty(0, np.float64)
    p50, p95, p99 = (
        np.percentile(lats, (50.0, 95.0, 99.0)) if lats.size else (0.0, 0.0, 0.0)
    )
    # analytic mode charges the deterministic build model for ingest overhead
    # (wall-clock build noise would leak into the tuning objective otherwise)
    seal_build = stats["seal_build_model_s"] if mode == "analytic" else stats["seal_build_s"]
    result = {
        "speed": float(n_searches / max(search_s, 1e-9)),
        "recall": float(recall_at_k_masked(preds[:, : trace.k], gt[:, : trace.k])),
        "mem_gib": float(peak_mem),
        "build_time": float(stats["build_time"]),
        "compile_time": float(stats["compile_s"]),
        "seal_build_s": float(seal_build),
        "search_s": float(search_s),
        "n_searches": float(n_searches),
        "n_seals": float(stats["n_seals"]),
        "n_compactions": float(stats["n_compactions"]),
        "tombstone_fraction": float(stats["tombstone_fraction"]),
        "lat_p50_s": float(p50),
        "lat_p95_s": float(p95),
        "lat_p99_s": float(p99),
        "upload_s": float(stats["upload_s"]),
    }
    if fault_injector is not None:
        result["coverage_min"] = float(coverage_min)
        result["n_quarantines"] = float(stats["n_quarantines"])
        result["n_rebuilds"] = float(stats["n_rebuilds"])
    return (result, live) if with_live else result


# ---------------------------------------------------------------------------
# high-rate multi-stream Poisson serving driver
# ---------------------------------------------------------------------------
def poisson_arrivals(
    rate: float, n: int, seed: int = 0, t0: float = 0.0
) -> np.ndarray:
    """Arrival timestamps of a Poisson process: ``n`` events at ``rate``
    events/second starting after ``t0`` (exponential i.i.d. gaps)."""
    if rate <= 0.0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    return t0 + np.cumsum(rng.exponential(1.0 / rate, size=int(n)))


def make_query_streams(
    queries: np.ndarray,
    n_streams: int,
    rate: float,
    n_per_stream: int,
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_streams`` independent Poisson query streams at ``rate / n_streams``
    each (their superposition is Poisson at the aggregate ``rate``). Each
    stream cycles through its round-robin slice of ``queries``. Returns
    ``[(arrival_times, query_row_indices), ...]`` per stream."""
    if n_streams < 1:
        raise ValueError(f"n_streams must be >= 1, got {n_streams}")
    nq = queries.shape[0]
    streams = []
    for s in range(n_streams):
        times = poisson_arrivals(rate / n_streams, n_per_stream, seed=seed * 1000 + s)
        rows = (s + np.arange(n_per_stream, dtype=np.int64) * n_streams) % nq
        streams.append((times, rows.astype(np.int32)))
    return streams


def replay_query_streams(
    engine,
    queries: np.ndarray,
    *,
    rate: float,
    n_streams: int = 8,
    n_per_stream: int = 64,
    topk: int = 10,
    mode: str = "analytic",
    seed: int = 0,
) -> Dict[str, float]:
    """Offer multi-stream Poisson load to an engine and measure sustained
    serving behavior.

    The merged arrival sequence drains through a single batching server:
    when the engine frees up, every queued arrival (capped at the engine's
    ``search_batch_size``) dispatches as ONE multi-stream micro-batch —
    padded to the full batch width so the compiled chunk shape never churns,
    exactly the shape the engine would serve in production. Service time is
    the engine's measured ``elapsed`` (deterministic under
    ``mode="analytic"``); each query's latency is its full sojourn
    (queue wait + service).

    Returns offered vs served QPS, sojourn percentiles, utilization, and a
    ``saturated`` flag (mean sojourn of the last quarter more than 4x the
    first quarter — the queue is growing without bound).
    """
    queries = np.asarray(queries, np.float32)
    streams = make_query_streams(queries, n_streams, rate, n_per_stream, seed=seed)
    arr = np.concatenate([t for t, _ in streams])
    rows = np.concatenate([r for _, r in streams])
    stream_of = np.concatenate(
        [np.full(t.size, s, np.int32) for s, (t, _) in enumerate(streams)]
    )
    order = np.argsort(arr, kind="stable")
    arr, rows, stream_of = arr[order], rows[order], stream_of[order]
    n = arr.size
    batch = int(getattr(engine, "batch", 32))
    sojourn = np.zeros(n, np.float64)
    t_free = 0.0
    busy = 0.0
    n_batches = 0
    i = 0
    while i < n:
        start = max(t_free, float(arr[i]))
        j = i + 1
        while j < n and arr[j] <= start and j - i < batch:
            j += 1
        idx = np.arange(i, j)
        qrows = queries[rows[idx]]
        if qrows.shape[0] < batch:  # pad to the production chunk shape
            wrap = np.tile(qrows, (-(-batch // qrows.shape[0]), 1))[:batch]
            qrows = wrap
        _, service = engine.search(qrows, topk, mode=mode)
        done = start + service
        sojourn[idx] = done - arr[idx]
        t_free = done
        busy += service
        n_batches += 1
        i = j
    makespan = max(t_free - float(arr[0]), 1e-9)
    q1 = sojourn[: max(n // 4, 1)].mean()
    q4 = sojourn[-max(n // 4, 1) :].mean()
    per_stream = np.bincount(stream_of, minlength=n_streams)
    return {
        "offered_qps": float(rate),
        "served_qps": float(n / makespan),
        "n_queries": float(n),
        "n_streams": float(n_streams),
        "n_batches": float(n_batches),
        "mean_batch_occupancy": float(n / max(n_batches, 1)),
        "utilization": float(busy / makespan),
        "sojourn_p50_s": float(np.percentile(sojourn, 50.0)),
        "sojourn_p95_s": float(np.percentile(sojourn, 95.0)),
        "sojourn_p99_s": float(np.percentile(sojourn, 99.0)),
        "saturated": float(q4 > 4.0 * max(q1, 1e-9)),
        "min_stream_queries": float(per_stream.min()),
    }
