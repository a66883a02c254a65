"""VDMS query engine of the port (the counterpart of the JAX package's
``vdms/engine.py``): a configured static instance (``VDMSInstance``), a live
streaming instance (``LiveVDMS``) and the batched measurement of
same-signature instances (``measure_batch``), each measuring the paper's
objectives (search speed as QPS, recall@K, memory footprint).

Two measurement modes:
* ``wall``     — wall-clock over the search pipeline on the instance's
                 device, each run ended by a device synchronize. The first
                 search (which builds the CUDA kernels on first use) is
                 timed apart as ``compile_time``.
* ``analytic`` — the deterministic cost model, the same arithmetic as the
                 JAX package (recall is still measured by running the
                 search).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, sync
from ..kernels.ref import topk_stable
from .datasets import VectorDataset, recall_at_k
from .draws import BuildDraws
from .faults import HEALTH_CODE, BuildCrashFault, FaultInjector, TransientEngineFault
from .indexes import (IndexBundle, build_index, concat_bundles, frozen_state, replace_segment,
                      search_index)
from .merge import merge_topk
from .registry import get_family
from .segments import live_seg_size, plan_segments, stack_sealed

# analytic-mode calibration constants (documented, deterministic)
_FLOPS_RATE = 5.0e9  # effective CPU distance-eval rate (FLOP/s)
_CHUNK_OVERHEAD = 2.0e-4  # dispatch overhead per query chunk (s)
_SEG_OVERHEAD = 5.0e-5  # per-segment merge overhead per chunk (s)
_STEP_OVERHEAD = 6.0e-6  # per sequential graph-walk step (s)


def analytic_chunk_seconds(
    kind: str,
    st: Dict[str, Any],
    arrays: Dict[str, Any],
    n_sealed: int,
    seg_size: int,
    growing_searched: int,
    dim: int,
    batch: int,
) -> float:
    """Deterministic cost (seconds) of one query chunk. The per-family FLOP
    count comes from the registered family's ``chunk_cost`` hook (families
    without one are charged an exhaustive-scan estimate)."""
    d, b = dim, batch
    family = get_family(kind)
    if family.chunk_cost is not None:
        flops, steps = family.chunk_cost(st, arrays, n_sealed, seg_size, d)
    else:  # conservative default: brute-force scan of every sealed vector
        flops, steps = n_sealed * seg_size * d * 2, 0
    flops += growing_searched * d * 2  # growing-tail brute force
    flops *= b  # per chunk of b queries
    return (
        flops / _FLOPS_RATE
        + _CHUNK_OVERHEAD
        + n_sealed * _SEG_OVERHEAD
        + steps * _STEP_OVERHEAD
    )


# analytic index-build cost model (deterministic, like the search model)
_BUILD_RATE = 2.0e10  # effective build FLOP/s (batched kmeans / graph matmuls)
_BUILD_OVERHEAD = 5.0e-3  # per-build dispatch + allocation overhead (s)


def analytic_build_seconds(
    index_type: str, config: Dict[str, Any], seg_size: int, dim: int, first_build: bool
) -> float:
    """Deterministic cost (seconds) of sealing + indexing one segment;
    ``first_build`` additionally charges the one-off shared-calibration
    training (PQ codebooks)."""
    s, d = int(seg_size), int(dim)
    family = get_family(index_type)
    flops = float(s * d)  # storage pass
    if family.build_cost is not None:
        flops += family.build_cost(config, s, d, bool(first_build))
    return flops / _BUILD_RATE + _BUILD_OVERHEAD


# ---------------------------------------------------------------------------
# search-pipeline mode (fused vs composed)
# ---------------------------------------------------------------------------
_SEARCH_PIPELINE = "fused"


def set_search_pipeline(mode: str) -> None:
    """Select the search hot path: ``"fused"`` (default) routes a search
    through a family's registered ``fused_search`` hook when it has one,
    ``"composed"`` always runs the per-family ``search`` + generic merge.
    Families without a hook run composed either way."""
    global _SEARCH_PIPELINE
    if mode not in ("fused", "composed"):
        raise ValueError(f"unknown search pipeline {mode!r}; use 'fused' or 'composed'")
    _SEARCH_PIPELINE = mode


def get_search_pipeline() -> str:
    return _SEARCH_PIPELINE


def _pipeline(qc, arrays, growing, growing_gids, kind, statics, k_seg, topk, fused=False,
              clamp=False):
    """qc: (n_chunks, B, d) queries -> (n_chunks, B, topk) global ids.

    ``fused=True`` dispatches through the family's ``fused_search`` hook
    (every chunk flattened into one call); families without a hook, and
    segment-less instances, run the composed path one chunk at a time.
    ``clamp=True`` (set only when no sealed slot is padding) lets the hook
    narrow the per-segment width to ``min(k_seg, topk)``.
    """
    family = get_family(kind)
    if fused and family.fused_search is not None and arrays["gids"].shape[0] > 0:
        n_chunks, b, d = qc.shape
        out = family.fused_search(
            qc.reshape(n_chunks * b, d), arrays, growing, growing_gids,
            k_seg=k_seg, topk=topk, clamp=clamp, **statics,
        )
        return out.reshape(n_chunks, b, topk)
    bundle = IndexBundle(kind=kind, arrays=arrays, static=dict(statics))
    outs = []
    for q in qc:
        ids, sims = search_index(bundle, q, k_seg)  # (n_seg, B, k_seg)
        outs.append(merge_topk(ids, sims, q, growing, growing_gids, topk))
    return torch.stack(outs)


class VDMSInstance:
    """A built VDMS under one configuration, on one device.

    ``device`` defaults to the GPU (and raises without one); the tests pass
    ``device="cpu"``. ``bundle`` skips the build and serves a prebuilt
    :class:`IndexBundle` (for example one carried across from the JAX
    package with ``bundle_from_numpy``) over the same segment plan.
    ``draws`` is the class whose ``draws(seed, device)`` instance supplies
    the build's random draws (default :class:`~.draws.BuildDraws`).
    """

    def __init__(self, dataset: VectorDataset, config: Dict[str, Any], seed: int = 0,
                 device=None, bundle: Optional[IndexBundle] = None, draws=None):
        self.dataset = dataset
        self.config = dict(config)
        self.device = dev = resolve_device(device)
        t0 = time.perf_counter()
        self.plan = plan_segments(
            dataset.n,
            int(config["segment_max_size"]),
            float(config["seal_proportion"]),
            float(config["graceful_time"]),
        )
        if bundle is None:
            segs, gids = stack_sealed(dataset.data, self.plan)
            source = (draws or BuildDraws)(seed, dev)
            sys = {
                "kmeans_iters": int(config["kmeans_iters"]),
                "storage_bf16": bool(config["storage_bf16"]),
            }
            bundle = build_index(source, torch.from_numpy(segs).to(dev),
                                 torch.from_numpy(gids).to(dev), config["index_type"], config, sys)
        self.bundle = bundle
        g0 = self.plan.growing_start
        g_searched = self.plan.growing_searched
        self.growing = torch.from_numpy(dataset.data[g0 : g0 + g_searched]).to(dev)
        self.growing_gids = torch.arange(g0, g0 + g_searched, dtype=torch.int32, device=dev)
        sync(dev)
        self.build_time = time.perf_counter() - t0
        self.k_seg = int(config["topk_merge_width"])
        self.batch = int(config["search_batch_size"])
        # the fused top-k clamp is exact only when every sealed slot is real:
        # a trailing partial seal pads with -1 gids, whose dead slots must
        # keep consuming merge width to match the composed path
        self._clamp_ok = bool(np.all(np.asarray(self.plan.sealed_valid) == self.plan.seg_size))

    # ------------------------------------------------------------------
    def _chunked_queries(self, queries: np.ndarray) -> torch.Tensor:
        q, d = queries.shape
        b = min(self.batch, q)
        n_chunks = (q + b - 1) // b
        pad = n_chunks * b - q
        if pad:
            queries = np.concatenate([queries, queries[:pad]], axis=0)
        return torch.from_numpy(np.ascontiguousarray(queries.reshape(n_chunks, b, d))).to(
            self.device)

    def _run(self, qc: torch.Tensor, topk: int) -> torch.Tensor:
        return _pipeline(
            qc,
            self.bundle.arrays,
            self.growing,
            self.growing_gids,
            self.bundle.kind,
            self.bundle.static,
            self.k_seg,
            topk,
            get_search_pipeline() == "fused",
            self._clamp_ok,
        )

    def search(self, queries: np.ndarray, topk: int) -> np.ndarray:
        out = self._run(self._chunked_queries(queries), topk)
        return out.reshape(-1, topk)[: queries.shape[0]].cpu().numpy()

    def memory_gib(self) -> float:
        b = self.bundle.memory_bytes() + self.growing.numel() * self.growing.element_size()
        return b / (1024.0**3)

    # --- analytic cost model ------------------------------------------
    def _analytic_seconds_per_chunk(self) -> float:
        return analytic_chunk_seconds(
            self.bundle.kind,
            self.bundle.static,
            self.bundle.arrays,
            self.plan.n_sealed,
            self.plan.seg_size,
            self.plan.growing_searched,
            self.dataset.dim,
            self.batch,
        )

    # ------------------------------------------------------------------
    def measure(
        self, topk: int | None = None, repeats: int = 3, mode: str = "wall"
    ) -> Dict[str, float]:
        ds = self.dataset
        topk = topk or ds.k
        queries = ds.queries
        # one measured-apart warmup run -> first-call time + recall
        t0 = time.perf_counter()
        ids = self.search(queries, topk)
        compile_time = time.perf_counter() - t0
        recall = recall_at_k(ids[:, : ds.k], ds.ground_truth)
        n_chunks = (queries.shape[0] + self.batch - 1) // self.batch
        if mode == "analytic":
            elapsed = self._analytic_seconds_per_chunk() * n_chunks
        else:
            qc = self._chunked_queries(queries)
            times = []
            for _ in range(repeats):
                sync(self.device)
                t0 = time.perf_counter()
                self._run(qc, topk)
                sync(self.device)
                times.append(time.perf_counter() - t0)
            elapsed = min(times)
        qps = queries.shape[0] / max(elapsed, 1e-9)
        return {
            "speed": float(qps),
            "recall": float(recall),
            "mem_gib": float(self.memory_gib()),
            "build_time": float(self.build_time),
            "compile_time": float(compile_time),
        }


# ---------------------------------------------------------------------------
# live (streaming) instance
# ---------------------------------------------------------------------------
def _live_chunk(q, arrays, alive_g, growing, growing_gids, kind, statics, k_seg, topk,
                fused=False):
    """One query chunk against the live state: sealed segments searched
    through their indexes, the visible growing tail brute-forced,
    tombstones and padded slots filtered through the global ``alive_g``
    mask at merge time (id -1 maps to the always-dead sentinel slot
    ``alive_g[-1]``). ``fused=True`` routes through the family's
    ``fused_search`` hook with ``alive=alive_g``; live searches never clamp,
    since compacted segments carry -1 padding that must take up width."""
    family = get_family(kind)
    if fused and family.fused_search is not None and arrays["gids"].shape[0] > 0:
        return family.fused_search(q, arrays, growing, growing_gids, k_seg=k_seg, topk=topk,
                                   clamp=False, alive=alive_g, **statics)
    bundle = IndexBundle(kind=kind, arrays=arrays, static=dict(statics))
    ids, sims = search_index(bundle, q, k_seg)  # (n_seg, B, k_seg)
    return merge_topk(ids, sims, q, growing, growing_gids, topk, alive=alive_g)


def _live_chunk_unsealed(q, growing, growing_gids, topk):
    """Chunk search before the first seal: brute force over the visible tail."""
    gs = (q @ growing.T.to(q.dtype)).masked_fill(growing_gids[None, :] < 0, float("-inf"))
    k = min(topk, growing.shape[0])
    top_s, top_i = topk_stable(gs, k)
    out = growing_gids[top_i].masked_fill(~torch.isfinite(top_s), -1)
    if k < topk:
        out = torch.nn.functional.pad(out, (0, topk - k), value=-1)
    return out


def _bucket(n: int) -> int:
    """Pad count for the visible growing tail: next power of two >= n (min
    64), so tail churn changes the chunk's shapes only O(log) times."""
    if n <= 0:
        return 0
    b = 64
    while b < n:
        b *= 2
    return b


class LiveVDMS:
    """A *live* VDMS instance: bulk-loaded once, then ingesting inserts and
    deletes while serving searches, the streaming regime the paper's system
    parameters exist for.

    Lifecycle (Milvus-like):

    * inserts append to the growing tail; when the tail reaches the seal
      size ``ceil(seal_proportion * segment_max_size)`` it is sealed into a
      fixed-shape segment and indexed *incrementally* (one per-segment build
      keyed by ``salt = n_seals + n_compactions``; SQ8/SCANN scales and PQ
      codebooks are frozen after the first build);
    * deletes tombstone ids anywhere; a sealed segment whose dead fraction
      crosses ``compact_threshold`` is compacted: rebuilt in place from its
      survivors with ``-1``-id padding;
    * ``graceful_time`` is the bounded-consistency window over the *current*
      tail: each search scans only the oldest ``(1 - graceful_time)``
      fraction of the growing tail, so the freshest inserts may be
      invisible (fast but stale).

    The sealed segments live on ``device`` as one bundle: a seal
    concatenates the new segment onto it (``concat_bundles``, a copy of the
    whole stack, charged to ``build_time`` / ``seal_build_s``) and a
    compaction splices one in (``replace_segment``). Every search uploads the
    ``capacity + 1`` alive mask and the padded visible tail, timed in
    ``upload_s`` (apart from the search's own time, as in the JAX package).

    Fault injection (``arm_faults``) drives a fault clock that ticks once
    per ``insert``, ``delete`` and ``search``: a lost or corrupt sealed
    segment is quarantined (searches serve the rest, with its rows cleared
    from the uploaded alive mask, and report ``last_coverage``) and rebuilt
    from the vector store with the same draws, bit for bit; a crashed seal
    retries with backoff. Every branch is gated on ``self._faults is not
    None``, so an unarmed engine behaves as if faults did not exist.
    """

    def __init__(self, config: Dict[str, Any], dim: int, capacity: int, seed: int = 0,
                 compact_threshold: float = 0.3, device=None, draws=None):
        self.config = dict(config)
        # resolve the family up front: unknown types and non-incremental
        # families fail at creation
        self._family = get_family(config["index_type"])
        if not self._family.supports_incremental:
            raise ValueError(
                f"index family {self._family.name!r} does not support "
                "incremental (streaming) builds"
            )
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.seed = int(seed)
        self.compact_threshold = float(compact_threshold)
        self.seg_size = live_seg_size(
            int(config["segment_max_size"]), float(config["seal_proportion"])
        )
        self.graceful = float(np.clip(float(config["graceful_time"]), 0.0, 1.0))
        self.k_seg = int(config["topk_merge_width"])
        self.batch = int(config["search_batch_size"])
        self._sys = {
            "kmeans_iters": int(config["kmeans_iters"]),
            "storage_bf16": bool(config["storage_bf16"]),
        }
        self._draws = (draws or BuildDraws)(seed, self.device)
        self.store = np.zeros((self.capacity, self.dim), np.float32)
        # +1 sentinel slot (always dead): the merge maps id -1 there
        self.alive = np.zeros(self.capacity + 1, dtype=bool)
        self.gid_seg = np.full(self.capacity, -1, np.int32)  # gid -> sealed segment
        self.n_total = 0
        self.tail: List[int] = []
        self.bundle: Optional[IndexBundle] = None
        self.seg_gids: List[np.ndarray] = []
        self._frozen: Optional[Dict[str, torch.Tensor]] = None
        # lifecycle diagnostics
        self.build_time = 0.0  # bootstrap (bulk-load) build seconds
        self.bootstrap_build_model_s = 0.0  # bootstrap builds, analytic model
        self.seal_build_s = 0.0  # incremental seal + compaction builds (wall)
        self.seal_build_model_s = 0.0  # same, under the analytic build model
        self.n_seals = 0
        self.n_compactions = 0
        self.n_deletes = 0
        self.seal_history: List[int] = []  # n_sealed after every lifecycle event
        self._warmed: set = set()  # (n_sealed, bucket, b, topk, fused) shapes already run
        self.compile_s = 0.0  # wall-mode warm-up seconds, kept apart
        self.upload_s = 0.0  # alive mask + visible tail uploads, every search
        # search instrumentation: per-query latencies of the last search call
        # (a query is charged its chunk's elapsed / chunk width) plus hooks
        # ``fn(n_queries, latencies, elapsed)``
        self.queries_served = 0
        self.last_latencies: np.ndarray = np.empty(0, np.float64)
        self.search_hooks: List[Callable[[int, np.ndarray, float], None]] = []
        # fault injection and degraded mode, inert until ``arm_faults``
        self._faults: Optional[FaultInjector] = None
        # sealed segment -> repair state while quarantined
        self.quarantined: Dict[int, Dict[str, Any]] = {}
        # per-sealed-segment build provenance ({"salt", "first"}): a
        # quarantined segment's rebuild replays the same draws and the same
        # frozen-calibration choice, so it rebuilds bit for bit
        self._seg_meta: List[Dict[str, Any]] = []
        self._pending_seal: Optional[Dict[str, int]] = None  # crashed-seal backoff
        self.last_coverage = 1.0  # visible fraction served by the last search
        self.n_quarantines = 0
        self.n_rebuilds = 0
        self.n_rebuild_failures = 0  # rebuilds whose retry budget ran out
        self.n_seal_retries = 0  # crashed incremental builds (seal / compaction)

    # --- state views ---------------------------------------------------
    @property
    def n_sealed(self) -> int:
        return len(self.seg_gids)

    @property
    def n_alive(self) -> int:
        return int(self.alive[: self.capacity].sum())

    def visible_ids(self) -> np.ndarray:
        """Sorted global ids of every alive vector (sealed + whole tail)."""
        return np.flatnonzero(self.alive[: self.capacity]).astype(np.int32)

    def searchable_mask(self) -> np.ndarray:
        """``(capacity,)`` bool, True for the gids a search can return right
        now: alive, not in a quarantined segment, and not hidden behind the
        graceful-time consistency window (the visible set degraded-mode
        recall is scored against)."""
        mask = self.alive[: self.capacity].copy()
        m = int(np.ceil((1.0 - self.graceful) * len(self.tail)))
        hidden = np.asarray(self.tail[m:], np.int32)
        if hidden.size:
            mask[hidden] = False
        mask[self._quarantined_gids()] = False
        return mask

    def searchable_ids(self) -> np.ndarray:
        """Sorted gids of :meth:`searchable_mask`."""
        return np.flatnonzero(self.searchable_mask()).astype(np.int32)

    def memory_gib(self) -> float:
        b = len(self.tail) * self.dim * 4
        if self.bundle is not None:
            b += self.bundle.memory_bytes()
        return b / (1024.0**3)

    def stats(self) -> Dict[str, float]:
        """One structured snapshot of the lifecycle state, plain Python
        ints/floats (JSON-safe): the JAX package's keys, the fault and
        degraded-mode telemetry included (all zero while no plan was ever
        armed), plus ``upload_s``."""
        n_total = int(self.n_total)
        n_alive = self.n_alive
        return {
            "n_total": n_total,
            "n_alive": n_alive,
            "tombstone_fraction": float((n_total - n_alive) / max(n_total, 1)),
            "n_sealed": int(self.n_sealed),
            "tail_size": len(self.tail),
            "visible_tail": int(self._visible_tail().size),
            "n_seals": int(self.n_seals),
            "n_compactions": int(self.n_compactions),
            "n_deletes": int(self.n_deletes),
            "seal_build_s": float(self.seal_build_s),
            "seal_build_model_s": float(self.seal_build_model_s),
            "bootstrap_build_model_s": float(self.bootstrap_build_model_s),
            "build_time": float(self.build_time),
            "compile_s": float(self.compile_s),
            "upload_s": float(self.upload_s),
            "mem_gib": float(self.memory_gib()),
            "queries_served": int(self.queries_served),
            "coverage": float(self.last_coverage),
            "quarantined_segments": len(self.quarantined),
            "n_quarantines": int(self.n_quarantines),
            "n_rebuilds": int(self.n_rebuilds),
            "n_rebuild_failures": int(self.n_rebuild_failures),
            "n_seal_retries": int(self.n_seal_retries),
            "n_faults_injected": int(self._faults.n_injected if self._faults else 0),
            "health_code": HEALTH_CODE[self.health()],
        }

    # --- ingestion -----------------------------------------------------
    def bootstrap(self, base: np.ndarray) -> None:
        """Bulk-load the pre-replay corpus (sealing as segments fill); the
        time spent is the initial ``build_time``, not replay-time ingest
        overhead, so the seal counters reset afterwards."""
        if self._faults is not None:
            # a shadow-scoped injector fails its bootstrap ordinal (an
            # injected out-of-memory) before any vector lands
            self._faults.on_bootstrap(int(np.asarray(base).shape[0]))
        t0 = time.perf_counter()
        self.insert(base)
        self.build_time += time.perf_counter() - t0
        self.bootstrap_build_model_s += self.seal_build_model_s
        self.seal_build_s = 0.0
        self.seal_build_model_s = 0.0

    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Append vectors (d,) or (n, d); seals segments as the tail fills.
        Returns the assigned global ids."""
        if self._faults is not None:
            self._fault_tick()
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        n = vecs.shape[0]
        if self.n_total + n > self.capacity:
            raise ValueError(f"capacity exceeded: {self.n_total}+{n} > {self.capacity}")
        gids = np.arange(self.n_total, self.n_total + n, dtype=np.int32)
        self.store[gids] = vecs
        self.alive[gids] = True
        self.n_total += n
        self.tail.extend(gids.tolist())
        while len(self.tail) >= self.seg_size:
            if self._pending_seal is not None:
                break  # a crashed seal is backing off: the fault clock retries it
            if not self._try_seal():
                break
        return gids

    def _build_one(self, ids_row: np.ndarray, salt: Optional[int] = None,
                   use_frozen: Optional[bool] = None, context: str = "seal") -> IndexBundle:
        """Incremental index build of one packed segment (gid -1 = padding).

        ``salt`` / ``use_frozen`` default to the live counters (the draws of
        ``salt = n_seals + n_compactions``, frozen calibration after the first
        build); a quarantine rebuild passes the segment's recorded
        provenance instead and replays its original build bit for bit."""
        seg = np.zeros((1, self.seg_size, self.dim), np.float32)
        valid = ids_row >= 0
        seg[0, valid] = self.store[ids_row[valid]]
        if salt is None:
            salt = self.n_seals + self.n_compactions
        first = (self._frozen is None) if use_frozen is None else (not use_frozen)
        self.seal_build_model_s += analytic_build_seconds(
            self.config["index_type"], self.config, self.seg_size, self.dim, first
        )
        if self._faults is not None:
            # after the analytic charge: a crashed attempt still costs build time
            self._faults.on_build(context)
        b = build_index(
            self._draws.fold(salt),
            torch.from_numpy(seg).to(self.device),
            torch.from_numpy(np.ascontiguousarray(ids_row[None])).to(self.device),
            self.config["index_type"], self.config, self._sys,
            frozen=None if first else self._frozen,
        )
        sync(self.device)
        if self._frozen is None:
            self._frozen = frozen_state(b)
        return b

    def _try_seal(self) -> bool:
        """Seal one full tail slice. Returns False if the build crashed (the
        tail stays whole and a backoff retry is scheduled on the fault
        clock); raises :class:`TransientEngineFault` once the retry budget
        is spent."""
        t0 = time.perf_counter()
        ids = np.asarray(self.tail[: self.seg_size], np.int32)
        salt = self.n_seals + self.n_compactions
        first = self._frozen is None
        try:
            b = self._build_one(ids, context="seal")
        except BuildCrashFault:
            self.seal_build_s += time.perf_counter() - t0
            self.n_seal_retries += 1
            attempts = 1 if self._pending_seal is None else self._pending_seal["attempts"] + 1
            plan = self._faults.plan
            if attempts > plan.max_seal_retries:
                self._pending_seal = None
                raise TransientEngineFault(
                    f"seal crashed {attempts} times (budget {plan.max_seal_retries})"
                ) from None
            self._pending_seal = {
                "attempts": attempts,
                "next_tick": self._faults.tick + plan.backoff_base_ticks * 2 ** (attempts - 1),
            }
            return False
        del self.tail[: self.seg_size]
        self.bundle = b if self.bundle is None else concat_bundles(self.bundle, b)
        self.gid_seg[ids] = self.n_sealed
        self.seg_gids.append(ids)
        self._seg_meta.append({"salt": salt, "first": first})
        self.n_seals += 1
        sync(self.device)
        self.seal_build_s += time.perf_counter() - t0
        self.seal_history.append(self.n_sealed)
        self._pending_seal = None
        return True

    def delete(self, gid: int) -> bool:
        """Tombstone one vector; compacts its sealed segment if the dead
        fraction crosses the threshold. Returns False for already-dead ids."""
        if self._faults is not None:
            self._fault_tick()
        gid = int(gid)
        if gid < 0 or gid >= self.n_total or not self.alive[gid]:
            return False
        self.alive[gid] = False
        self.n_deletes += 1
        z = int(self.gid_seg[gid])
        if z >= 0 and z not in self.quarantined:
            row = self.seg_gids[z]
            valid = row[row >= 0]
            dead_frac = 1.0 - float(self.alive[valid].mean()) if valid.size else 1.0
            if dead_frac > self.compact_threshold:
                self._compact(z)
        return True

    def _compact(self, z: int) -> None:
        t0 = time.perf_counter()
        row = self.seg_gids[z]
        valid = row[row >= 0]
        survivors = valid[self.alive[valid]]
        new_row = np.full(self.seg_size, -1, np.int32)
        new_row[: survivors.size] = survivors
        salt = self.n_seals + self.n_compactions
        try:
            b = self._build_one(new_row, context="compact")
        except BuildCrashFault:
            # the old index still serves (tombstones filter at the merge);
            # the next delete past the threshold compacts again
            self.seal_build_s += time.perf_counter() - t0
            self.n_seal_retries += 1
            return
        self.bundle = replace_segment(self.bundle, z, b)
        self.seg_gids[z] = new_row
        self._seg_meta[z] = {"salt": salt, "first": False}
        self.gid_seg[survivors] = z
        self.n_compactions += 1
        sync(self.device)
        self.seal_build_s += time.perf_counter() - t0
        self.seal_history.append(self.n_sealed)

    # --- fault injection and degraded mode ------------------------------
    def arm_faults(self, injector: Optional[FaultInjector]) -> None:
        """Install (or clear, with ``None``) the fault injector driving this
        engine's fault clock. Arm after ``bootstrap`` so plan ticks line up
        with replayed operations rather than bulk-load inserts."""
        self._faults = injector

    def _fault_tick(self) -> None:
        """One step of the fault clock: apply newly due events, then service
        scheduled repairs (crashed-seal retries, quarantine rebuilds)."""
        for e in self._faults.advance():
            if self.n_sealed > 0:
                self._quarantine(e.segment % self.n_sealed, e.kind)
        self._service_repairs()

    def _quarantine(self, z: int, reason: str) -> None:
        if z in self.quarantined:
            return
        self.quarantined[z] = {
            "retries": 0,
            "next_tick": self._faults.tick + self._faults.plan.backoff_base_ticks,
            "reason": reason,
            "permanent": False,
        }
        self.n_quarantines += 1

    def _service_repairs(self) -> None:
        inj = self._faults
        tick, plan = inj.tick, inj.plan
        if self._pending_seal is not None and tick >= self._pending_seal["next_tick"]:
            while len(self.tail) >= self.seg_size:
                if not self._try_seal():
                    break
        for z in sorted(self.quarantined):
            st = self.quarantined[z]
            if st["permanent"] or tick < st["next_tick"]:
                continue
            t0 = time.perf_counter()
            meta = self._seg_meta[z]
            try:
                b = self._build_one(self.seg_gids[z], salt=meta["salt"],
                                    use_frozen=not meta["first"], context="rebuild")
            except BuildCrashFault:
                self.seal_build_s += time.perf_counter() - t0
                st["retries"] += 1
                if st["retries"] >= plan.max_rebuild_retries:
                    st["permanent"] = True  # -> health() == "degraded"
                    self.n_rebuild_failures += 1
                else:
                    st["next_tick"] = tick + plan.backoff_base_ticks * 2 ** st["retries"]
                continue
            self.bundle = replace_segment(self.bundle, z, b)
            del self.quarantined[z]
            self.n_rebuilds += 1
            # the splice's copy must not land in the next search's timed chunks
            sync(self.device)
            self.seal_build_s += time.perf_counter() - t0

    def health(self) -> str:
        """``healthy`` | ``rebuilding`` (repairs scheduled and within budget)
        | ``degraded`` (some quarantined segment ran out of rebuilds)."""
        if any(st["permanent"] for st in self.quarantined.values()):
            return "degraded"
        if self.quarantined or self._pending_seal is not None:
            return "rebuilding"
        return "healthy"

    def _quarantined_gids(self) -> np.ndarray:
        """The gids of every quarantined segment's rows (padding dropped)."""
        rows = [self.seg_gids[z] for z in self.quarantined]
        if not rows:
            return np.empty(0, np.int32)
        gids = np.concatenate(rows)
        return gids[gids >= 0]

    def _search_alive(self) -> np.ndarray:
        """The alive mask a search hands its kernels and merge: ``alive``
        itself, or in degraded mode a copy with the quarantined segments'
        rows cleared (the same ``capacity + 1`` shape and sentinel)."""
        if self._faults is None or not self.quarantined:
            return self.alive
        alive = self.alive.copy()
        alive[self._quarantined_gids()] = False
        return alive

    def _coverage(self, n_vis: int) -> float:
        """The visible fraction a search serves: 1.0 unless segments are
        quarantined, then the alive sealed vectors outside them plus the
        visible tail, over all alive sealed vectors plus the visible tail."""
        if self._faults is None or not self.quarantined:
            return 1.0
        sealed_alive = int((self.alive[: self.capacity] & (self.gid_seg >= 0)).sum())
        lost = int(self.alive[self._quarantined_gids()].sum())
        total = sealed_alive + n_vis
        return float((total - lost) / max(total, 1))

    # --- search --------------------------------------------------------
    def _visible_tail(self) -> np.ndarray:
        """Alive gids of the tail slice a query may scan: the oldest
        ``(1 - graceful_time)`` fraction (the newest inserts are skipped,
        the bounded-consistency window)."""
        m = int(np.ceil((1.0 - self.graceful) * len(self.tail)))
        if m == 0:
            return np.empty(0, np.int32)
        vis = np.asarray(self.tail[:m], np.int32)
        return vis[self.alive[vis]]

    def search_inputs(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """What a search hands its kernels and merge, on ``device``: the
        visible tail padded to its bucket, its gids (-1 pad), the ``capacity
        + 1`` alive mask, and the visible tail's length. The upload is
        timed into ``upload_s``. In degraded mode the alive mask is
        :meth:`_search_alive`'s masked copy."""
        vis = self._visible_tail()
        nb = _bucket(vis.size)
        growing = np.zeros((nb, self.dim), np.float32)
        growing[: vis.size] = self.store[vis]
        ggids = np.full(nb, -1, np.int32)
        ggids[: vis.size] = vis
        dev = self.device
        t0 = time.perf_counter()
        growing_t, ggids_t = torch.from_numpy(growing).to(dev), torch.from_numpy(ggids).to(dev)
        alive_t = torch.from_numpy(self._search_alive()).to(dev)
        sync(dev)
        self.upload_s += time.perf_counter() - t0
        return growing_t, ggids_t, alive_t, int(vis.size)

    def search(self, queries: np.ndarray, topk: int,
               mode: str = "analytic") -> Tuple[np.ndarray, float]:
        """Search the current visible state. Returns ``(global ids (Q,
        topk), elapsed seconds)``: analytic mode charges the deterministic
        cost model for the live segment state; wall mode times each chunk's
        dispatch (query upload, search, ids back on the host). An armed
        engine first ticks its fault clock (repairs it runs are charged to
        ``seal_build_s``, outside the timed chunks); a latency storm scales
        the chunk seconds, never the results."""
        if self._faults is not None:
            self._fault_tick()
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        b = min(self.batch, max(nq, 1))
        n_chunks = (nq + b - 1) // b
        growing_t, ggids_t, alive_t, n_vis = self.search_inputs()
        self.last_coverage = self._coverage(n_vis)
        nb = growing_t.shape[0]
        dev = self.device
        use_fused = get_search_pipeline() == "fused"
        bundle = self.bundle

        def dispatch(chunk: np.ndarray) -> np.ndarray:
            qt = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
            if bundle is None:
                if nb == 0:
                    return np.full((b, topk), -1, np.int32)
                out = _live_chunk_unsealed(qt, growing_t, ggids_t, topk)
            else:
                out = _live_chunk(qt, bundle.arrays, alive_t, growing_t, ggids_t, bundle.kind,
                                  bundle.static, self.k_seg, topk, use_fused)
            return out.cpu().numpy()

        shape_key = (self.n_sealed if bundle is not None else -1, nb, b, topk, use_fused)
        out = np.empty((n_chunks * b, topk), np.int32)
        chunk_s = np.zeros(n_chunks, np.float64)
        for c in range(n_chunks):
            lo = c * b
            chunk = queries[lo : lo + b]
            if chunk.shape[0] < b:  # pad the final chunk by wrapping
                chunk = np.concatenate([chunk, queries[: b - chunk.shape[0]]], axis=0)
            if mode != "analytic" and shape_key not in self._warmed:
                # the first run of a shape is kept apart from the measured
                # region, as the static path's first search is
                t0 = time.perf_counter()
                dispatch(chunk)
                self.compile_s += time.perf_counter() - t0
                self._warmed.add(shape_key)
            t0 = time.perf_counter()
            ids = dispatch(chunk)
            chunk_s[c] = time.perf_counter() - t0
            out[lo : lo + b] = ids
        if mode == "analytic":
            chunk_s[:] = analytic_chunk_seconds(
                bundle.kind if bundle is not None else "FLAT",
                bundle.static if bundle is not None else {},
                bundle.arrays if bundle is not None else {},
                self.n_sealed, self.seg_size, n_vis, self.dim, b,
            )
        counts = np.minimum(b, nq - b * np.arange(n_chunks))
        if self._faults is not None:
            mult, add = self._faults.latency_shape()
            if mult != 1.0 or add != 0.0:
                chunk_s = chunk_s * mult + add * counts
        elapsed = float(chunk_s.sum())
        # per-query latency: each chunk's elapsed is split over the real
        # queries it served, so latencies always sum to the elapsed time
        lat = np.repeat(chunk_s / np.maximum(counts, 1), counts)
        self.last_latencies = lat
        self.queries_served += nq
        for hook in self.search_hooks:
            hook(nq, lat, elapsed)
        return out[:nq], elapsed


# ---------------------------------------------------------------------------
# batched multi-configuration measurement
# ---------------------------------------------------------------------------
def batch_signature(inst: VDMSInstance, topk: int | None = None) -> Tuple:
    """Static-shape fingerprint of an instance's search: instances with
    equal signatures run the same search modulo array contents, so
    :func:`measure_batch` can search them together."""
    topk = topk or inst.dataset.k
    return (
        inst.bundle.kind,
        tuple(sorted(inst.bundle.static.items())),
        tuple((k, tuple(a.shape), str(a.dtype)) for k, a in sorted(inst.bundle.arrays.items())),
        (tuple(inst.growing.shape), str(inst.growing.dtype)),
        inst.k_seg,
        inst.batch,
        topk,
    )


def _fold_instances(instances: Sequence[VDMSInstance]) -> List[Tuple[List[int], IndexBundle]]:
    """Groups of same-signature instances whose segment stacks are
    concatenated along the segment axis (segments are searched
    independently, so the fold is exact). The fold needs one set of shared
    calibration arrays: SQ8 scales of one dataset's segment plan agree, but
    PQ codebooks trained with other k-means settings do not, and then each
    instance forms its own group."""
    shared = get_family(instances[0].bundle.kind).shared_arrays
    first = instances[0].bundle.arrays
    if all(torch.equal(i.bundle.arrays[k], first[k]) for i in instances[1:]
           for k in shared if k in first):
        members = [list(range(len(instances)))]
    else:
        members = [[i] for i in range(len(instances))]
    groups = []
    for idx in members:
        arrays = {k: v if k in shared else torch.cat([instances[i].bundle.arrays[k] for i in idx])
                  for k, v in instances[idx[0]].bundle.arrays.items()}
        groups.append((idx, IndexBundle(kind=instances[0].bundle.kind, arrays=arrays,
                                        static=dict(instances[0].bundle.static))))
    return groups


def _pipeline_batch(qc, groups, growings, growing_gids, k_seg, topk):
    """Search every instance of a same-signature batch: per query chunk, the
    composed search runs once over each group's folded segment stack and
    each instance's slice of the candidates is merged with its own growing
    tail. qc: (n_chunks, B, d) shared queries -> (n_inst, n_chunks, B, topk)
    global ids. Always composed, as in the JAX package: the fused hooks take
    one query set per call and the fold is already one search."""
    n_inst = len(growings)
    outs: List[List[torch.Tensor]] = [[] for _ in range(n_inst)]
    for idx, bundle in groups:
        n_seg = bundle.arrays["gids"].shape[0] // len(idx)
        for q in qc:
            ids, sims = search_index(bundle, q, k_seg)  # (len(idx) * n_seg, B, k_seg)
            for j, i in enumerate(idx):
                seg = slice(j * n_seg, (j + 1) * n_seg)
                outs[i].append(merge_topk(ids[seg], sims[seg], q, growings[i], growing_gids[i],
                                          topk))
    return torch.stack([torch.stack(o) for o in outs])


def measure_batch(instances: List[VDMSInstance], topk: int | None = None, repeats: int = 3,
                  mode: str = "analytic") -> List[Dict[str, float]]:
    """Measure shape-identical instances with one dispatch.

    All instances must share one dataset, one device and one
    :func:`batch_signature`. Their segment stacks are folded into one
    (:func:`_fold_instances`, outside the timed region) and searched by
    :func:`_pipeline_batch`. Recall is exact per configuration. In
    ``analytic`` mode speed comes from each instance's cost model
    (identical to sequential ``measure``); in ``wall`` mode the batch is
    timed as one dispatch and each configuration is charged an equal share
    (amortised throughput).
    """
    if not instances:
        return []
    inst0 = instances[0]
    ds = inst0.dataset
    topk = topk or ds.k
    if any(i.dataset is not ds for i in instances):
        raise ValueError("measure_batch requires a single shared dataset")
    if any(i.device != inst0.device for i in instances):
        raise ValueError("measure_batch requires a single device")
    if len({batch_signature(i, topk) for i in instances}) != 1:
        raise ValueError("measure_batch requires shape-identical instances")
    queries = ds.queries
    qc = inst0._chunked_queries(queries)
    args = (qc, _fold_instances(instances), [i.growing for i in instances],
            [i.growing_gids for i in instances], inst0.k_seg, topk)
    t0 = time.perf_counter()
    out = _pipeline_batch(*args).cpu().numpy()
    compile_time = time.perf_counter() - t0
    n_chunks = (queries.shape[0] + inst0.batch - 1) // inst0.batch
    if mode == "analytic":
        elapsed = [inst._analytic_seconds_per_chunk() * n_chunks for inst in instances]
    else:
        times = []
        for _ in range(repeats):
            sync(inst0.device)
            t0 = time.perf_counter()
            _pipeline_batch(*args)
            sync(inst0.device)
            times.append(time.perf_counter() - t0)
        elapsed = [min(times) / len(instances)] * len(instances)
    results = []
    for i, inst in enumerate(instances):
        ids = out[i].reshape(-1, topk)[: queries.shape[0]]
        results.append({
            "speed": float(queries.shape[0] / max(elapsed[i], 1e-9)),
            "recall": float(recall_at_k(ids[:, : ds.k], ds.ground_truth)),
            "mem_gib": float(inst.memory_gib()),
            "build_time": float(inst.build_time),
            "compile_time": float(compile_time),
        })
    return results
