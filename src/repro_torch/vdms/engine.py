"""VDMS query engine of the port: builds a configured instance and measures
the paper's objectives (search speed as QPS, recall@K, memory footprint);
the static part of the JAX package's ``vdms/engine.py``.

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
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device, sync
from .datasets import VectorDataset, recall_at_k
from .indexes import IndexBundle, build_index, search_index
from .merge import merge_topk
from .registry import get_family
from .segments import plan_segments, stack_sealed

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
    """

    def __init__(self, dataset: VectorDataset, config: Dict[str, Any], seed: int = 0,
                 device=None, bundle: Optional[IndexBundle] = None):
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
            gen = torch.Generator(device=dev).manual_seed(seed)
            sys = {
                "kmeans_iters": int(config["kmeans_iters"]),
                "storage_bf16": bool(config["storage_bf16"]),
            }
            bundle = build_index(gen, torch.from_numpy(segs).to(dev),
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
