"""IVF_PQR: a DiskANN-style index family registered through the public
registry hook (the counterpart of the JAX package's ``vdms/ivf_pqr.py``).

PQ candidate generation + exact re-ranking: the scan walks the probed
clusters with the ADC lookup table (like IVF_PQ), keeps the best
``reorder_k`` candidates, and re-scores exactly those against the raw stored
vectors (compressed codes decide where to look, full-precision vectors what
to return). The memory/recall trade sits between IVF_PQ (codes only) and
SCANN (int8 codes): PQ compression for the scan plus one raw copy for the
re-rank.

The family is NOT registered when ``repro_torch.vdms`` imports: calling
:func:`register` is the only integration step, after which ``make_space()``
exposes its parameters and the engine builds and searches it. The registry
is process-wide, so a caller that registers it for a while undoes that with
``REGISTRY.unregister("IVF_PQR")``.
"""
from __future__ import annotations

import torch

from ..core.space import Param
from ..kernels.fused_adc import adc_candidate_scores
from ..kernels.fused_scan import probe_candidates
from ..kernels.ref import topk_stable
from .fused import fused_search_ivf_pqr, pq_lut
from .indexes import (
    _NLIST,
    _NPROBE,
    IndexBundle,
    _blocked,
    _build_cost_ivf_pq,
    _finish_candidates,
    _gather_rows,
    _storage,
    build_ivf_pq,
)
from .registry import REGISTRY, IndexFamily


def build_ivf_pqr(gen, segs, gids, params, sys) -> IndexBundle:
    """The IVF_PQ bundle (codes + shared codebooks) plus the raw vectors the
    re-rank stage scores against."""
    base = build_ivf_pq(gen, segs, gids, params, sys)
    arrays = dict(base.arrays)
    arrays["data"] = _storage(segs, sys["storage_bf16"])
    static = dict(base.static)
    static["reorder_k"] = int(max(params["reorder_k"], 1))
    return IndexBundle(kind="IVF_PQR", arrays=arrays, static=static)


def search_ivf_pqr(q, arrays, *, k_seg: int, nprobe: int, m: int, c: int, reorder_k: int):
    """Composed search: probe, ADC scores of the candidates, the best
    ``reorder_k`` of them re-scored exactly, per-segment top-``k_seg``."""
    lut = pq_lut(q, arrays["codebooks"])  # (B, m, c)
    _, nlist, cap = arrays["members"].shape
    p = min(nprobe, nlist) * cap
    per_seg = q.shape[0] * (p * m + min(reorder_k, p) * q.shape[1])

    def block(codes, data, gids, cents, members):
        cand = probe_candidates(q, cents, members, nprobe)  # (z, B, P)
        approx = adc_candidate_scores(lut, codes, cand).masked_fill(cand < 0, float("-inf"))
        _, top_r = topk_stable(approx, min(reorder_k, approx.shape[-1]))
        rcand = torch.gather(cand, 2, top_r)
        exact = torch.einsum("zbrd,bd->zbr", _gather_rows(data, rcand.clamp_min(0)).float(), q)
        return _finish_candidates(rcand, exact, gids, k_seg)

    return _blocked(block, arrays["gids"].shape[0], per_seg, arrays["codes"], arrays["data"],
                    arrays["gids"], arrays["centroids"], arrays["members"])


def _chunk_cost_ivf_pqr(st, arrays, n_sealed, seg_size, dim):
    """ADC scan (centroid probe + LUT + code adds) plus the exact re-rank."""
    nlist = arrays["centroids"].shape[1]
    cap = arrays["members"].shape[2]
    flops = n_sealed * (
        nlist * dim * 2
        + st["m"] * st["c"] * (dim // st["m"]) * 2
        + st["nprobe"] * cap * st["m"]
        + st["reorder_k"] * dim * 2
    )
    return flops, 0


FAMILY = IndexFamily(
    name="IVF_PQR",
    params=(
        Param("nlist", "grid", choices=_NLIST, default=128),
        Param("m", "grid", choices=(4, 8, 16, 32), default=8),
        Param("nbits", "grid", choices=(4, 6, 8), default=8),
        Param("nprobe", "grid", choices=_NPROBE, default=8),
        Param("reorder_k", "grid", choices=(32, 64, 128, 256, 512), default=64),
    ),
    build=build_ivf_pqr,
    search=search_ivf_pqr,
    fused_search=fused_search_ivf_pqr,
    chunk_cost=_chunk_cost_ivf_pqr,
    build_cost=_build_cost_ivf_pq,  # the re-rank stores raw vectors; build cost is PQ's
    description="DiskANN-style IVF: PQ candidate scan + exact re-rank (reorder_k)",
)


def register() -> IndexFamily:
    """Register IVF_PQR into the port's registry (idempotent). The built-in
    families registered when ``.indexes`` was imported, so IVF_PQR comes
    after them, as in the JAX package."""
    if FAMILY.name not in {f.name for f in REGISTRY.families()}:
        REGISTRY.register(FAMILY)
    return FAMILY
