"""Fused per-family search pipelines (the registry ``fused_search`` hooks),
static flavour of the JAX package's ``vdms/fused.py``.

Each hook replaces one family's whole per-chunk hot path (IVF probe,
candidate scoring, per-segment top-k, global-id mapping, merge with the
growing tail) with one call into the fused kernel layer
(:mod:`repro_torch.kernels.ops`: the CUDA kernel for CUDA tensors, the plain
version on the CPU), over every query chunk at once.

* The returned ``(B, topk)`` global ids are SET-identical per query to the
  composed path's output, with slot order among tied scores
  implementation-defined.
* ``clamp=True`` (static instances whose sealed segments carry no ``-1``
  padding) narrows the per-segment width to ``min(k_seg, topk)``: exact,
  because only ``topk`` results survive the merge and no dead slot can
  consume width.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .merge import merge_topk


def pq_lut(q, codebooks):
    """ADC similarity table (B, m, c): the inner product of each query
    sub-vector with each codeword of its subspace."""
    m, _, dsub = codebooks.shape
    return torch.einsum("bmd,mcd->bmc", q.reshape(q.shape[0], m, dsub), codebooks).contiguous()


def _map_gids(gids, lids):
    """Per-segment local ids (n_seg, B, k) -> global ids via each segment's
    gid row; empty slots (lid < 0) map to -1."""
    n_seg = gids.shape[0]
    ids = torch.gather(gids, 1, lids.clamp_min(0).reshape(n_seg, -1).long()).reshape(lids.shape)
    return torch.where(lids >= 0, ids, torch.full_like(ids, -1))


def _finish(lids, sims, gids, q, growing, growing_gids, topk):
    """Local -> global ids, dead slots (gid < 0) to -1 / -inf keeping their
    width, then the shared merge."""
    ids = _map_gids(gids, lids)
    sims = torch.where(ids >= 0, sims, torch.tensor(float("-inf"), device=sims.device))
    return merge_topk(ids, sims, q, growing, growing_gids, topk)


def fused_search_ivf_sq8(q, arrays, growing, growing_gids, *, k_seg, topk, clamp=False, nprobe):
    """IVF_SQ8: fused probe -> int8 dequant scan -> in-kernel top-k."""
    k_eff = min(k_seg, topk) if clamp else k_seg
    lids, sims = ops.fused_ivf_sq8_topk(
        q, arrays["codes"], arrays["scale"], arrays["centroids"], arrays["members"],
        arrays["gids"], nprobe=nprobe, k=k_eff, mask_dead=clamp,
    )
    return _finish(lids, sims, arrays["gids"], q, growing, growing_gids, topk)


fused_search_ivf_sq8.stages = "probe → int8 dequant scan → top-k"


def fused_search_ivf_pq(q, arrays, growing, growing_gids, *, k_seg, topk, clamp=False, nprobe,
                        m, c):
    """IVF_PQ: fused probe -> flat-LUT ADC scan -> in-kernel top-k."""
    k_eff = min(k_seg, topk) if clamp else k_seg
    lids, sims = ops.fused_ivf_pq_topk(
        q, pq_lut(q, arrays["codebooks"]), arrays["codes"], arrays["centroids"],
        arrays["members"], arrays["gids"], nprobe=nprobe, k=k_eff, mask_dead=clamp,
    )
    return _finish(lids, sims, arrays["gids"], q, growing, growing_gids, topk)


fused_search_ivf_pq.stages = "probe → PQ ADC scan → top-k"
