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
from ..kernels.ref import segment_blocks, topk_stable
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


def fused_search_ivf_pqr(q, arrays, growing, growing_gids, *, k_seg, topk, clamp=False, nprobe,
                         m, c, reorder_k):
    """IVF_PQR: fused PQ candidate scan at width ``reorder_k`` (never
    clamped: dead slots consume reorder width exactly as composed) -> exact
    re-rank against the raw vectors -> clamped per-segment top-k."""
    k_eff = min(k_seg, topk) if clamp else k_seg
    lids, _ = ops.fused_ivf_pq_topk(
        q, pq_lut(q, arrays["codebooks"]), arrays["codes"], arrays["centroids"],
        arrays["members"], arrays["gids"], nprobe=nprobe, k=reorder_k, mask_dead=False,
    )  # (n_seg, B, r): the PQ stage only ranks; its scores are discarded
    data = arrays["data"]
    exact = torch.empty(lids.shape, dtype=torch.float32, device=q.device)
    for blk in segment_blocks(lids.shape[0], lids.shape[1] * lids.shape[2] * q.shape[1]):
        lz = lids[blk]
        z = torch.arange(lz.shape[0], device=q.device)[:, None, None]
        vecs = data[blk][z, lz.clamp_min(0).long()].float()  # (z, B, r, d)
        exact[blk] = torch.einsum("zbrd,bd->zbr", vecs, q).masked_fill(lz < 0, float("-inf"))
    kk = min(k_eff, exact.shape[-1])
    top_s, top_i = topk_stable(exact, kk)
    lids2 = torch.gather(lids, 2, top_i)
    if kk < k_eff:
        lids2 = torch.nn.functional.pad(lids2, (0, k_eff - kk), value=-1)
        top_s = torch.nn.functional.pad(top_s, (0, k_eff - kk), value=float("-inf"))
    return _finish(lids2, top_s, arrays["gids"], q, growing, growing_gids, topk)


fused_search_ivf_pqr.stages = "probe → PQ ADC scan → exact re-rank → top-k"
