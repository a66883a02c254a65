"""Fused IVF probe -> PQ ADC scan -> top-k (IVF_PQ), ``csrc/fused_adc.cu``.

Replaces ``repro/kernels/fused_adc.py::fused_ivf_pq_topk_pallas`` (the TPU
kernel ``_fused_pq_kernel``). The IVF_PQ fused hook (``vdms/fused.py``) calls
it once per search with every query chunk flattened into one batch.

Contract (as the JAX package's ``ops.fused_ivf_pq_topk``): q (B, d) f32;
lut (B, m, c) f32 ADC similarity table; codes (n_seg, s, m) uint8;
centroids, members, gids and the outputs as in :mod:`.fused_scan`. The score
of a candidate is ``sum_m lut[b, m, code[n, m]]``, summed in order
m = 0 .. m-1 by both versions, so kernel and plain scores agree bit for bit.

Bound on the H100: operations, narrowly. At the main path's shapes (1,024
queries, 289 segments, nprobe 8 of 128 clusters, 88-slot lists, m = 5, c =
256) the kernel reads about 40 MB of inputs and writes 151 MB of results,
against 7.6 GFLOP of f32 probe work and 380 M table lookups and adds (76 M
live candidates, m each). Design: the warp-per-(query, segment) structure,
staged probe, compaction and top-k of :mod:`.fused_scan`; the query's table
(m * c f32, at most 32 KB) is loaded into the warp's shared memory once and
read with a per-byte gather, which is what the TPU had to emulate with m
one-hot matrix products.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_scan import check_ivf_inputs, probe_candidates, topk_candidates
from .ref import adc_sum, segment_blocks


def adc_candidate_scores(lut, codes, cand):
    """ADC scores of candidate lists: lut (B, m, c); codes (z, s, m);
    cand (z, B, P) local ids (-1 allowed, scored as id 0 and masked by the
    caller) -> (z, B, P) f32, summed over m in order."""
    b, m, c = lut.shape
    zb = cand.shape[0]
    z = torch.arange(zb, device=cand.device)[:, None, None]
    offs = torch.arange(m, device=cand.device) * c
    idx = codes[z, cand.clamp_min(0).long()].long() + offs  # (z, B, P, m)
    g = torch.gather(lut.reshape(b, m * c).expand(zb, b, m * c), 2, idx.reshape(zb, b, -1))
    return adc_sum(g.reshape(zb, b, -1, m))


def fused_ivf_pq_topk_torch(q, lut, codes, centroids, members, gids, *, nprobe: int,
                            k: int, mask_dead: bool = False):
    """Plain version: probe, flat-table gather over the candidates' codes,
    ordered sum over m, top-k; in blocks of segments."""
    b, m, _ = lut.shape
    p = min(nprobe, members.shape[1]) * members.shape[2]
    lids, sims = [], []
    for blk in segment_blocks(codes.shape[0], b * p * m, budget=1 << 26):
        cand = probe_candidates(q, centroids[blk], members[blk], nprobe)  # (z, B, P)
        sc = adc_candidate_scores(lut, codes[blk], cand)
        li, si = topk_candidates(cand, sc, gids[blk], k=k, mask_dead=mask_dead)
        lids.append(li)
        sims.append(si)
    return torch.cat(lids), torch.cat(sims)


_SIG = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("fused_adc")
    lib.fused_ivf_pq_topk.argtypes = _SIG
    lib.fused_ivf_pq_topk.restype = ctypes.c_int
    return lib


def fused_ivf_pq_topk_cuda(q, lut, codes, centroids, members, gids, *, nprobe: int, k: int,
                           mask_dead: bool = False):
    """CUDA kernel: same contract as :func:`fused_ivf_pq_topk_torch`."""
    b, m, c = lut.shape
    check_ivf_inputs("fused_ivf_pq_topk", q, centroids, members, gids, codes, torch.uint8, m)
    if (lut.dtype != torch.float32 or lut.shape[0] != q.shape[0] or lut.device != q.device
            or not lut.is_contiguous()):
        raise _build.KernelContractError(
            "fused_ivf_pq_topk: lut must be contiguous (B, m, c) f32 on the queries' device")
    if c > 256:
        raise _build.KernelContractError(
            f"fused_ivf_pq_topk: uint8 codes address at most 256 codewords, c={c}")
    d = q.shape[1]
    n_seg, s, _ = codes.shape
    _, nlist, cap = members.shape
    lids = torch.empty((n_seg, b, k), dtype=torch.int32, device=q.device)
    sims = torch.empty((n_seg, b, k), dtype=torch.float32, device=q.device)
    if lids.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().fused_ivf_pq_topk(
            q.data_ptr(), lut.data_ptr(), codes.data_ptr(), centroids.data_ptr(),
            members.data_ptr(), gids.data_ptr(), lids.data_ptr(), sims.data_ptr(),
            b, n_seg, s, d, m, c, nlist, cap, min(nprobe, nlist), k, int(mask_dead), stream)
        _build.check(err, "fused_ivf_pq_topk")
        fused_ivf_pq_topk_cuda.launches += 1
    return lids, sims


fused_ivf_pq_topk_cuda.launches = 0
