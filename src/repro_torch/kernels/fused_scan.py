"""Fused IVF probe -> int8 dequant scan -> top-k (IVF_SQ8), ``csrc/fused_scan.cu``.

Replaces ``repro/kernels/fused_scan.py::fused_ivf_sq8_topk_pallas`` (the TPU
kernel ``_fused_sq8_kernel`` with its stages ``probe_and_init`` and
``merge_tile_topk``). The IVF_SQ8 fused hook (``vdms/fused.py``) calls it once
per search with every query chunk flattened into one batch.

Contract (as the JAX package's ``ops.fused_ivf_sq8_topk``): q (B, d) f32;
codes (n_seg, s, d) int8; scale (d,) f32; centroids (n_seg, nlist, d) f32;
members (n_seg, nlist, cap) int32, -1 padded; gids (n_seg, s) int32 ->
(lids, sims), each (n_seg, B, k), -1 / -inf in empty slots. A point is a
candidate iff it sits in the member list of one of the query's top-``nprobe``
clusters (ties to the lowest cluster index); ``mask_dead`` also drops slots
whose gid is < 0. Candidate SETS and scores match the plain version; the
order among tied scores is implementation-defined (the kernel puts the
lowest local id first).

Bound on the H100: operations. At the main path's shapes (1,024 queries, 289
segments, nprobe 8 of 128 clusters, 88-slot lists, d = 100) the kernel moves
about 300 MB (inputs read once, results written once) but does about 23 GFLOP
of f32 work (7.6 for the probe, 15.2 for the 76 M live candidates at a
multiply and an add per code, 0.03 to fold the scale into each query once per
segment), which the card's 67 TFLOP/s f32 rate makes the larger time. Design:
one warp per (query, segment), up to eight queries of one segment in a block,
segments on the grid's y axis, so that the warps of a segment run together and
its lists and codes stay in cache. The block stages the segment's centroids
through shared memory 32 at a time for the probe, so they are read from device
memory once per eight queries. The warp then compacts the live members of the
probed lists with a ballot (a gather, cheap on a GPU, where the TPU masked a
scan of the whole segment) and scores them one candidate per lane against the
query times the scale (so no code is dequantized on its own), keeping scores
and ids in shared memory (up to 9,216 candidates, so the dynamic shared-memory
limit is raised and fewer warps share a block). The top k is a merge of 32
per-lane sorted lists by warp-wide integer max-reductions; no score matrix
reaches device memory.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import segment_blocks, topk_stable


# ---------------------------------------------------------------------------
# plain version (the JAX package's XLA formulation, batched over segments)
# ---------------------------------------------------------------------------
def probe_candidates(q, centroids, members, nprobe: int) -> torch.Tensor:
    """Top-``nprobe`` clusters per (segment, query), their member lists
    flattened: (n_seg, B, nprobe * cap) local ids, -1 padded."""
    n_seg, nlist, cap = members.shape
    csim = torch.matmul(q, centroids.transpose(1, 2))  # (n_seg, B, nlist)
    _, probe = topk_stable(csim, min(nprobe, nlist))
    z = torch.arange(n_seg, device=q.device)[:, None, None]
    return members[z, probe].reshape(n_seg, q.shape[0], -1)


def topk_candidates(cand, sims, gids, *, k: int, mask_dead: bool):
    """Mask padded (and, with ``mask_dead``, dead-gid) candidates, take the
    top k and pad to width k with -1 / -inf."""
    ok = cand >= 0
    if mask_dead:
        n_seg = cand.shape[0]
        g = torch.gather(gids, 1, cand.clamp_min(0).reshape(n_seg, -1).long())
        ok = ok & (g.reshape(cand.shape) >= 0)
    sims = torch.where(ok, sims, torch.tensor(float("-inf"), device=sims.device))
    kk = min(k, sims.shape[-1])
    top_s, top_i = topk_stable(sims, kk)
    lids = torch.gather(cand, -1, top_i)
    lids = torch.where(torch.isfinite(top_s), lids, torch.full_like(lids, -1))
    if kk < k:
        pad = k - kk
        lids = torch.nn.functional.pad(lids, (0, pad), value=-1)
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=float("-inf"))
    return lids, top_s


def fused_ivf_sq8_topk_torch(q, codes, scale, centroids, members, gids, *, nprobe: int,
                             k: int, mask_dead: bool = False):
    """Plain version: full-segment dequantized matmul, candidate-score
    gather, top-k; in blocks of segments to bound the (B, s) score slabs."""
    n_seg, s, _ = codes.shape
    lids, sims = [], []
    for blk in segment_blocks(n_seg, q.shape[0] * s):
        cand = probe_candidates(q, centroids[blk], members[blk], nprobe)
        deq = codes[blk].float() * scale[None, None, :]
        sall = torch.matmul(q, deq.transpose(1, 2))  # (z, B, s)
        sc = torch.gather(sall, 2, cand.clamp_min(0).long())
        li, si = topk_candidates(cand, sc, gids[blk], k=k, mask_dead=mask_dead)
        lids.append(li)
        sims.append(si)
    return torch.cat(lids), torch.cat(sims)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_SIG = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("fused_scan")
    lib.fused_ivf_sq8_topk.argtypes = _SIG
    lib.fused_ivf_sq8_topk.restype = ctypes.c_int
    return lib


def check_ivf_inputs(name, q, centroids, members, gids, codes, code_dtype, code_width):
    """Device, dtype, shape and contiguity checks shared by both fused
    wrappers; raises ValueError on anything the kernels do not take."""
    dev = q.device
    tensors = dict(q=q, centroids=centroids, members=members, gids=gids, codes=codes)
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{name} needs every input on one CUDA device")
    want = dict(q=torch.float32, centroids=torch.float32, members=torch.int32,
                gids=torch.int32, codes=code_dtype)
    for key, t in tensors.items():
        if t.dtype != want[key]:
            raise ValueError(f"{name}: {key} must be {want[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    b, d = q.shape
    n_seg, s, w = codes.shape
    nlist = centroids.shape[1]
    if (centroids.shape != (n_seg, nlist, d) or members.dim() != 3
            or members.shape[:2] != (n_seg, nlist) or gids.shape != (n_seg, s)
            or w != code_width):
        raise ValueError(
            f"{name}: inconsistent shapes q {tuple(q.shape)}, codes {tuple(codes.shape)}, "
            f"centroids {tuple(centroids.shape)}, members {tuple(members.shape)}, "
            f"gids {tuple(gids.shape)}")


def fused_ivf_sq8_topk_cuda(q, codes, scale, centroids, members, gids, *, nprobe: int,
                            k: int, mask_dead: bool = False):
    """CUDA kernel: same contract as :func:`fused_ivf_sq8_topk_torch`."""
    check_ivf_inputs("fused_ivf_sq8_topk", q, centroids, members, gids, codes, torch.int8,
                     q.shape[1])
    if (scale.dtype != torch.float32 or scale.shape != (q.shape[1],)
            or scale.device != q.device or not scale.is_contiguous()):
        raise ValueError("fused_ivf_sq8_topk: scale must be contiguous (d,) f32 on the "
                         "queries' device")
    b, d = q.shape
    n_seg, s, _ = codes.shape
    _, nlist, cap = members.shape
    lids = torch.empty((n_seg, b, k), dtype=torch.int32, device=q.device)
    sims = torch.empty((n_seg, b, k), dtype=torch.float32, device=q.device)
    if lids.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().fused_ivf_sq8_topk(
            q.data_ptr(), codes.data_ptr(), scale.data_ptr(), centroids.data_ptr(),
            members.data_ptr(), gids.data_ptr(), lids.data_ptr(), sims.data_ptr(),
            b, n_seg, s, d, nlist, cap, min(nprobe, nlist), k, int(mask_dead), stream)
        _build.check(err, "fused_ivf_sq8_topk")
        fused_ivf_sq8_topk_cuda.launches += 1
    return lids, sims


fused_ivf_sq8_topk_cuda.launches = 0
