"""Top-k merge arithmetic shared by the composed and fused search paths
(static flavour of the JAX package's ``vdms/merge.py``).

* per-segment candidates ``(n_seg, B, k_seg)`` flatten query-major to
  ``(B, n_seg * k_seg)``: flat position = ``segment * k_seg + slot``, which
  is the tie-break order (equal scores keep the lowest index);
* the growing tail is brute-forced and its best ``min(topk, len)``
  candidates are appended AFTER all segment candidates (ties lose to
  sealed results);
* the final top-k keeps ``min(topk, width)`` winners; missing width pads
  with ``-1``.
"""
from __future__ import annotations

import torch

from ..kernels.ops import topk_by_score, topk_stable


def flatten_candidates(ids, sims):
    """(n_seg, B, k) per-segment candidates -> (B, n_seg * k) flat lists."""
    n_seg, b, ks = ids.shape
    return (ids.permute(1, 0, 2).reshape(b, n_seg * ks),
            sims.permute(1, 0, 2).reshape(b, n_seg * ks))


def merge_flat(ids2, sims2, q, growing, growing_gids, topk):
    """Append the growing-tail candidates to flat per-query lists (B, W) and
    keep the global top-k ids, (B, topk)."""
    if growing.shape[0] > 0:
        gs = q @ growing.T.to(q.dtype)
        gtop_s, gtop_i = topk_stable(gs, min(topk, growing.shape[0]))
        ids2 = torch.cat([ids2, growing_gids[gtop_i]], dim=1)
        sims2 = torch.cat([sims2, gtop_s], dim=1)
    k = min(topk, sims2.shape[1])
    out, _ = topk_by_score(ids2, sims2, k)
    if k < topk:
        out = torch.nn.functional.pad(out, (0, topk - k), value=-1)
    return out


def merge_topk(ids, sims, q, growing, growing_gids, topk):
    """Merge per-segment candidates (n_seg, B, k_seg) with the growing tail
    into (B, topk) global ids."""
    ids2, sims2 = flatten_candidates(ids, sims)
    return merge_flat(ids2, sims2, q, growing, growing_gids, topk)
