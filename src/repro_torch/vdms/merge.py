"""Top-k merge arithmetic shared by every search path (the counterpart of
the JAX package's ``vdms/merge.py``): the composed and fused pipelines of
static instances, the live tombstone merge and the batched measurement.

* per-segment candidates ``(n_seg, B, k_seg)`` flatten query-major to
  ``(B, n_seg * k_seg)``: flat position = ``segment * k_seg + slot``, which
  is the tie-break order (equal scores keep the lowest index);
* ``alive`` (live merge only) gates every candidate through the global
  alive mask of ``capacity + 1`` slots; id ``-1`` maps to the always-dead
  sentinel slot ``alive[-1]``;
* the growing tail is brute-forced and its best ``min(topk, len)``
  candidates are appended AFTER all segment candidates (ties lose to
  sealed results); the live flavour also masks tail pad rows (gid < 0) to
  ``-inf``;
* the final top-k keeps ``min(topk, width)`` winners; the live flavour
  reports ``-inf`` survivors as id ``-1``; missing width pads with ``-1``.
"""
from __future__ import annotations

import torch

from ..kernels.ops import topk_by_score, topk_stable

_NEG_INF = float("-inf")


def flatten_candidates(ids, sims, alive=None):
    """(n_seg, B, k) per-segment candidates -> (B, n_seg * k) flat lists,
    the scores gated through the global ``alive`` mask when one is given
    (id -1 hits the always-dead sentinel slot ``alive[-1]``)."""
    n_seg, b, ks = ids.shape
    ids2 = ids.permute(1, 0, 2).reshape(b, n_seg * ks)
    sims2 = sims.permute(1, 0, 2).reshape(b, n_seg * ks)
    if alive is not None:
        sentinel = alive.shape[0] - 1
        ok = alive[torch.where(ids2 >= 0, ids2, sentinel).long()]
        sims2 = sims2.masked_fill(~ok, _NEG_INF)
    return ids2, sims2


def partial_topk(ids, sims, k, alive=None):
    """One leaf of a merge tree: flatten a group of per-segment candidates
    and keep its best ``min(k, width)``, scores included, so a root merge
    can finish the reduction. Tie-break and alive gating are those of the
    full merge."""
    ids2, sims2 = flatten_candidates(ids, sims, alive=alive)
    return topk_by_score(ids2, sims2, min(k, sims2.shape[1]))


def merge_flat(ids2, sims2, q, growing, growing_gids, topk, *, live: bool = False,
               return_scores: bool = False):
    """Append the growing-tail candidates to flat per-query lists (B, W) and
    keep the global top-k ids, (B, topk). ``live`` selects the tombstone
    flavour (masked tail gids, -inf survivors become id -1)."""
    if growing.shape[0] > 0:
        gs = q @ growing.T.to(q.dtype)
        if live:
            gs = gs.masked_fill(growing_gids[None, :] < 0, _NEG_INF)
        gtop_s, gtop_i = topk_stable(gs, min(topk, growing.shape[0]))
        ids2 = torch.cat([ids2, growing_gids[gtop_i]], dim=1)
        sims2 = torch.cat([sims2, gtop_s], dim=1)
    k = min(topk, sims2.shape[1])
    out, top_s = topk_by_score(ids2, sims2, k)
    if live:
        out = torch.where(torch.isfinite(top_s), out, torch.full_like(out, -1))
    if k < topk:
        out = torch.nn.functional.pad(out, (0, topk - k), value=-1)
        top_s = torch.nn.functional.pad(top_s, (0, topk - k), value=_NEG_INF)
    return (out, top_s) if return_scores else out


def merge_topk(ids, sims, q, growing, growing_gids, topk, alive=None,
               return_scores: bool = False):
    """Merge per-segment candidates (n_seg, B, k_seg) with the growing tail
    into (B, topk) global ids. ``alive=None`` is the static merge; a mask
    selects the live merge."""
    ids2, sims2 = flatten_candidates(ids, sims, alive=alive)
    return merge_flat(ids2, sims2, q, growing, growing_gids, topk,
                      live=alive is not None, return_scores=return_scores)


def shard_partial_topk(ids, sims, n_shards: int, k, alive=None):
    """Every leaf of a merge tree at once, then the root's input: ids, sims
    (n_shards * per, B, k_seg) per-segment candidates of contiguous shard
    blocks -> each shard's :func:`partial_topk` as one batched stable top-k
    over (n_shards * B, per * k_seg), concatenated shard-major -> (B,
    n_shards * min(k, per * k_seg)). Rows are independent, so this equals a
    loop of per-shard ``partial_topk`` calls bit for bit."""
    n_seg, b, ks = ids.shape
    per = n_seg // n_shards

    def fold(x):  # (n_shards * per, B, ks) -> (per, n_shards * B, ks)
        return x.reshape(n_shards, per, b, ks).transpose(0, 1).reshape(per, n_shards * b, ks)

    def unfold(x):  # (n_shards * B, kk) -> (B, n_shards * kk)
        return x.reshape(n_shards, b, -1).transpose(0, 1).reshape(b, -1)

    pid, psc = partial_topk(fold(ids), fold(sims), k, alive=alive)
    return unfold(pid), unfold(psc)
