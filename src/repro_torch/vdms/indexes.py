"""ANNS index implementations (Milvus Table I): FLAT, IVF_FLAT, IVF_SQ8,
IVF_PQ, HNSW, SCANN, AUTOINDEX (counterpart of the JAX package's
``vdms/indexes.py``).

Every family is declared to the :mod:`~repro_torch.vdms.registry` at the
bottom of this module; ``build_index`` / ``search_index`` dispatch through
it.

Conventions
-----------
* Angular metric: all vectors L2-normalized, similarity = inner product
  (higher is better).
* Sealed segments are stacked into (n_seg, S, d) tensors on one device; each
  segment has its own index. Builds and searches treat the segment axis as
  a batch dimension (the JAX package ``lax.map``s over it), in blocks where
  a gather would otherwise outgrow device memory.
* Every search returns (global_ids, sims), each (n_seg, B, k_seg), with
  -1/-inf on padded slots; the engine merges.
* Every top-k goes through ``topk_stable`` (equal scores keep the lowest
  index), which is ``lax.top_k``'s tie rule.
* Build randomness comes from ``draws`` (:mod:`.draws`): the port's own
  ``torch.Generator`` draws by default. They cannot reproduce ``jax.random``,
  so the tests either inject the JAX package's draws or carry its built
  arrays across with :func:`bundle_from_numpy`.
* Arrays named in a family's ``shared_arrays`` hold calibration state shared
  across segments (quantizer scales, PQ codebooks), not per-segment stacks.
  Incremental builds freeze them after the first sealed segment (``frozen=``,
  from :func:`frozen_state`), like real systems that train quantizers once,
  so per-segment bundles stay concatenable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.space import Param
from ..kernels import ops
from ..kernels.fused_adc import adc_candidate_scores
from ..kernels.fused_scan import probe_candidates
from ..kernels.ref import segment_blocks, topk_stable
from .fused import (fused_search_ivf_pq, fused_search_ivf_sq8, pq_lut, shard_search_ivf_pq,
                    shard_search_ivf_sq8)
from .kmeans import kmeans, kmeans_l2
from .registry import REGISTRY, IndexFamily, get_family

_NEG_INF = float("-inf")


@dataclasses.dataclass
class IndexBundle:
    kind: str
    arrays: Dict[str, torch.Tensor]  # stacked over segments (leading dim n_seg)
    static: Dict[str, Any]  # static search params

    def memory_bytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self.arrays.values()))


def bundle_from_numpy(kind: str, arrays: Dict[str, Any], static: Dict[str, Any],
                      device) -> IndexBundle:
    """The port's bundle from the arrays of a JAX package ``IndexBundle``
    (anything ``np.asarray`` takes), same dtypes (bf16 included), on
    ``device``."""
    out = {}
    for name, a in arrays.items():
        a = np.array(a)  # a writable copy
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(device)
    return IndexBundle(kind=kind, arrays=out, static=dict(static))


# =========================================================================
# helpers
# =========================================================================
def _storage(segs: torch.Tensor, bf16: bool) -> torch.Tensor:
    return segs.to(torch.bfloat16 if bf16 else torch.float32)


def _member_lists(assign: torch.Tensor, nlist: int, cap: int) -> torch.Tensor:
    """(…, nlist, cap) local-id lists, -1 padded, from cluster assignments
    (…, s); overflow beyond cap is dropped (mirrors real systems' bounded
    per-cluster scan). Members keep ascending id order within a cluster:
    one stable sort + a rank-within-cluster scatter, batched over segments."""
    shape = assign.shape
    a = assign.reshape(-1, shape[-1]).long()
    n_seg, s = a.shape
    sa, order = torch.sort(a, dim=1, stable=True)
    counts = torch.zeros((n_seg, nlist), dtype=torch.long, device=a.device)
    counts.scatter_add_(1, a, torch.ones_like(a))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(s, device=a.device)[None, :] - torch.gather(starts, 1, sa)
    keep = pos < cap
    out = torch.full((n_seg, nlist, cap), -1, dtype=torch.int32, device=a.device)
    z = torch.arange(n_seg, device=a.device)[:, None].expand(n_seg, s)
    out[z[keep], sa[keep], pos[keep]] = order[keep].to(torch.int32)
    return out.reshape(*shape[:-1], nlist, cap)


def _ivf_cap(seg_size: int, nlist: int, nprobe: int) -> int:
    cap = int(2.5 * seg_size / nlist) + 8
    if nprobe * cap > seg_size + 8 * nprobe:
        cap = max(8, seg_size // max(nprobe, 1) + 8)
    return cap


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of per-segment tables (z, s, w) at local ids idx (z, ...) ->
    (z, ..., w)."""
    z = torch.arange(table.shape[0], device=table.device).reshape(-1, *([1] * (idx.dim() - 1)))
    return table[z, idx.long()]


def _pad_width(ids, sims, k_seg):
    k = ids.shape[-1]
    if k < k_seg:
        ids = torch.nn.functional.pad(ids, (0, k_seg - k), value=-1)
        sims = torch.nn.functional.pad(sims, (0, k_seg - k), value=_NEG_INF)
    return ids, sims


def _finish_candidates(cand, sims, gids, k_seg):
    """Composed epilogue: mask padded candidates, per-segment top-k, map to
    global ids (dead gids -> -1/-inf), pad to ``k_seg``."""
    sims = sims.masked_fill(cand < 0, _NEG_INF)
    top_s, top_i = topk_stable(sims, min(k_seg, sims.shape[-1]))
    lids = torch.gather(cand, -1, top_i)
    n_seg = gids.shape[0]
    g = torch.gather(gids, 1, lids.clamp_min(0).reshape(n_seg, -1).long()).reshape(lids.shape)
    ids = torch.where(lids >= 0, g, torch.full_like(g, -1))
    top_s = top_s.masked_fill(ids < 0, _NEG_INF)
    return _pad_width(ids, top_s, k_seg)


def _blocked(search_block, n_seg, per_seg_elems, *arrays):
    """Run ``search_block`` over blocks of segments and concatenate."""
    ids, sims = [], []
    for blk in segment_blocks(n_seg, per_seg_elems):
        i, s = search_block(*(a[blk] for a in arrays))
        ids.append(i)
        sims.append(s)
    return torch.cat(ids), torch.cat(sims)


# =========================================================================
# FLAT — exhaustive
# =========================================================================
def build_flat(draws, segs, gids, params, sys) -> IndexBundle:
    return IndexBundle(
        kind="FLAT", arrays={"data": _storage(segs, sys["storage_bf16"]), "gids": gids}, static={}
    )


def _search_flat(q, arrays, *, k_seg: int, impl=None):
    gids = arrays["gids"]
    sims = ops.batched_ip(q, arrays["data"], impl=impl)  # (n_seg, B, S), one launch
    sims = sims.masked_fill(gids[:, None, :] < 0, _NEG_INF)
    top_s, top_i = topk_stable(sims, k_seg)
    ids = torch.gather(gids[:, None, :].expand(-1, q.shape[0], -1), 2, top_i)
    return ids, top_s


# =========================================================================
# IVF family
# =========================================================================
def _build_ivf_common(draws, segs, nlist, kmeans_iters):
    n_seg, s, d = segs.shape
    nlist = int(min(max(nlist, 4), max(s // 8, 4)))
    cents, assigns = kmeans(segs, nlist, kmeans_iters, init_idx=draws.coarse(n_seg, s, nlist))
    return nlist, cents, assigns


def build_ivf_flat(draws, segs, gids, params, sys) -> IndexBundle:
    nlist, cents, assigns = _build_ivf_common(draws, segs, params["nlist"], sys["kmeans_iters"])
    nprobe = int(min(params["nprobe"], nlist))
    cap = _ivf_cap(segs.shape[1], nlist, nprobe)
    return IndexBundle(
        kind="IVF_FLAT",
        arrays={
            "data": _storage(segs, sys["storage_bf16"]),
            "gids": gids,
            "centroids": cents,
            "members": _member_lists(assigns, nlist, cap),
        },
        static={"nprobe": nprobe},
    )


def _search_ivf_flat(q, arrays, *, k_seg: int, nprobe: int):
    _, nlist, cap = arrays["members"].shape
    per_seg = q.shape[0] * min(nprobe, nlist) * cap * q.shape[1]

    def block(data, gids, cents, members):
        cand = probe_candidates(q, cents, members, nprobe)  # (z, B, P)
        vecs = _gather_rows(data, cand.clamp_min(0)).float()  # (z, B, P, d)
        sims = torch.einsum("zbpd,bd->zbp", vecs, q)
        return _finish_candidates(cand, sims, gids, k_seg)

    return _blocked(block, arrays["gids"].shape[0], per_seg, arrays["data"], arrays["gids"],
                    arrays["centroids"], arrays["members"])


def _sq8_encode(segs, frozen=None):
    """int8 codes with one scale per dimension shared by every segment (the
    frozen one when given)."""
    if frozen is None:
        scale = segs.abs().amax(dim=(0, 1)) / 127.0 + 1e-12  # (d,)
    else:
        scale = frozen["scale"]
    codes = torch.clamp(torch.round(segs / scale), -127, 127).to(torch.int8)
    return codes, scale


def build_ivf_sq8(draws, segs, gids, params, sys, frozen=None) -> IndexBundle:
    nlist, cents, assigns = _build_ivf_common(draws, segs, params["nlist"], sys["kmeans_iters"])
    nprobe = int(min(params["nprobe"], nlist))
    cap = _ivf_cap(segs.shape[1], nlist, nprobe)
    codes, scale = _sq8_encode(segs, frozen)
    return IndexBundle(
        kind="IVF_SQ8",
        arrays={
            "codes": codes,
            "scale": scale,
            "gids": gids,
            "centroids": cents,
            "members": _member_lists(assigns, nlist, cap),
        },
        static={"nprobe": nprobe},
    )


def _search_ivf_sq8(q, arrays, *, k_seg: int, nprobe: int):
    scale = arrays["scale"]
    _, nlist, cap = arrays["members"].shape
    per_seg = q.shape[0] * min(nprobe, nlist) * cap * q.shape[1]

    def block(codes, gids, cents, members):
        cand = probe_candidates(q, cents, members, nprobe)
        vecs = _gather_rows(codes, cand.clamp_min(0)).float() * scale
        sims = torch.einsum("zbpd,bd->zbp", vecs, q)
        return _finish_candidates(cand, sims, gids, k_seg)

    return _blocked(block, arrays["gids"].shape[0], per_seg,
                    arrays["codes"], arrays["gids"], arrays["centroids"], arrays["members"])


def _pq_encode(segs, cb):
    """Nearest codeword per subspace: segs (n_seg, s, d), cb (m, c, dsub) ->
    (n_seg, s, m) uint8."""
    n_seg, s, d = segs.shape
    m, c, dsub = cb.shape
    x = segs.reshape(n_seg * s, m, dsub)
    codes = torch.empty((n_seg * s, m), dtype=torch.uint8, device=segs.device)
    for j in range(m):
        xj = x[:, j]
        d2 = (xj**2).sum(1)[:, None] - 2.0 * (xj @ cb[j].T) + (cb[j] ** 2).sum(1)[None, :]
        codes[:, j] = d2.argmin(dim=1).to(torch.uint8)
    return codes.reshape(n_seg, s, m)


def build_ivf_pq(draws, segs, gids, params, sys, frozen=None) -> IndexBundle:
    n_seg, s, d = segs.shape
    m = int(params["m"])
    while d % m != 0:  # snap to a divisor of d
        m -= 1
    c = 2 ** int(params["nbits"])
    nlist, cents, assigns = _build_ivf_common(draws, segs, params["nlist"], sys["kmeans_iters"])
    nprobe = int(min(params["nprobe"], nlist))
    cap = _ivf_cap(s, nlist, nprobe)
    dsub = d // m
    if frozen is None:
        # codebooks shared across segments, trained on the pooled sample
        pool = segs.reshape(-1, m, dsub)
        sample = pool[:: max(1, pool.shape[0] // 8192)]
        cb, _ = kmeans_l2(sample.transpose(0, 1).contiguous(), c, sys["kmeans_iters"],
                          init_idx=draws.codebooks(m, sample.shape[0], c))  # (m, c, dsub)
    else:
        cb = frozen["codebooks"]
    return IndexBundle(
        kind="IVF_PQ",
        arrays={
            "codes": _pq_encode(segs, cb),
            "codebooks": cb,
            "gids": gids,
            "centroids": cents,
            "members": _member_lists(assigns, nlist, cap),
        },
        static={"nprobe": nprobe, "m": m, "c": c},
    )


def _search_ivf_pq(q, arrays, *, k_seg: int, nprobe: int, m: int, c: int):
    lut = pq_lut(q, arrays["codebooks"])  # (B, m, c)
    _, nlist, cap = arrays["members"].shape
    per_seg = q.shape[0] * min(nprobe, nlist) * cap * m

    def block(codes, gids, cents, members):
        cand = probe_candidates(q, cents, members, nprobe)
        return _finish_candidates(cand, adc_candidate_scores(lut, codes, cand), gids, k_seg)

    return _blocked(block, arrays["gids"].shape[0], per_seg,
                    arrays["codes"], arrays["gids"], arrays["centroids"], arrays["members"])


# =========================================================================
# HNSW (NSW-style kNN graph + diversity pruning + shortcut links)
# =========================================================================
def _prune(data, cand_i, cand_s, m_links):
    """HNSW diversity heuristic for a block of nodes of one segment stack:
    repeatedly select the best remaining candidate and drop candidates that
    are closer to it than to the node. data (n_seg, s, d) f32; cand_i,
    cand_s (n_seg, s, efc) -> (n_seg, s, m_links) int32 local ids."""
    n_seg, s, d = data.shape
    efc = cand_i.shape[2]
    flat = data.reshape(n_seg * s, d)
    off = (torch.arange(n_seg, device=data.device) * s)[:, None]
    ci_all = cand_i.reshape(n_seg * s, efc)
    cs_all = cand_s.reshape(n_seg * s, efc)
    rows_all = torch.arange(s, device=data.device).repeat(n_seg)
    off_all = off.expand(n_seg, s).reshape(-1)
    sel = torch.empty((n_seg * s, m_links), dtype=torch.int32, device=data.device)
    col = torch.arange(efc, device=data.device)[None, :]
    step = max(1, (1 << 27) // (efc * d))
    for r0 in range(0, n_seg * s, step):
        r = slice(r0, min(r0 + step, n_seg * s))
        ci, cs, rows, o = ci_all[r].long(), cs_all[r], rows_all[r], off_all[r]
        cv = flat[ci + o[:, None]]  # (C, efc, d), loop-invariant
        alive = torch.isfinite(cs)
        for t in range(m_links):
            j = torch.where(alive, cs, _NEG_INF).argmax(dim=1)  # first max, as jnp.argmax
            ok = torch.gather(alive, 1, j[:, None])[:, 0]
            pick = torch.where(ok, torch.gather(ci, 1, j[:, None])[:, 0], rows)
            sel[r, t] = pick.to(torch.int32)
            pv = flat[pick + o]  # (C, d)
            sim_to_pick = torch.bmm(cv, pv[:, :, None])[:, :, 0]
            alive = alive & (sim_to_pick <= cs) & (col != j[:, None])
    return sel.reshape(n_seg, s, m_links)


def _build_graph(data: torch.Tensor, m_links: int, ef_construction: int,
                 shortcuts) -> torch.Tensor:
    """Graphs of a segment stack (n_seg, s, d): exact kNN candidates + the
    HNSW diversity heuristic, with the small-world ``shortcuts`` (s, n_rand),
    one draw shared by every segment, in the last columns."""
    n_seg, s, d = data.shape
    efc = min(ef_construction, s - 1)
    graphs = []
    for blk in segment_blocks(n_seg, s * s, budget=1 << 27):
        x = data[blk]
        sims = torch.bmm(x, x.transpose(1, 2))
        sims.diagonal(dim1=1, dim2=2).fill_(_NEG_INF)  # no self
        cand_s, cand_i = topk_stable(sims, efc)
        del sims
        graphs.append(_prune(x, cand_i, cand_s, m_links))
    graph = torch.cat(graphs)
    n_rand = shortcuts.shape[1]
    graph[:, :, -n_rand:] = torch.as_tensor(shortcuts, device=data.device).to(torch.int32)
    return graph


def build_hnsw(draws, segs, gids, params, sys) -> IndexBundle:
    n_seg, s, d = segs.shape
    m_links = int(max(4, min(params["M"], 64)))
    efc = int(min(max(params["efConstruction"], 16), s - 1))
    ef = int(min(max(params["ef"], 8), s))
    shortcuts = draws.shortcuts(s, max(1, m_links // 8), m_links)
    return IndexBundle(
        kind="HNSW",
        arrays={
            "data": _storage(segs, sys["storage_bf16"]),
            "gids": gids,
            "graph": _build_graph(segs, m_links, efc, shortcuts),
        },
        static={"ef": ef, "m_links": m_links},
    )


def _search_hnsw(q, arrays, *, k_seg: int, ef: int, m_links: int):
    """Beam search of every segment's graph at once: the beam state is
    (n_seg, B, ef), each of the ``ef`` steps expands the best unexpanded
    beam entry of every (segment, query) pair."""
    data, gids, graph = arrays["data"], arrays["gids"], arrays["graph"]
    n_seg, s, d = data.shape
    b = q.shape[0]
    dev = q.device
    z = torch.arange(n_seg, device=dev)[:, None, None]

    def score(ids):  # (n_seg, B, w) local ids -> sims
        return torch.einsum("zbwd,bd->zbw", data[z, ids].float(), q)

    n_entry = min(4, ef)
    entries = torch.arange(n_entry, device=dev) * (s // max(n_entry, 1))
    beam_ids = entries.expand(n_seg, b, n_entry)
    beam_sims = score(beam_ids)
    beam_ids = torch.nn.functional.pad(beam_ids, (0, ef - n_entry), value=0)
    beam_sims = torch.nn.functional.pad(beam_sims, (0, ef - n_entry), value=_NEG_INF)
    expanded = torch.zeros((n_seg, b, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((n_seg, b, s), dtype=torch.bool, device=dev)
    visited.scatter_(2, beam_ids, True)
    for _ in range(ef):
        sc = beam_sims.masked_fill(expanded | ~torch.isfinite(beam_sims), _NEG_INF)
        j = sc.argmax(dim=2, keepdim=True)  # (n_seg, B, 1)
        has = torch.isfinite(torch.gather(sc, 2, j))
        expanded = expanded.scatter(2, j, True)
        node = torch.gather(beam_ids, 2, j)[..., 0]  # (n_seg, B)
        nbrs = graph[z[..., 0], node].long()  # (n_seg, B, M)
        seen = torch.gather(visited, 2, nbrs)
        visited.scatter_(2, nbrs, True)
        nsims = score(nbrs).masked_fill(seen | ~has, _NEG_INF)
        all_ids = torch.cat([beam_ids, nbrs], dim=2)
        all_sims = torch.cat([beam_sims, nsims], dim=2)
        all_exp = torch.cat([expanded, torch.zeros_like(seen)], dim=2)
        beam_sims, top_i = topk_stable(all_sims, ef)
        beam_ids = torch.gather(all_ids, 2, top_i)
        expanded = torch.gather(all_exp, 2, top_i)
    top_s, top_i = topk_stable(beam_sims, min(k_seg, ef))
    lids = torch.gather(beam_ids, 2, top_i)
    g = torch.gather(gids, 1, lids.reshape(n_seg, -1)).reshape(lids.shape)
    ids = torch.where(torch.isfinite(top_s), g, torch.full_like(g, -1))
    top_s = top_s.masked_fill(ids < 0, _NEG_INF)
    return _pad_width(ids, top_s, k_seg)


# =========================================================================
# SCANN — IVF + int8 score-aware quantized scan + exact re-ranking
# =========================================================================
def build_scann(draws, segs, gids, params, sys, frozen=None) -> IndexBundle:
    nlist, cents, assigns = _build_ivf_common(draws, segs, params["nlist"], sys["kmeans_iters"])
    nprobe = int(min(params["nprobe"], nlist))
    cap = _ivf_cap(segs.shape[1], nlist, nprobe)
    codes, scale = _sq8_encode(segs, frozen)
    reorder_k = int(max(params["reorder_k"], 1))
    return IndexBundle(
        kind="SCANN",
        arrays={
            "codes": codes,
            "scale": scale,
            "data": _storage(segs, sys["storage_bf16"]),
            "gids": gids,
            "centroids": cents,
            "members": _member_lists(assigns, nlist, cap),
        },
        static={"nprobe": nprobe, "reorder_k": reorder_k},
    )


def _search_scann(q, arrays, *, k_seg: int, nprobe: int, reorder_k: int):
    scale = arrays["scale"]
    _, nlist, cap = arrays["members"].shape
    per_seg = q.shape[0] * min(nprobe, nlist) * cap * q.shape[1]

    def block(codes, data, gids, cents, members):
        cand = probe_candidates(q, cents, members, nprobe)
        vecs = _gather_rows(codes, cand.clamp_min(0)).float() * scale
        approx = torch.einsum("zbpd,bd->zbp", vecs, q).masked_fill(cand < 0, _NEG_INF)
        _, top_r = topk_stable(approx, min(reorder_k, approx.shape[-1]))
        rcand = torch.gather(cand, 2, top_r)
        exact = torch.einsum("zbrd,bd->zbr", _gather_rows(data, rcand.clamp_min(0)).float(), q)
        return _finish_candidates(rcand, exact, gids, k_seg)

    return _blocked(block, arrays["gids"].shape[0], per_seg, arrays["codes"], arrays["data"],
                    arrays["gids"], arrays["centroids"], arrays["members"])


# =========================================================================
# AUTOINDEX — delegated IVF_FLAT build with derived parameters
# =========================================================================
def build_autoindex(draws, segs, gids, params, sys) -> IndexBundle:
    s = segs.shape[1]
    auto = {"nlist": max(4, int(np.sqrt(s) * 2)), "nprobe": 16}
    return build_ivf_flat(draws, segs, gids, auto, sys)


# =========================================================================
# analytic cost hooks (identical arithmetic to the JAX package)
# =========================================================================
def _chunk_cost_flat(st, arrays, n_sealed, seg_size, dim):
    return n_sealed * seg_size * dim * 2, 0


def _chunk_cost_ivf(bytes_scale: float):
    def cost(st, arrays, n_sealed, seg_size, dim):
        nlist = arrays["centroids"].shape[1]
        cap = arrays["members"].shape[2]
        return n_sealed * (nlist * dim + st["nprobe"] * cap * dim * bytes_scale) * 2, 0

    return cost


def _chunk_cost_ivf_pq(st, arrays, n_sealed, seg_size, dim):
    nlist = arrays["centroids"].shape[1]
    cap = arrays["members"].shape[2]
    flops = n_sealed * (
        nlist * dim * 2 + st["m"] * st["c"] * (dim // st["m"]) * 2 + st["nprobe"] * cap * st["m"]
    )
    return flops, 0


def _chunk_cost_hnsw(st, arrays, n_sealed, seg_size, dim):
    return n_sealed * st["ef"] * st["m_links"] * dim * 2, st["ef"]


def _chunk_cost_scann(st, arrays, n_sealed, seg_size, dim):
    nlist = arrays["centroids"].shape[1]
    cap = arrays["members"].shape[2]
    flops = n_sealed * (nlist * dim * 2 + st["nprobe"] * cap * dim + st["reorder_k"] * dim * 2)
    return flops, 0


def _build_cost_ivf_common(config, seg_size, dim):
    it = int(config.get("kmeans_iters", 8))
    nlist = int(config.get("nlist", max(4, int(np.sqrt(seg_size) * 2))))
    nlist = int(min(max(nlist, 4), max(seg_size // 8, 4)))
    return it * nlist * seg_size * dim * 2


def _build_cost_ivf_flat(config, seg_size, dim, first_build):
    return _build_cost_ivf_common(config, seg_size, dim)


def _build_cost_sq(config, seg_size, dim, first_build):
    return _build_cost_ivf_common(config, seg_size, dim) + seg_size * dim * 2


def _build_cost_ivf_pq(config, seg_size, dim, first_build):
    flops = _build_cost_ivf_common(config, seg_size, dim)
    it = int(config.get("kmeans_iters", 8))
    m = int(config.get("m", 8))
    while dim % m != 0:
        m -= 1
    c = 2 ** int(config.get("nbits", 8))
    dsub = dim // m
    flops += seg_size * m * c * dsub * 2  # encode
    if first_build:
        flops += it * m * c * min(seg_size, 8192) * dsub * 2  # codebook training
    return flops


def _build_cost_hnsw(config, seg_size, dim, first_build):
    efc = int(min(max(int(config.get("efConstruction", 128)), 16), max(seg_size - 1, 1)))
    m_links = int(max(4, min(int(config.get("M", 16)), 64)))
    return seg_size * seg_size * dim * 2 + seg_size * m_links * efc * dim


# =========================================================================
# registry dispatch
# =========================================================================
def build_index(draws, segs, gids, index_type: str, params: Dict, sys: Dict,
                frozen: Optional[Dict[str, torch.Tensor]] = None) -> IndexBundle:
    """Build per-segment indexes for the stacked segments ``(n_seg, S, d)``
    (f32 tensor; ``gids`` (n_seg, S) int32 on the same device). ``draws``
    (a :class:`~repro_torch.vdms.draws.BuildDraws` or a stand-in with its
    methods) supplies every build-side random draw. ``frozen`` (from
    :func:`frozen_state`) reuses a previous build's shared calibration
    (SQ8/SCANN scales, PQ codebooks) instead of training it: the incremental
    path of live instances sealing one segment at a time."""
    family = get_family(index_type)
    if not frozen:  # nothing to reuse (a family without shared calibration)
        return family.build(draws, segs, gids, params, sys)
    return family.build(draws, segs, gids, params, sys, frozen=frozen)


def frozen_state(bundle: IndexBundle) -> Dict[str, torch.Tensor]:
    """The segment-shared calibration arrays (the family's declared
    ``shared_arrays``) to freeze for incremental builds; empty for families
    without shared state."""
    family = get_family(bundle.kind)
    if not family.supports_frozen:
        return {}
    return {k: bundle.arrays[k] for k in family.shared_arrays if k in bundle.arrays}


def _check_same_layout(a: IndexBundle, b: IndexBundle, what: str) -> None:
    if a.kind != b.kind or a.static != b.static:
        raise ValueError(f"cannot {what} bundles: kind/static mismatch "
                         f"({a.kind}/{a.static} vs {b.kind}/{b.static})")


def concat_bundles(a: IndexBundle, b: IndexBundle) -> IndexBundle:
    """Concatenate two bundles of the same kind/statics along the segment
    axis. Shared calibration arrays must be frozen-compatible and are taken
    from ``a`` (the incremental-build contract)."""
    _check_same_layout(a, b, "concat")
    shared = get_family(a.kind).shared_arrays
    arrays = {k: av if k in shared else torch.cat([av, b.arrays[k]]) for k, av in a.arrays.items()}
    return IndexBundle(kind=a.kind, arrays=arrays, static=dict(a.static))


def replace_segment(bundle: IndexBundle, z: int, seg_bundle: IndexBundle) -> IndexBundle:
    """A copy of ``bundle`` with the single-segment ``seg_bundle`` spliced
    into position ``z``: the compaction path (tombstoned vectors dropped,
    shapes preserved)."""
    _check_same_layout(bundle, seg_bundle, "splice")
    shared = get_family(bundle.kind).shared_arrays
    arrays = {}
    for k, av in bundle.arrays.items():
        if k not in shared:
            av = av.clone()
            av[z] = seg_bundle.arrays[k][0]
        arrays[k] = av
    return IndexBundle(kind=bundle.kind, arrays=arrays, static=dict(bundle.static))


def search_index(bundle: IndexBundle, q: torch.Tensor, k_seg: int):
    """Returns (ids, sims) of shape (n_seg, B, k_seg), merged by the engine."""
    return get_family(bundle.kind).search(q, bundle.arrays, k_seg=k_seg, **bundle.static)


# =========================================================================
# built-in family registrations (declaration order == the JAX package's,
# so the registry-derived SearchSpace is identical)
# =========================================================================
_NLIST = (16, 32, 64, 128, 256, 512)
_NPROBE = (1, 2, 4, 8, 16, 32, 64, 128)

REGISTRY.register(IndexFamily(
    name="FLAT", params=(), build=build_flat, search=_search_flat,
    chunk_cost=_chunk_cost_flat, description="exhaustive inner-product scan",
))
REGISTRY.register(IndexFamily(
    name="IVF_FLAT",
    params=(
        Param("nlist", "grid", choices=_NLIST, default=128),
        Param("nprobe", "grid", choices=_NPROBE, default=8),
    ),
    build=build_ivf_flat, search=_search_ivf_flat,
    chunk_cost=_chunk_cost_ivf(1.0), build_cost=_build_cost_ivf_flat,
    description="inverted file over kmeans cells, raw vectors",
))
REGISTRY.register(IndexFamily(
    name="IVF_SQ8",
    params=(
        Param("nlist", "grid", choices=_NLIST, default=128),
        Param("nprobe", "grid", choices=_NPROBE, default=8),
    ),
    build=build_ivf_sq8, search=_search_ivf_sq8,
    shared_arrays=("scale",), supports_frozen=True,
    fused_search=fused_search_ivf_sq8, shard_search=shard_search_ivf_sq8,
    chunk_cost=_chunk_cost_ivf(0.5), build_cost=_build_cost_sq,
    description="IVF over int8 scalar-quantized codes",
))
REGISTRY.register(IndexFamily(
    name="IVF_PQ",
    params=(
        Param("nlist", "grid", choices=_NLIST, default=128),
        Param("m", "grid", choices=(4, 8, 16, 32), default=8),
        Param("nbits", "grid", choices=(4, 6, 8), default=8),
        Param("nprobe", "grid", choices=_NPROBE, default=8),
    ),
    build=build_ivf_pq, search=_search_ivf_pq,
    shared_arrays=("codebooks",), supports_frozen=True,
    fused_search=fused_search_ivf_pq, shard_search=shard_search_ivf_pq,
    chunk_cost=_chunk_cost_ivf_pq, build_cost=_build_cost_ivf_pq,
    description="IVF + product quantization (ADC lookup scan)",
))
REGISTRY.register(IndexFamily(
    name="HNSW",
    params=(
        Param("M", "grid", choices=(8, 16, 32, 48), default=16),
        Param("efConstruction", "grid", choices=(32, 64, 128, 256), default=128),
        Param("ef", "grid", choices=(16, 32, 64, 128, 256), default=64),
    ),
    build=build_hnsw, search=_search_hnsw,
    chunk_cost=_chunk_cost_hnsw, build_cost=_build_cost_hnsw,
    description="NSW-style kNN graph with beam search",
))
REGISTRY.register(IndexFamily(
    name="SCANN",
    params=(
        Param("nlist", "grid", choices=_NLIST, default=128),
        Param("nprobe", "grid", choices=_NPROBE, default=8),
        Param("reorder_k", "grid", choices=(32, 64, 128, 256, 512), default=64),
    ),
    build=build_scann, search=_search_scann,
    shared_arrays=("scale",), supports_frozen=True,
    chunk_cost=_chunk_cost_scann, build_cost=_build_cost_sq,
    description="IVF + int8 quantized scan + exact re-ranking",
))
REGISTRY.register(IndexFamily(
    name="AUTOINDEX",
    params=(),
    build=build_autoindex,
    # builds IVF_FLAT-kind bundles, so bundle-keyed dispatch uses the
    # IVF_FLAT family's hooks; build_cost is live (dispatched on index_type)
    search=_search_ivf_flat,
    builds_kind="IVF_FLAT",
    chunk_cost=_chunk_cost_ivf(1.0),
    build_cost=_build_cost_ivf_flat,
    description="auto-derived IVF_FLAT (nlist ~ 2*sqrt(S), nprobe=16)",
))
