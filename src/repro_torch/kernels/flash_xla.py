"""Block-scanned flash attention in plain PyTorch, with process-wide block
sizes: the port of ``repro/kernels/flash_xla.py``.

This is a plain version. No path on the card calls it: there the CUDA
kernels of ``flash_attention.py`` run, with tiles of their own. It is the
attention that the dry-run counts (``launch/dryrun.py``), as the JAX
package's dry-run compiles ``flash_xla``, and the serving tuner's
``flash_bq`` / ``flash_bk`` set its blocks (``set_default_blocks``).

* forward: for each block of ``bq`` queries, a loop over blocks of ``bk``
  keys carrying the online (max, normaliser, accumulator); the (sq, sk)
  score matrix exists one (bq, bk) block at a time;
* backward (``_bwd``): the probabilities recomputed from (q, k, lse) a
  block at a time; dq summed per query block, dk and dv across them.

Both pad q, k and v to whole blocks and compute every block, masked ones
included, as XLA runs ``flash_xla``'s scans. GQA: the ``g`` query heads of
a kv head share one batched product (``b * hkv`` batches of ``g * bq``
rows), so dk and dv come out summed over the group. Causal masks, sliding
windows and queries at the tail of a longer key axis (``q_off = sk - sq``)
enter as an additive bias of 0 or -1e30 on the scores.

:func:`cost` is the closed form of what one call of the forward or the
backward does at the blocks in effect: products' FLOPs, bytes (each aten
op's inputs read once and outputs written once, views free) and the peak
bytes it holds. :func:`kernel_cost` is the least work of the card's flash
kernels for the same call: the products over the visible (query, key)
pairs, and each input read once and each output written once.
``ops.flash_attention`` on ``meta`` tensors reports both to the dry-run's
counter (:func:`cost_sink`) instead of running anything.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

_NEG = -1e30

# process-wide default block sizes (tunable: see tuning/serve_tuner.py)
DEFAULT_BQ = 512
DEFAULT_BK = 1024

# the dry-run's receiver of meta-route costs (a module global, not a
# thread-local: autograd may run a backward on a thread of its own)
_SINK: Optional[Callable[[Dict[str, float]], None]] = None


def set_default_blocks(bq: int, bk: int) -> None:
    global DEFAULT_BQ, DEFAULT_BK
    DEFAULT_BQ, DEFAULT_BK = int(bq), int(bk)


def get_default_blocks() -> Tuple[int, int]:
    """Current process-wide (bq, bk): pair with ``set_default_blocks`` to
    save and restore around a scoped override."""
    return DEFAULT_BQ, DEFAULT_BK


def _geometry(q, k, bq: int, bk: int):
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    bq, bk = min(bq, sq), min(bk, sk)
    return b, sq, sk, hq, hkv, dh, bq, bk, -(-sq // bq), -(-sk // bk)


def _copy(x):
    """A contiguous copy, always (the layouts below are reshaped as views)."""
    return x.clone(memory_format=torch.contiguous_format)


def _q_blocks(x, hkv: int, bq: int, nqb: int, scale: Optional[float]):
    """(b, sq, hq, dh) -> f32 (nqb, b * hkv, g * bq, dh), zero-padded to
    whole blocks, times ``scale`` when given."""
    b, sq, hq, dh = x.shape
    g = hq // hkv
    x = x.to(torch.float32)
    if scale is not None:
        x = x * scale
    x = F.pad(x, (0, 0, 0, 0, 0, nqb * bq - sq))
    x = _copy(x.view(b, nqb, bq, hkv, g, dh).permute(1, 0, 3, 4, 2, 5))
    return x.view(nqb, b * hkv, g * bq, dh)


def _kv_blocks(x, bk: int, nkb: int):
    """(b, sk, hkv, dh) -> f32 (nkb, b * hkv, bk, dh), zero-padded."""
    b, sk, hkv, dh = x.shape
    x = F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, nkb * bk - sk))
    return _copy(x.view(b, nkb, bk, hkv, dh).permute(1, 0, 3, 2, 4)).view(nkb, b * hkv, bk, dh)


def _row_blocks(x, hkv: int, bq: int, nqb: int):
    """Per-row f32 values (b, sq, hq) -> (nqb, b * hkv, g * bq), padded."""
    b, sq, hq = x.shape
    x = F.pad(x, (0, 0, 0, nqb * bq - sq))
    return _copy(x.view(b, nqb, bq, hkv, hq // hkv).permute(1, 0, 3, 4, 2)).view(nqb, b * hkv, -1)


def _unblock(x, b: int, hkv: int, bq: int, s: int, dtype):
    """(nqb, b * hkv, g * bq, ...) -> (b, s, hkv * g, ...) in ``dtype``."""
    nqb, _, rows = x.shape[:3]
    g = rows // bq
    tail = x.shape[3:]
    x = _copy(x.view(nqb, b, hkv, g, bq, *tail).permute(1, 0, 4, 2, 3, *range(5, 5 + len(tail))))
    return x.view(b, nqb * bq, hkv * g, *tail)[:, :s].to(dtype)


def _bias(rows, kpos, sk: int, causal: bool, window: Optional[int]):
    """The (g * bq, bk) f32 additive mask of one block pair: 0 where query
    ``rows[r]`` sees key ``kpos[c]``, -1e30 elsewhere (padded keys too)."""
    ok = kpos[None, :] < sk
    if causal:
        ok = ok & (kpos[None, :] <= rows[:, None])
    if window is not None:
        ok = ok & (kpos[None, :] > (rows - window)[:, None])
    bias = torch.zeros((rows.shape[0], kpos.shape[0]), dtype=torch.float32, device=kpos.device)
    return bias.masked_fill_(~ok, _NEG)


def _positions(g: int, bq: int, bk: int, device):
    """Within-block query offsets of the g * bq rows, and key offsets."""
    return torch.arange(g * bq, device=device) % bq, torch.arange(bk, device=device)


def _forward(q, k, v, causal: bool, window: Optional[int], bq: int, bk: int):
    """(out (b, sq, hq, dh) in q's dtype, lse (b, sq, hq) f32): the online
    softmax over kv blocks for each q block."""
    b, sq, sk, hq, hkv, dh, bq, bk, nqb, nkb = _geometry(q, k, bq, bk)
    g = hq // hkv
    q_off = sk - sq
    qb = _q_blocks(q, hkv, bq, nqb, dh**-0.5)
    kb, vb = _kv_blocks(k, bk, nkb), _kv_blocks(v, bk, nkb)
    row0, key0 = _positions(g, bq, bk, q.device)
    bh, r = b * hkv, g * bq
    outs, lses = [], []
    for i in range(nqb):
        rows = row0 + (q_off + i * bq)
        m = torch.full((bh, r), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, r), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, r, dh), dtype=torch.float32, device=q.device)
        for j in range(nkb):
            bias = _bias(rows, key0 + j * bk, sk, causal, window)
            s = torch.baddbmm(bias, qb[i], kb[j].transpose(1, 2))
            m_new = torch.maximum(m, s.amax(-1))
            p = s.sub_(m_new[..., None]).exp_()
            alpha = torch.exp(m - m_new)
            l = l.mul_(alpha).add_(p.sum(-1))
            acc = torch.baddbmm(acc.mul_(alpha[..., None]), p, vb[j])
            m = m_new
            del bias, s, p, alpha, m_new
        l = l.clamp_(min=1e-30)
        outs.append(acc.div_(l[..., None]))
        lses.append(l.log_().add_(m))
        del acc, m, l
    out = _unblock(torch.stack(outs), b, hkv, bq, sq, q.dtype)
    lse = _unblock(torch.stack(lses), b, hkv, bq, sq, torch.float32)
    return out, lse


def _bwd(causal: bool, window: Optional[int], bq: int, bk: int, res, dout):
    """``flash_xla.py::_bwd``'s blocked formulas: P = exp(S - lse),
    dV += P^T.dO, dS = P * (dO.V^T - rowsum(dO * O)), dQ += dS.K * scale,
    dK += dS^T.(Q * scale); f32 accumulators, results in the inputs' dtypes."""
    q, k, v, out, lse = res
    b, sq, sk, hq, hkv, dh, bq, bk, nqb, nkb = _geometry(q, k, bq, bk)
    g = hq // hkv
    q_off = sk - sq
    scale = dh**-0.5
    qb = _q_blocks(q, hkv, bq, nqb, scale)
    kb, vb = _kv_blocks(k, bk, nkb), _kv_blocks(v, bk, nkb)
    dob = _q_blocks(dout, hkv, bq, nqb, None)
    lse_b = _row_blocks(lse, hkv, bq, nqb)
    delta_b = _row_blocks((dout.to(torch.float32) * out.to(torch.float32)).sum(-1), hkv, bq, nqb)
    row0, key0 = _positions(g, bq, bk, q.device)
    bh, r = b * hkv, g * bq
    dk = [torch.zeros((bh, bk, dh), dtype=torch.float32, device=q.device) for _ in range(nkb)]
    dv = [torch.zeros((bh, bk, dh), dtype=torch.float32, device=q.device) for _ in range(nkb)]
    dqs = []
    for i in range(nqb):
        rows = row0 + (q_off + i * bq)
        dq = torch.zeros((bh, r, dh), dtype=torch.float32, device=q.device)
        for j in range(nkb):
            bias = _bias(rows, key0 + j * bk, sk, causal, window)
            p = torch.baddbmm(bias, qb[i], kb[j].transpose(1, 2)).sub_(lse_b[i][..., None]).exp_()
            dv[j] = torch.baddbmm(dv[j], p.transpose(1, 2), dob[i])
            ds = torch.bmm(dob[i], vb[j].transpose(1, 2)).sub_(delta_b[i][..., None]).mul_(p)
            dq = torch.baddbmm(dq, ds, kb[j], alpha=scale)
            dk[j] = torch.baddbmm(dk[j], ds.transpose(1, 2), qb[i])
            del bias, p, ds
        dqs.append(dq)
        del dq
    dq = _unblock(torch.stack(dqs), b, hkv, bq, sq, q.dtype)
    dk = _unblock_kv(torch.stack(dk), b, hkv, sk, k.dtype)
    dv = _unblock_kv(torch.stack(dv), b, hkv, sk, v.dtype)
    return dq, dk, dv


def _unblock_kv(x, b: int, hkv: int, sk: int, dtype):
    """(nkb, b * hkv, bk, dh) -> (b, sk, hkv, dh) in ``dtype``."""
    nkb, _, bk, dh = x.shape
    x = _copy(x.view(nkb, b, hkv, bk, dh).permute(1, 0, 3, 2, 4))
    return x.view(b, nkb * bk, hkv, dh)[:, :sk].to(dtype)


class FlashXLA(torch.autograd.Function):
    """The blocked forward, saving (q, k, v, out, lse); the blocked
    backward (:func:`_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], bq: int, bk: int):
        out, lse = _forward(q, k, v, causal, window, bq, bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention_xla(q, k, v, causal: bool = True, window: Optional[int] = None,
                        bq: Optional[int] = None, bk: Optional[int] = None):
    """Differentiable blocked attention, q (b, sq, hq, dh), k and v (b, sk,
    hkv, dh) -> (b, sq, hq, dh), at ``(bq, bk)`` or the process-wide
    defaults. The queries sit at the tail of the key axis."""
    return FlashXLA.apply(q, k, v, causal, window, bq or DEFAULT_BQ, bk or DEFAULT_BK)


def flash_attention_xla_lse(q, k, v, causal: bool = True, window: Optional[int] = None,
                            bq: Optional[int] = None, bk: Optional[int] = None):
    """The blocked forward's (out, lse), lse (b, sq, hq) f32; no gradient."""
    return _forward(q, k, v, causal, window, bq or DEFAULT_BQ, bk or DEFAULT_BK)


# ---------------------------------------------------------------------------
# the closed-form cost and the meta route
# ---------------------------------------------------------------------------
class _Live:
    """Bytes held, and their peak, as the blocked code allocates and frees."""

    def __init__(self):
        self.now = self.peak = 0

    def alloc(self, *ns):
        for n in ns:
            self.now += n
            self.peak = max(self.peak, self.now)

    def free(self, *ns):
        self.now -= sum(ns)


def cost(b: int, sq: int, sk: int, hq: int, hkv: int, dh: int, dtype: torch.dtype,
         causal: bool = True, window: Optional[int] = None, bq: Optional[int] = None,
         bk: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """What one call of :func:`_forward` (``"fwd"``) and of :func:`_bwd`
    (``"bwd"``) does at ``(bq, bk)`` (the defaults in effect when None),
    every block counted, padded and masked ones included: ``flops`` of the
    products (2 per multiply-add, as ``torch.utils.flop_counter`` counts),
    ``bytes`` (each aten op's tensor inputs read once and its outputs
    written once; views free) and ``temp`` (the most bytes the call holds at
    once beyond its inputs: its padded f32 blocks, one block pair's bias and
    scores, the carries and the finished blocks). q in ``dtype`` (f32 or
    bf16). O(1) in the number of blocks: every block pair does the same
    work, and the most is held during the last q block."""
    bq, bk = min(bq or DEFAULT_BQ, sq), min(bk or DEFAULT_BK, sk)
    nqb, nkb = -(-sq // bq), -(-sk // bk)
    g, bh = hq // hkv, b * hkv
    r = g * bq
    e = torch.empty((), dtype=dtype).element_size()
    cast = e != 4  # f32 inputs skip the casts to f32
    nq, nk = b * sq * hq * dh, b * sk * hkv * dh  # elements of q and of k
    nqp, nkp = nqb * bq * b * hq * dh, nkb * bk * b * hkv * dh  # padded
    nr, nrp = b * sq * hq, nqb * bq * b * hq  # rows (lse, delta)
    rb, kd, sc = bh * r, bh * bk * dh, bh * r * bk  # a q block's rows, a k block, a pair's scores
    rd, pairs = rb * dh, nqb * nkb
    masked = causal or window is not None
    ok = r * bk if masked else bk  # elements of the bool mask

    def to_f32(n):  # bytes of the casts of an n-element input
        return (e + 4) * n if cast else 0

    def q_blocks(scaled):
        return to_f32(nq) + (8 * nq if scaled else 0) + 4 * nq + 4 * nqp + 8 * nqp

    def kv_blocks():
        return to_f32(nk) + 4 * nk + 4 * nkp + 8 * nkp

    bias = 16 * bk + 9 * bk  # kpos, lt
    if causal:
        bias += (8 * bk + 8 * r + r * bk) + (bk + 2 * r * bk)  # le, and
    if window is not None:
        before = r * bk if causal else bk
        bias += 16 * r + (8 * bk + 8 * r + r * bk) + (before + 2 * r * bk)  # sub, gt, and
    bias += 4 * r * bk + 2 * ok + 8 * r * bk + ok  # zeros, not, masked_fill_
    positions = 24 * r + 8 * bk
    scores = 4 * r * bk + 4 * rd + 4 * kd + 4 * sc  # baddbmm(bias, q, k^T)

    fwd_by = q_blocks(True) + 2 * kv_blocks() + positions
    fwd_by += nqb * (16 * r + 8 * rb + 4 * rd)  # rows, m, l, acc
    fwd_by += pairs * (bias + scores
                       + (4 * sc + 4 * rb) + 12 * rb  # amax, maximum
                       + (8 * sc + 4 * rb) + 8 * sc  # sub_, exp_
                       + 12 * rb + 8 * rb  # alpha: sub, exp
                       + 12 * rb + (4 * sc + 4 * rb) + 12 * rb  # mul_, sum, add_
                       + (8 * rd + 4 * rb) + (8 * rd + 4 * sc + 4 * kd))  # mul_, baddbmm
    fwd_by += nqb * (8 * rb + (8 * rd + 4 * rb) + 8 * rb + 12 * rb)  # clamp_, div_, log_, add_
    fwd_by += 16 * nqp + to_f32(nq) + 16 * nrp  # stack, copy and cast of out; of lse

    bwd_by = q_blocks(True) + 2 * kv_blocks() + q_blocks(False)
    bwd_by += (4 * nr + 4 * nrp) + 8 * nrp  # lse blocks
    bwd_by += 2 * to_f32(nq) + 12 * nq + (4 * nq + 4 * nr) + (4 * nr + 4 * nrp) + 8 * nrp  # delta
    bwd_by += positions + 2 * nkb * 4 * kd + nqb * (16 * r + 4 * rd)  # dk, dv; rows, dq
    bwd_by += pairs * (bias + scores + (8 * sc + 4 * rb) + 8 * sc  # p
                       + (8 * kd + 4 * sc + 4 * rd)  # dv
                       + (4 * rd + 4 * kd + 4 * sc) + (8 * sc + 4 * rb) + 12 * sc  # ds
                       + (8 * rd + 4 * sc + 4 * kd) + (8 * kd + 4 * sc + 4 * rd))  # dq, dk
    bwd_by += 16 * nqp + to_f32(nq) + 2 * (16 * nkp + to_f32(nk))  # dq, dk, dv out

    def mask_peak(live):  # _bias, from kpos to the filled bias
        live.alloc(8 * bk, bk)  # kpos, lt
        held = bk
        if causal:
            live.alloc(r * bk, r * bk)  # le, and
            live.free(held, r * bk)
            held = r * bk
        if window is not None:
            live.alloc(8 * r, r * bk)  # sub, gt
            live.free(8 * r)
            live.alloc(r * bk)  # and
            live.free(held, r * bk)
            held = r * bk
        live.alloc(4 * r * bk, ok)  # zeros, not
        live.free(8 * bk, held, ok)  # leaves the bias

    def blocks(live, n, n_pad, scaled):  # _q_blocks / _kv_blocks: cast, scale, pad, copy
        c = 4 * n if cast else 0
        live.alloc(c)
        if scaled:
            live.alloc(4 * n)
            live.free(c)
            c = 4 * n
        live.alloc(4 * n_pad)
        live.free(c)
        live.alloc(4 * n_pad)
        live.free(4 * n_pad)

    def unblock(live, n, n_pad, out_e):  # stack, copy (the stack freed), cast
        live.alloc(4 * n_pad, 4 * n_pad)
        live.free(4 * n_pad)
        if out_e != 4:
            live.alloc(out_e * n)
            live.free(4 * n_pad)

    def row_blocks(live, arg):  # pad (the argument freed when it is local), copy
        live.alloc(4 * nrp)
        live.free(arg)
        live.alloc(4 * nrp)
        live.free(4 * nrp)

    def block_start(live):  # the rows of the last q block, the old ones freed
        if nqb > 1:
            live.alloc(8 * r, 8 * r)
            live.free(8 * r)
        else:
            live.alloc(8 * r)

    f = _Live()
    blocks(f, nq, nqp, True)
    blocks(f, nk, nkp, False)
    blocks(f, nk, nkp, False)
    f.alloc(8 * r, 8 * r)  # positions
    f.free(8 * r)
    f.alloc(8 * bk)
    f.alloc((nqb - 1) * (4 * rd + 4 * rb))  # the finished q blocks' out and lse
    block_start(f)
    f.alloc(4 * rb, 4 * rb, 4 * rd)  # m, l, acc
    mask_peak(f)
    f.alloc(4 * sc, 4 * rb, 4 * rb)  # scores, amax, maximum
    f.free(4 * rb)
    f.alloc(4 * rb, 4 * rb)  # alpha: sub, exp
    f.free(4 * rb)
    f.alloc(4 * rb)  # sum
    f.free(4 * rb)
    f.alloc(4 * rd)  # the new acc
    f.free(4 * rd, 4 * rb, 4 * rb, 4 * r * bk, 4 * sc)  # old acc and m, alpha, bias, scores
    f.free(4 * rb)  # m at the block's end; acc and l stay as out and lse
    unblock(f, nq, nqp, e)
    unblock(f, nr, nrp, 4)

    w = _Live()
    blocks(w, nq, nqp, True)
    blocks(w, nk, nkp, False)
    blocks(w, nk, nkp, False)
    blocks(w, nq, nqp, False)  # dout
    w.alloc(4 * nrp, 4 * nrp)  # lse blocks (the caller holds lse)
    w.free(4 * nrp)
    w.alloc(8 * nq if cast else 0, 4 * nq)  # delta: casts, product, sum
    w.free(8 * nq if cast else 0)
    w.alloc(4 * nr)
    w.free(4 * nq)
    row_blocks(w, 4 * nr)
    w.alloc(8 * r, 8 * r)  # positions
    w.free(8 * r)
    w.alloc(8 * bk, 2 * nkb * 4 * kd)  # dk, dv
    w.alloc((nqb - 1) * 4 * rd)  # the finished q blocks' dq
    block_start(w)
    w.alloc(4 * rd)  # dq
    mask_peak(w)
    w.alloc(4 * sc, 4 * kd)  # p, new dv
    w.free(4 * kd)
    w.alloc(4 * sc, 4 * rd)  # ds, new dq
    w.free(4 * rd)
    w.alloc(4 * kd)  # new dk
    w.free(4 * kd, 4 * r * bk, 4 * sc, 4 * sc)
    unblock(w, nq, nqp, e)
    for _ in range(2):  # dk, dv; their per-block accumulators freed as the names rebind
        unblock(w, nk, nkp, e)
        w.free(4 * nkp)
    return {"fwd": {"flops": 4.0 * pairs * sc * dh, "bytes": float(fwd_by), "temp": float(f.peak)},
            "bwd": {"flops": 10.0 * pairs * sc * dh, "bytes": float(bwd_by), "temp": float(w.peak)}}


def kernel_cost(b: int, sq: int, sk: int, hq: int, hkv: int, dh: int, dtype: torch.dtype,
                causal: bool = True, window: Optional[int] = None,
                with_lse: bool = True) -> Dict[str, Dict[str, float]]:
    """The least work of the card's flash kernels for one call of the
    forward (``"fwd"``, ``csrc/flash_attention.cu``) and of the backward
    (``"bwd"``, ``csrc/flash_attention_bwd.cu``), whatever the blocks:
    ``flops`` of the products over the (query, key) pairs that the masks
    leave visible, 4 a pair and head dim forward (Q.K, P.V) and 10 backward
    (the five products); ``bytes`` of each input read once and each output
    written once (forward: q, k, v in, out and, ``with_lse``, the f32 lse
    out; backward: q, k, v, out, dout and lse in, dq, dk, dv out). The
    queries sit at the tail of the key axis, as in :func:`_bias`."""
    pos = torch.arange(sk - sq, sk)
    hi = pos if causal else torch.full_like(pos, sk - 1)
    lo = (pos - window + 1).clamp(min=0) if window is not None else torch.zeros_like(pos)
    pairs = int((hi - lo + 1).clamp(min=0).sum())
    e = torch.empty((), dtype=dtype).element_size()
    nq, nk, nr = b * sq * hq * dh, b * sk * hkv * dh, b * sq * hq
    per_pair = b * hq * dh * pairs
    return {"fwd": {"flops": 4.0 * per_pair,
                    "bytes": float(e * (2 * nq + 2 * nk) + (4 * nr if with_lse else 0))},
            "bwd": {"flops": 10.0 * per_pair,
                    "bytes": float(e * (3 * nq + 2 * nk) + 4 * nr + e * (nq + 2 * nk))}}


@contextlib.contextmanager
def cost_sink(fn: Callable[[Dict[str, float], Dict[str, float]], None]):
    """Within the block, each meta-device call of ``ops.flash_attention``
    (and its backward) hands ``fn`` its :func:`cost` entry and its
    :func:`kernel_cost` entry."""
    global _SINK
    prev, _SINK = _SINK, fn
    try:
        yield fn
    finally:
        _SINK = prev


def _report(q, k, causal, window, bq, bk, part: str, with_lse: bool = True) -> None:
    """Hands the sink the blocked version's and the kernels' cost of the
    ``part`` ("fwd" or "bwd") of a call on q and k."""
    if _SINK is None:
        return
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    blocked = cost(b, sq, sk, hq, hkv, dh, q.dtype, causal, window, bq, bk)[part]
    kernels = kernel_cost(b, sq, sk, hq, hkv, dh, q.dtype, causal, window, with_lse)[part]
    _SINK(blocked, kernels)


class MetaFlash(torch.autograd.Function):
    """Shapes only: the outputs of :class:`FlashXLA` on ``meta`` tensors,
    its forward's and backward's :func:`cost` and :func:`kernel_cost`
    reported to the sink."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], bq: int, bk: int):
        _report(q, k, causal, window, bq, bk, "fwd")
        out = q.new_empty(q.shape)
        lse = q.new_empty(q.shape[:3], dtype=torch.float32)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        causal, window, bq, bk = ctx.args
        _report(q, k, causal, window, bq, bk, "bwd")
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape), None, None, None, None


def flash_attention_meta(q, k, v, causal: bool = True, window: Optional[int] = None):
    """``ops.flash_attention`` on the meta device: the output's shape and
    dtype, at the default blocks; under autograd, a backward with dq, dk,
    dv. No (b, h, sq, sk) tensor is made."""
    bq, bk = DEFAULT_BQ, DEFAULT_BK
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MetaFlash.apply(q, k, v, causal, window, bq, bk)
    _report(q, k, causal, window, bq, bk, "fwd", with_lse=False)
    return q.new_empty(q.shape)
