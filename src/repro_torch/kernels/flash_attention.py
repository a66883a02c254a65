"""Flash attention: causal or bidirectional, GQA, optional sliding window.
The forward (``csrc/flash_attention.cu``) and, for training, its backward
(``csrc/flash_attention_bwd.cu``) joined by :class:`FlashAttention`, a
``torch.autograd.Function``.

The forward replaces ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (the TPU kernel ``_fa_kernel``); the backward
replaces ``repro/kernels/flash_xla.py::_bwd``, the JAX package's only
attention gradient. The LM stack calls them through ``ops.flash_attention``
once per layer (``models/common.py``): at prefill the forward alone; in a
training step the forward saves the rows' log-sum-exp and the backward
recomputes the probabilities from it. Decode attends over the cache in plain
PyTorch and launches neither.

Conventions, shared by the kernel and its plain version:

* q (b, sq, hq, dh); k, v (b, sk, hkv, dh); the output is (b, sq, hq, dh)
  in q's dtype, from f32 scores, softmax and accumulation; scale
  ``1/sqrt(dh)``; query head h reads kv head ``h // (hq // hkv)``.
* The queries sit at the tail of the key axis: query i is at position
  ``i + sk - sq``. Causal keeps keys at or before it; ``window`` keeps keys
  with ``kpos > qpos - window``.
* A query row that sees no key at all gives 0 here. The reference einsum
  gives NaN there. The Pallas kernel gives 0 only when it skips every key
  tile of the row; when one of the row's key tiles is computed for other
  rows of its query tile, every score of the row is the mask value, each
  key of that tile weighs exp(0) = 1, and the row gets the mean of V over
  the padded tile. No row of the LM path is fully masked, since
  ``sk >= sq``.

Bound on the H100 at the serve shapes (q 4 x 2048 x 32 x 128, kv heads 2,
bf16, causal): operations. The visible half of the score matrix is about
137 GFLOP of products (two per score and head dim, for Q.K and P.V), 0.14 ms
at the bf16 tensor-core peak and 2.05 ms at the 67 TFLOP/s f32 rate, while
the 143 MB of q, k, v and output take 0.04 ms. So bf16 inputs go to the
tensor cores: TMA brings K and V tiles into a four-stage ring, loaded once
for up to four query heads that share a kv head, and two consumer
warpgroups run ``wgmma`` (Q.K^T from shared memory, the next tile's issued
under this tile's softmax; P.V with P from registers, rounded once to bf16
where the TPU kernel keeps f32: P lies in [0, 1] and the row sums stay f32,
which keeps the output within one bf16 rounding of the plain version).
f32 inputs go to the f32 CUDA cores (P in f32). Both skip fully masked key
tiles without loading them (half the tiles at causal prefill).

The backward is five products over the visible half, 344 GFLOP at glm4-9b's
training shape (b 4 x 2048, the heads above): 0.35 ms at the bf16
tensor-core peak, 5.1 ms at the f32 peak, and deterministic (no atomics:
every sum has a fixed order). bf16 goes to the tensor cores in four
launches: a pre-pass writes ``delta = rowsum(dO * O)`` and lse in the log2
domain per (head, query) row; a dK/dV kernel per 128 keys of a kv head
(K and V loaded once by TMA, Q, dO and the rows' lse/delta streamed
through a ring, S^T, dP^T, dV += P^T.dO and dK += dS^T.Q by ``wgmma``, the
GQA sum in f32 registers) whose group of query heads is split over
``nsplit`` blocks by :func:`bwd_plan` to balance the causal wave, the
partials summed by a short pass in split order; a dQ kernel in the
forward's block shape (K and V tiles through a TMA ring, S, dP and dQ +=
dS.K by ``wgmma``). P and dS are rounded to bf16 only as operands of their
products. f32 stays on the f32 CUDA cores (TF32 would break the f32 parity):
one pass per (kv head, key tile) for dK and dV, one per (query head, query
tile) for dQ, after a plain ``delta``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 80, 128)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Plain version: f32 einsum, mask and softmax (``repro/kernels/ref.py::
    flash_attention``), with fully masked rows set to 0."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    _check_shapes(q, k, v, window)
    mask = _mask(sq, sk, causal, window, q.device)
    probs = torch.softmax(_scores(q, k).masked_fill(~mask, float("-inf")), dim=-1)
    probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(sq, sk) bool: which keys each query sees (queries at the key axis's tail)."""
    qpos = torch.arange(sq, device=device) + (sk - sq)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scaled scores (b, hkv, g, sq, sk) of q (b, sq, hq, dh) against k."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    return torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * dh**-0.5


def flash_attention_lse_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: Optional[int] = None):
    """Plain version of the forward with its log-sum-exp: (out, lse), lse
    (b, sq, hq) f32 of the scaled scores (``flash_xla.py::_forward``'s
    ``m + log(l)``), -inf for a row that sees no key."""
    _check_shapes(q, k, v, window)
    b, sq, hq, _ = q.shape
    mask = _mask(sq, k.shape[1], causal, window, q.device)
    lse = torch.logsumexp(_scores(q, k).masked_fill(~mask, float("-inf")), dim=-1)
    return flash_attention_torch(q, k, v, causal, window), lse.permute(0, 3, 1, 2).reshape(b, sq, hq)


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                              window: Optional[int] = None):
    """Plain version of the backward: ``flash_xla.py::_bwd``'s formulas as
    einsums over the whole score matrix, f32 throughout. P = exp(S - lse)
    (0 where masked), dV = P^T.dO, dS = P * (dO.V^T - rowsum(dO * O)),
    dQ = dS.K * scale, dK = dS^T.Q * scale, dK and dV summed over each GQA
    group. Returns (dq, dk, dv) in the inputs' dtypes."""
    _check_shapes(q, k, v, window)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = dh**-0.5
    mask = _mask(sq, sk, causal, window, q.device)
    lse_b = lse.float().reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(_scores(q, k) - lse_b).masked_fill(~mask, 0.0)
    dof = dout.float().reshape(b, sq, hkv, g, dh)
    qf = q.float().reshape(b, sq, hkv, g, dh)
    delta = (dof * out.float().reshape(b, sq, hkv, g, dh)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q (b, sq, hq, dh), k and v (b, sk, hkv, dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: same batch and "
                         "head dim, hq a multiple of hkv")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


_I64 = ctypes.c_longlong
_P = ctypes.c_void_p
_SIG = [_P] * 5 + [ctypes.c_int] * 6 + [_I64] * 9 + [ctypes.c_int] * 2 + [_P]
_BWD_SIG = [_P] * 9 + [ctypes.c_int] * 8 + [_P]
_BWD_BF16_SIG = [_P] * 10 + [ctypes.POINTER(_I64), _P]
#: keys of a bf16 dK/dV block (``KV_KEYS`` in ``csrc/flash_attention_bwd.cu``)
BWD_KEYS = 128


def _lib():
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd_f32.argtypes = _BWD_SIG
    lib.flash_attention_bwd_bf16.argtypes = _BWD_BF16_SIG
    for fn in (lib.flash_attention_bwd_f32, lib.flash_attention_bwd_bf16):
        fn.restype = ctypes.c_int
    return lib


def bwd_plan(b: int, sq: int, sk: int, hq: int, hkv: int, dh: int, sms: int) -> dict:
    """Launch plan of the bf16 backward. ``nsplit``: blocks that share one
    128-key tile's group of query heads, doubled (while it divides the
    group) until the dK/dV grid has three blocks an SM, so that the causal
    wave, whose first key tiles see the most queries, spreads over the card;
    their f32 partial dK and dV are summed in split order. ``sq_pad``: the
    query length of the lse/delta rows, a multiple of 128. ``ws_floats``:
    the f32 workspace (those rows, then the partials when ``nsplit > 1``)."""
    group = hq // hkv
    kv_blocks = b * hkv * -(-sk // BWD_KEYS)
    nsplit = 1
    while group % (2 * nsplit) == 0 and kv_blocks * nsplit < 3 * sms:
        nsplit *= 2
    sq_pad = -(-sq // 128) * 128
    ws = 2 * b * hq * sq_pad + (2 * nsplit * b * sk * hkv * dh if nsplit > 1 else 0)
    return dict(nsplit=nsplit, sq_pad=sq_pad, ws_floats=ws)


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA (and 16-byte loads) can read ``t`` as it lies: head dim
    contiguous, the other strides positive multiples of 16 bytes, the data
    16-byte aligned."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and all(s > 0 and s % vec == 0 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _check_cuda(name: str, q, k, v, *more):
    dh = q.shape[3]
    if dh not in HEAD_DIMS:
        raise _build.KernelContractError(f"{name} supports head dims {HEAD_DIMS}, got {dh}")
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, *more)):
        raise _build.KernelContractError(f"{name} needs all its tensors on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise _build.KernelContractError(
            f"{name}: q, k, v (and dout, out) all f32 or all bf16; got "
            f"{[str(t.dtype) for t in (q, k, v, *more)]}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         return_lse: bool = False):
    """CUDA kernel: same contract as :func:`flash_attention_torch`. Reads q,
    k and v through their strides (the head dim must be contiguous and every
    stride a multiple of 16 bytes); head dims 16, 32, 64, 80 and 128 (bf16
    pads 80 to 128 in shared memory: TMA fills the columns past 80 with
    zeros, so 37.5% of its products are on padding). With
    ``return_lse`` it returns (out, lse) as :func:`flash_attention_lse_torch`
    does; without, it launches exactly the serving kernel (no lse written)."""
    _check_shapes(q, k, v, window)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    _check_cuda("flash_attention_cuda", q, k, v)
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise _build.KernelContractError(
                f"flash_attention_cuda: {name} needs a contiguous head dim, 16-byte aligned "
                f"data and strides in multiples of {vec}; got {t.stride()}")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel():
        lib = _lib()
        fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, sk, hq, hkv, dh,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                 0 if window is None else int(window), stream)
        _build.check(err, "flash_attention")
        flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None):
    """CUDA kernel of the backward: same contract as
    :func:`flash_attention_bwd_torch`. bf16 reads q, k, v, out and dout
    through their strides where TMA can (:func:`_tma_ready`) and copies the
    others; its first pass computes ``delta = rowsum(dout * out)``. f32
    works on contiguous copies, with ``delta`` computed here."""
    _check_shapes(q, k, v, window)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    _check_cuda("flash_attention_bwd_cuda", q, k, v, out, dout)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (b, sq, hq) or lse.dtype != torch.float32:
        raise _build.KernelContractError(
            f"flash_attention_bwd_cuda: out and dout {tuple(q.shape)}, lse {(b, sq, hq)} f32; got "
            f"{tuple(out.shape)}, {tuple(dout.shape)}, {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if not (q.numel() and k.numel()):
        for t in (dq, dk, dv):
            t.zero_()
        return dq, dk, dv
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse = lse.contiguous()
    if q.dtype == torch.bfloat16:
        q, k, v, out, dout = (t if _tma_ready(t) else t.contiguous() for t in (q, k, v, out, dout))
        plan = bwd_plan(b, sq, sk, hq, hkv, dh,
                        torch.cuda.get_device_properties(q.device).multi_processor_count)
        ws = torch.empty(plan["ws_floats"], dtype=torch.float32, device=q.device)
        dims = (_I64 * 25)(b, sq, sk, hq, hkv, dh, int(causal), 0 if window is None else int(window),
                           plan["nsplit"], plan["sq_pad"],
                           *(s for t in (q, k, v, out, dout) for s in t.stride()[:3]))
        err = lib.flash_attention_bwd_bf16(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, ws, dq, dk, dv)), dims, stream)
    else:
        q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
        delta = (dout * out).sum(-1)
        err = lib.flash_attention_bwd_f32(*(t.data_ptr() for t in (q, k, v, dout, lse, delta, dq, dk, dv)),
                                          b, sq, sk, hq, hkv, dh, int(causal),
                                          0 if window is None else int(window), stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with the CUDA forward and backward: the forward launches
    :func:`flash_attention_cuda` with the log-sum-exp and saves (q, k, v,
    out, lse); the backward launches :func:`flash_attention_bwd_cuda`. No
    fallback: a kernel that fails to build or launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_attention_cuda(q, k, v, causal, window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None
