"""Flash attention, forward: causal or bidirectional, GQA, optional sliding
window (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` (the
TPU kernel ``_fa_kernel``). The LM stack calls it through
``ops.flash_attention`` once per layer at prefill (``models/common.py``);
decode attends over the cache in plain PyTorch and does not launch it.

Conventions, shared by the kernel and its plain version:

* q (b, sq, hq, dh); k, v (b, sk, hkv, dh); the output is (b, sq, hq, dh)
  in q's dtype, from f32 scores, softmax and accumulation; scale
  ``1/sqrt(dh)``; query head h reads kv head ``h // (hq // hkv)``.
* The queries sit at the tail of the key axis: query i is at position
  ``i + sk - sq``. Causal keeps keys at or before it; ``window`` keeps keys
  with ``kpos > qpos - window``.
* A query row that sees no key at all gives 0 (the reference einsum gives
  NaN there; the Pallas kernel gives 0 when every tile of the row is
  skipped). No row of the LM path is fully masked, since ``sk >= sq``.

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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Plain version: f32 einsum, mask and softmax (``repro/kernels/ref.py::
    flash_attention``), with fully masked rows set to 0."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    _check_shapes(q, k, v, window)
    qf = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * dh**-0.5
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


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
_SIG = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [_I64] * 9 + [ctypes.c_int] * 2
        + [ctypes.c_void_p])


def _lib():
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """CUDA kernel: same contract as :func:`flash_attention_torch`. Reads q,
    k and v through their strides (the head dim must be contiguous and every
    stride a multiple of 16 bytes); head dims 16, 32, 64 and 128."""
    _check_shapes(q, k, v, window)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    if dh not in HEAD_DIMS:
        raise _build.KernelContractError(
            f"flash_attention_cuda supports head dims {HEAD_DIMS}, got {dh}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise _build.KernelContractError(
            "flash_attention_cuda needs q, k and v on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise _build.KernelContractError(
            f"dtypes: q, k, v all f32 or all bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise _build.KernelContractError(
                f"flash_attention_cuda: {name} needs a contiguous head dim, 16-byte aligned "
                f"data and strides in multiples of {vec}; got {t.stride()}")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    if out.numel():
        lib = _lib()
        fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv, dh,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                 0 if window is None else int(window), stream)
        _build.check(err, "flash_attention")
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
