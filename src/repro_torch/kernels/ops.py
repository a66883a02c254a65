"""Public kernel entry points and their dispatch.

``impl`` selects the version:

* ``None`` (default) — by the tensors' device: the CUDA kernel for CUDA
  tensors, the plain PyTorch version for CPU tensors. There is no fallback:
  a kernel that fails to build or launch raises.
* ``"torch"`` — the plain version on any device (``chip_smoke.py`` runs it
  on the card to hold each kernel against it).

Each kernel's wrapper counts its launches (:func:`launch_counts`), so a run
can show that the main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .distance import distance_cuda, distance_torch
from .flash_attention import flash_attention_cuda, flash_attention_torch
from .fused_adc import fused_ivf_pq_topk_cuda, fused_ivf_pq_topk_torch
from .fused_scan import fused_ivf_sq8_topk_cuda, fused_ivf_sq8_topk_torch
from .ref import topk_by_score, topk_stable

__all__ = [
    "KERNELS", "batched_ip", "flash_attention", "fused_ivf_pq_topk", "fused_ivf_sq8_topk", "l2_distance",
    "launch_counts", "reset_launch_counts", "topk_by_score", "topk_stable",
]

#: kernel name -> CUDA wrapper (the holder of the launch count)
KERNELS = {
    "distance": distance_cuda,
    "fused_ivf_sq8_topk": fused_ivf_sq8_topk_cuda,
    "fused_ivf_pq_topk": fused_ivf_pq_topk_cuda,
    "flash_attention": flash_attention_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _use_kernel(impl: Optional[str], t: torch.Tensor) -> bool:
    if impl not in (None, "torch"):
        raise ValueError(f"unknown impl {impl!r}; use None or 'torch'")
    if impl == "torch" or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def batched_ip(queries, database, impl: Optional[str] = None):
    """Inner products. queries (q, d) f32; database (n, d) -> (q, n), or
    stacked segments (n_seg, S, d) -> (n_seg, q, S); f32 or bf16 storage,
    f32 accumulation."""
    fn = distance_cuda if _use_kernel(impl, queries) else distance_torch
    return fn(queries, database, "ip")


def l2_distance(queries, database, impl: Optional[str] = None):
    """Squared L2 ``|q|^2 - 2 q.x + |x|^2``, shapes as :func:`batched_ip`."""
    fn = distance_cuda if _use_kernel(impl, queries) else distance_torch
    return fn(queries, database, "l2")


def fused_ivf_sq8_topk(q, codes, scale, centroids, members, gids, *, nprobe: int, k: int,
                       mask_dead: bool = False, impl: Optional[str] = None):
    """Fused IVF probe -> int8 dequant scan -> top-k over stacked segments;
    (lids, sims) each (n_seg, B, k) with -1 / -inf empty slots. Candidate
    sets and scores match across impls; order among tied scores does not."""
    fn = fused_ivf_sq8_topk_cuda if _use_kernel(impl, q) else fused_ivf_sq8_topk_torch
    return fn(q, codes, scale, centroids, members, gids, nprobe=nprobe, k=k,
              mask_dead=mask_dead)


def fused_ivf_pq_topk(q, lut, codes, centroids, members, gids, *, nprobe: int, k: int,
                      mask_dead: bool = False, impl: Optional[str] = None):
    """Fused IVF probe -> PQ ADC scan -> top-k over stacked segments; same
    contract as :func:`fused_ivf_sq8_topk` with ``lut`` (B, m, c) f32."""
    fn = fused_ivf_pq_topk_cuda if _use_kernel(impl, q) else fused_ivf_pq_topk_torch
    return fn(q, lut, codes, centroids, members, gids, nprobe=nprobe, k=k,
              mask_dead=mask_dead)


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    impl: Optional[str] = None):
    """Attention forward with GQA: q (b, sq, hq, dh), k and v (b, sk, hkv, dh)
    -> (b, sq, hq, dh) in q's dtype; queries at the tail of the key axis,
    optional sliding ``window``; f32 or bf16, f32 softmax and accumulation."""
    fn = flash_attention_cuda if _use_kernel(impl, q) else flash_attention_torch
    return fn(q, k, v, causal=causal, window=window)
