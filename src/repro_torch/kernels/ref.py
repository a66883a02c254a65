"""Plain PyTorch helpers shared by the kernels' plain versions.

The plain version of each kernel lives beside its CUDA wrapper
(``distance.py``, ``fused_scan.py``, ``fused_adc.py``): the CPU tests run it,
and ``chip_smoke.py`` compares the kernel with it on the card. This module
holds what they and the search paths share: the stable top-k with
``lax.top_k``'s tie rule, the merge primitive built on it, segment blocking
for batched gathers, and the ordered ADC sum.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch


def topk_stable(x: torch.Tensor, k: int, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along ``dim``, score-descending, with ``lax.top_k``'s tie
    rule: equal scores keep the lowest index. ``torch.topk`` does not
    promise that, so this is a stable descending sort, sliced."""
    if k > x.shape[dim]:
        raise ValueError(f"k={k} exceeds the width {x.shape[dim]} of dim {dim}")
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def topk_by_score(ids: torch.Tensor, sims: torch.Tensor, k: int):
    """ids, sims (B, W) -> (ids_k, sims_k), each (B, k), the best ``k`` by
    score with the lowest flat index winning ties."""
    top_s, top_i = topk_stable(sims, k)
    return torch.gather(ids, 1, top_i), top_s


def segment_blocks(n_seg: int, per_seg_elems: int, budget: int = 1 << 28) -> Iterator[slice]:
    """Slices of the segment axis whose intermediates hold at most about
    ``budget`` elements, so a batched gather over every segment at once does
    not outgrow device memory."""
    step = max(1, budget // max(per_seg_elems, 1))
    for z0 in range(0, n_seg, step):
        yield slice(z0, min(z0 + step, n_seg))


def adc_sum(gathered: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (the m ADC terms) in order m = 0 .. m-1, the order
    the fused ADC kernel adds them in, so both agree bit for bit."""
    acc = gathered[..., 0]
    for j in range(1, gathered.shape[-1]):
        acc = acc + gathered[..., j]
    return acc
