"""Batched spherical k-means (Lloyd) for the IVF-family indexes, and plain
Lloyd for PQ sub-codebooks (counterpart of the JAX package's
``vdms/kmeans.py``).

Every function runs a batch of independent problems at once, (n_batch, n, d):
one per sealed segment for the coarse quantizer, one per subspace for PQ,
where the JAX package ``vmap``s the single-problem version. Centroids are
re-normalized every iteration (angular metric); empty clusters keep their
previous centroid. Cluster sums are a one-hot matrix product, as in the
JAX package, so they are deterministic on the GPU.

The initial centroids are ``k`` distinct rows per problem, given as
``init_idx`` (n_batch, k): the build's draws (``vdms/draws.py``) make them
with :func:`init_indices`, or a test injects the JAX package's own
(``jax.random.choice``).
"""
from __future__ import annotations

import torch


def init_indices(n_batch: int, n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` distinct row indices per problem, (n_batch, k)."""
    u = torch.rand((n_batch, n), generator=generator, device=generator.device)
    return u.argsort(dim=1)[:, :k]


def _start(x, init_idx):
    idx = torch.as_tensor(init_idx, device=x.device).long()
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _update(x, cent, assign):
    k = cent.shape[1]
    one_hot = x.new_zeros((*assign.shape, k)).scatter_(2, assign[..., None], 1.0)  # (b, n, k)
    sums = torch.bmm(one_hot.transpose(1, 2), x)  # (b, k, d)
    counts = one_hot.sum(dim=1)[..., None]  # (b, k, 1)
    return torch.where(counts > 0, sums / counts.clamp_min(1.0), cent)


def kmeans(x: torch.Tensor, k: int, iters: int, *, init_idx):
    """x: (n_batch, n, d) normalized, ``init_idx`` (n_batch, k) ->
    (centroids (n_batch, k, d), assign (n_batch, n))."""
    cent = _start(x, init_idx)
    for _ in range(iters):
        assign = torch.bmm(x, cent.transpose(1, 2)).argmax(dim=2)
        new = _update(x, cent, assign)
        cent = new / (torch.linalg.norm(new, dim=2, keepdim=True) + 1e-12)
    return cent, torch.bmm(x, cent.transpose(1, 2)).argmax(dim=2)


def _sq_dist(x, cent):
    return (
        (x * x).sum(2)[:, :, None]
        - 2.0 * torch.bmm(x, cent.transpose(1, 2))
        + (cent * cent).sum(2)[:, None, :]
    )


def kmeans_l2(x: torch.Tensor, k: int, iters: int, *, init_idx):
    """Plain (non-spherical) Lloyd for PQ sub-codebooks; shapes as
    :func:`kmeans`."""
    cent = _start(x, init_idx)
    for _ in range(iters):
        cent = _update(x, cent, _sq_dist(x, cent).argmin(dim=2))
    return cent, _sq_dist(x, cent).argmin(dim=2)
