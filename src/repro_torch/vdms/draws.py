"""The random draws of one index build, from one object.

A build draws three things: the coarse k-means initial rows of every sealed
segment, the PQ codebooks' initial rows, and the HNSW graph's shortcut
links. :class:`BuildDraws` makes them from ``torch.Generator``s, which
cannot reproduce the JAX package's ``jax.random`` draws; a test that holds a
whole build (or a whole tuning session) against the JAX package hands
``VDMSInstance`` / ``VDMSTuningEnv`` another class with the same
constructor and methods (``draws=``), one that returns the reference's
draws.

A live instance (``LiveVDMS``) builds one segment at a time; the JAX
package keys each of those builds ``fold_in(PRNGKey(seed), salt)`` with
``salt = n_seals + n_compactions``. Here :meth:`BuildDraws.fold` returns
the draws of one such build.
"""
from __future__ import annotations

import numpy as np
import torch

from .kmeans import init_indices


class BuildDraws:
    """The port's own draws for a build with instance seed ``seed``: one
    ``torch.Generator(seed)`` on ``device`` feeds the coarse draws and then
    the codebook draws, in that order; the HNSW shortcuts come from a
    generator seeded ``s * 7 + m_links`` (one draw shared by every
    segment), like the JAX package's key."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def fold(self, salt: int) -> "BuildDraws":
        """The draws of the build with this ``salt``: a fresh generator
        seeded from ``(seed, salt)``, independent of this object's."""
        folded = np.random.SeedSequence([self.seed, int(salt)]).generate_state(1, np.uint64)[0]
        return BuildDraws(int(folded) >> 1, self.device)

    def coarse(self, n_seg: int, n: int, k: int) -> torch.Tensor:
        """``k`` distinct initial rows of each segment's coarse k-means,
        (n_seg, k)."""
        return init_indices(n_seg, n, k, self.gen)

    def codebooks(self, m: int, n: int, c: int) -> torch.Tensor:
        """``c`` distinct initial rows of each subspace's PQ codebook k-means
        over ``n`` pooled samples, (m, c)."""
        return init_indices(m, n, c, self.gen)

    def shortcuts(self, s: int, n_rand: int, m_links: int) -> torch.Tensor:
        """The graph's ``n_rand`` shortcut links of each of ``s`` nodes,
        (s, n_rand) local ids."""
        g = torch.Generator(device=self.device).manual_seed(s * 7 + m_links)
        return torch.randint(0, s, (s, n_rand), generator=g, device=self.device)
