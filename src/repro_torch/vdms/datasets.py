"""Synthetic vector datasets mirroring the paper's three workloads (Table III).

All datasets use angular distance (vectors are L2-normalized; similarity =
inner product). Structure is chosen so that the paper's observed phenomena
survive the scale-down:

* glove_like    — clustered Gaussian mixture (word embeddings cluster):
                  IVF-family indexes work well at modest nprobe.
* keyword_like  — nearly-independent heavy-tailed dimensions (the paper calls
                  out its low inter-dimension correlation and the consequent
                  need for large nprobe).
* georadius_like— high-dimensional (2048-d in the paper; 256-d here), few
                  vectors, smooth manifold structure.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import topk_stable


@dataclasses.dataclass(frozen=True)
class VectorDataset:
    name: str
    data: np.ndarray  # (n, d) float32, L2-normalized
    queries: np.ndarray  # (q, d) float32, L2-normalized
    ground_truth: np.ndarray  # (q, k) int32 exact top-k ids
    k: int

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)).astype(np.float32)


def exact_topk(
    data: np.ndarray, queries: np.ndarray, k: int, device=None, chunk: int = 64
) -> np.ndarray:
    """Brute-force top-k ids by inner product, (q, k) int32, on ``device``
    (the GPU unless the caller passes ``device="cpu"``): one
    ``torch.matmul`` per query chunk and a stable top-k (equal scores keep
    the lowest id). The chunk bounds the (chunk, n) score matrix, which for
    all queries at once would be (q, n) f32."""
    device = resolve_device(device)
    x = torch.as_tensor(data, device=device)
    out = np.empty((queries.shape[0], k), dtype=np.int32)
    for i in range(0, queries.shape[0], chunk):
        qc = torch.as_tensor(queries[i : i + chunk], device=device)
        _, idx = topk_stable(qc @ x.T, k)
        out[i : i + chunk] = idx.cpu().numpy().astype(np.int32)
    return out


def exact_topk_masked(
    data: np.ndarray, queries: np.ndarray, dead: np.ndarray, k: int, chunk: int = 1024
) -> np.ndarray:
    """Exact top-k over the *visible* rows of ``data`` only (numpy, as in the
    JAX package).

    ``dead`` is a boolean mask over ``data`` rows; masked rows can never be
    returned. Rows short of ``k`` visible vectors are padded with ``-1``:
    the time-aware ground truth of streaming replays, where visibility at a
    query's timestamp excludes not-yet-inserted and tombstoned vectors.
    """
    n = data.shape[0]
    k_eff = min(k, max(int(n - dead.sum()), 0))
    out = -np.ones((queries.shape[0], k), dtype=np.int32)
    if k_eff == 0:
        return out
    for i in range(0, queries.shape[0], chunk):
        sim = queries[i : i + chunk] @ data.T
        sim[:, dead] = -np.inf
        part = np.argpartition(-sim, k_eff - 1, axis=1)[:, :k_eff]
        row = np.take_along_axis(sim, part, axis=1)
        order = np.argsort(-row, axis=1, kind="stable")
        out[i : i + chunk, :k_eff] = np.take_along_axis(part, order, axis=1).astype(np.int32)
    return out


def _glove_like(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    n_clusters = max(32, n // 256)
    centers = rng.standard_normal((n_clusters, dim)) * 2.0
    assign = rng.integers(0, n_clusters, size=n)
    scale = 0.6 + 0.8 * rng.random(n_clusters)  # clusters of varying tightness
    return centers[assign] + rng.standard_normal((n, dim)) * scale[assign, None]


def _keyword_like(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    # independent heavy-tailed dims: hard for coarse quantizers
    return rng.standard_t(df=3, size=(n, dim))


def _georadius_like(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    # smooth low-intrinsic-dimension manifold embedded in high dim
    latent = rng.standard_normal((n, 8))
    proj = rng.standard_normal((8, dim))
    return latent @ proj + 0.1 * rng.standard_normal((n, dim))


_GENERATORS = {
    "glove_like": (_glove_like, 96),
    "keyword_like": (_keyword_like, 96),
    "georadius_like": (_georadius_like, 256),
}


def make_dataset(
    name: str,
    n: int = 8192,
    n_queries: int = 128,
    k: int = 10,
    seed: int = 0,
    dim: int | None = None,
    device: Optional[Union[str, torch.device]] = None,
) -> VectorDataset:
    """Same data as the JAX package's ``make_dataset`` (numpy, from
    ``seed``); the exact ground truth is computed on ``device`` (the GPU
    unless the caller passes ``device="cpu"``)."""
    gen, default_dim = _GENERATORS[name]
    dim = dim or default_dim
    rng = np.random.default_rng(seed)
    raw = gen(rng, n + n_queries, dim)
    raw = _normalize(raw)
    data, queries = raw[:n], raw[n:]
    gt = exact_topk(data, queries, k, device)
    return VectorDataset(name=name, data=data, queries=queries, ground_truth=gt, k=k)


def recall_at_k(pred_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Mean fraction of true top-k retrieved (order-insensitive, paper §II-A)."""
    q, k = gt_ids.shape
    hits = 0
    for i in range(q):
        hits += len(set(pred_ids[i].tolist()) & set(gt_ids[i].tolist()))
    return hits / (q * k)


def recall_at_k_masked(pred_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Order-insensitive recall where ``-1`` ground-truth slots (fewer than k
    visible vectors at the query's timestamp) shrink the denominator."""
    total = 0
    hits = 0
    for p_row, g_row in zip(pred_ids, gt_ids):
        g = {int(g) for g in g_row.tolist() if g >= 0}
        if not g:
            continue
        total += len(g)
        hits += len({int(p) for p in p_row.tolist() if p >= 0} & g)
    return hits / total if total else 1.0


# ---------------------------------------------------------------------------
# streaming sources: raw (pre-normalization) draws + drift blending
# ---------------------------------------------------------------------------
def dataset_names() -> tuple:
    """Names of the three Table-III-style workloads."""
    return tuple(_GENERATORS)


def raw_vectors(name: str, rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """Un-normalized draws from a named generator (streaming trace source)."""
    gen, _ = _GENERATORS[name]
    return gen(rng, n, dim)


def default_dim(name: str) -> int:
    return _GENERATORS[name][1]


def blend_vectors(a: np.ndarray, b: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Per-row convex blend of two raw sources, re-normalized. ``w`` in
    [0, 1] per row is the drift weight: 0 = pure source ``a`` (the base
    distribution), 1 = pure source ``b`` (the drift target)."""
    w = np.asarray(w, np.float64).reshape(-1, 1)
    return _normalize((1.0 - w) * a + w * b)
