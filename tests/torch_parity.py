"""Shared inputs and comparisons for the parity tests of the PyTorch port
(``tests/test_torch_*.py``) against the JAX package.

Inputs are numpy arrays made from a seed and handed to both packages. Build
randomness cannot match (``jax.random`` vs ``torch.Generator``), so indexes
are built once by the JAX package and carried across with
``repro_torch.vdms.bundle_from_numpy``. The reference builds are cached per
process, so the test modules that share a worker share them.
"""
import functools

import numpy as np

SEVEN = ("FLAT", "IVF_FLAT", "IVF_SQ8", "IVF_PQ", "HNSW", "SCANN", "AUTOINDEX")
# n = 3000 with 1024-vector segments: two full segments and a sealed
# partial one (952 vectors + 72 padded slots with gid -1)
DATA = dict(n=3000, n_queries=32, k=10, seed=0, dim=64)
SYS = dict(segment_max_size=1024)
TOL = 1e-5  # f32 scores of unit vectors, d <= 64 terms, two accumulation orders


@functools.lru_cache(maxsize=None)
def reference_dataset():
    from repro.vdms import make_dataset

    return make_dataset("glove_like", **DATA)


def port_dataset():
    from repro_torch.vdms import VectorDataset

    ds = reference_dataset()
    return VectorDataset(ds.name, ds.data, ds.queries, ds.ground_truth, ds.k)


def default_config(index_type):
    from repro_torch.vdms import make_space

    cfg = make_space().default_config(index_type)
    cfg.update(SYS)
    return cfg


@functools.lru_cache(maxsize=None)
def reference_instance(index_type):
    from repro.vdms import VDMSInstance

    return VDMSInstance(reference_dataset(), default_config(index_type), seed=0)


def carry(bundle, device="cpu"):
    """The port's bundle holding the JAX package bundle's arrays."""
    from repro_torch.vdms import bundle_from_numpy

    return bundle_from_numpy(bundle.kind, bundle.arrays, bundle.static, device)


def assert_topk_match(ids_a, sims_a, ids_b, sims_b, atol=TOL):
    """Top-k contract over (..., k) arrays: per row the same ids among live
    slots, except that an id may differ where its score ties the row's k-th
    live score to within ``atol``; sorted live scores agree to ``atol``."""
    ids_a, sims_a, ids_b, sims_b = (np.asarray(x) for x in (ids_a, sims_a, ids_b, sims_b))
    assert ids_a.shape == ids_b.shape and sims_a.shape == sims_b.shape
    k = ids_a.shape[-1]
    ids_a, sims_a = ids_a.reshape(-1, k), sims_a.reshape(-1, k).astype(np.float32)
    ids_b, sims_b = ids_b.reshape(-1, k), sims_b.reshape(-1, k).astype(np.float32)
    for r in range(ids_a.shape[0]):
        la, lb = np.isfinite(sims_a[r]), np.isfinite(sims_b[r])
        assert la.sum() == lb.sum(), f"row {r}: {la.sum()} vs {lb.sum()} live slots"
        if not la.any():
            continue
        np.testing.assert_allclose(np.sort(sims_a[r][la]), np.sort(sims_b[r][lb]), atol=atol)
        a = dict(zip(ids_a[r][la].tolist(), sims_a[r][la].tolist()))
        b = dict(zip(ids_b[r][lb].tolist(), sims_b[r][lb].tolist()))
        kth = min(sims_b[r][lb])
        for i in set(a) ^ set(b):
            s = a.get(i, b.get(i))
            assert abs(s - kth) <= atol, f"row {r}: id {i} (score {s}) differs, k-th {kth}"


def assert_ids_match(ids_a, ids_b, data, queries, atol=TOL):
    """Per-query id sets of two searches agree, except ids whose exact
    score ties the k-th exact score of the row to within ``atol``."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    assert ids_a.shape == ids_b.shape
    for r in range(ids_a.shape[0]):
        a, b = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        if a == b:
            continue
        live = [i for i in ids_b[r].tolist() if i >= 0]
        kth = min(float(data[i] @ queries[r]) for i in live)
        for i in a ^ b:
            assert i >= 0, f"query {r}: padding differs"
            s = float(data[i] @ queries[r])
            assert abs(s - kth) <= atol, f"query {r}: id {i} (score {s}) differs, k-th {kth}"
