"""Shared inputs and comparisons for the parity tests of the PyTorch port
(``tests/test_torch_*.py``) against the JAX package.

Inputs are numpy arrays made from a seed and handed to both packages. Build
randomness cannot match (``jax.random`` vs ``torch.Generator``), so indexes
are either built once by the JAX package and carried across with
``repro_torch.vdms.bundle_from_numpy``, or built by the port with the JAX
package's draws injected (:class:`ReferenceDraws`). The reference builds are
cached per process, so the test modules that share a worker share them.
"""
import contextlib
import functools

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for torch and for the BLAS under numpy while a
    module that imports this fixture runs. The suite runs in several worker
    processes on one host; there the spinning BLAS and OpenMP threads of
    every worker slow the many small products of the tuner and GP tests
    several-fold (one trajectory test took 57 s with numpy's default
    OpenBLAS threads and 17 s with one, on an 8-core host with five other busy
    processes). Without ``threadpoolctl`` only torch is pinned: the tests
    run slower, not differently."""
    import torch

    try:
        from threadpoolctl import threadpool_limits
        blas = threadpool_limits(limits=1, user_api="blas")
    except ImportError:
        blas = contextlib.nullcontext()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with blas:
            yield
    finally:
        torch.set_num_threads(n)

@pytest.fixture(autouse=True)
def scoped_registries():
    """The port's arch and shape registries as they were before each test of
    a module that imports this fixture: an arch or a shape that a test (or
    an entry point it calls) registers ends with the test, so no later
    module sees it. Every arch module is loaded first, so the ones that load
    on demand are not taken back."""
    from repro_torch.configs import base

    base.list_archs()
    saved = [(live, dict(live)) for live in (base._REGISTRY, base.SHAPES)]
    yield
    for live, kept in saved:
        live.clear()
        live.update(kept)


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


class ReferenceDraws:
    """The JAX package's build draws, in the port's ``BuildDraws``
    interface: the coarse k-means keys ``split(PRNGKey(seed), n_seg)``, the
    codebook keys ``split(fold_in(PRNGKey(seed), 7), m)``, each drawing
    ``choice(..., replace=False)`` as ``repro.vdms.kmeans`` does, and the
    HNSW shortcuts ``randint(PRNGKey(s * 7 + m_links), ...)``. ``fold``
    gives a live build's draws, keyed ``fold_in(PRNGKey(seed), salt)`` as
    ``LiveVDMS`` keys them."""

    def __init__(self, seed, device, key=None):
        import jax

        self.jax = jax
        self.device = device
        self.key = jax.random.PRNGKey(seed) if key is None else key

    def fold(self, salt):
        return ReferenceDraws(None, self.device, key=self.jax.random.fold_in(self.key, salt))

    def _choice(self, keys, n, k):
        def choice(key):
            return self.jax.random.choice(key, n, shape=(k,), replace=False)

        return np.array(self.jax.vmap(choice)(keys))

    def coarse(self, n_seg, n, k):
        return self._choice(self.jax.random.split(self.key, n_seg), n, k)

    def codebooks(self, m, n, c):
        random = self.jax.random
        return self._choice(random.split(random.fold_in(self.key, 7), m), n, c)

    def shortcuts(self, s, n_rand, m_links):
        random = self.jax.random
        key = random.PRNGKey(s * 7 + m_links)
        return np.array(random.randint(key, (s, n_rand), 0, s, dtype=np.int32))
