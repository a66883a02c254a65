"""The tuning loop of the port on the real VDMS backend, held against the JAX
package: every family's build with the reference's random draws injected,
the port's own draws unchanged, and a whole analytic-mode VDTuner session
(the setting of ``tests/test_integration.py``) configuration for
configuration. Everything runs on the CPU."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import VDTuner as JVDTuner
from repro.vdms import VDMSTuningEnv as JEnv
from repro.vdms import engine as jengine
from repro.vdms import ivf_pqr as jpqr
from repro.vdms import make_dataset as j_make_dataset
from repro.vdms import make_space as j_make_space
from repro.vdms.registry import get_family as j_get_family
from repro.vdms.segments import plan_segments, stack_sealed
from repro_torch.core import VDTuner
from repro_torch.vdms import (
    BuildDraws,
    VDMSInstance,
    VDMSTuningEnv,
    VectorDataset,
    build_index,
    get_family,
    make_space,
)
from repro_torch.vdms import engine as tengine
from repro_torch.vdms import ivf_pqr
from repro_torch.vdms.kmeans import init_indices, kmeans, kmeans_l2
from torch_parity import SEVEN, TOL, ReferenceDraws, default_config, reference_dataset
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------
FAMILIES = SEVEN + ("IVF_PQR",)
SEED = 4


def _families(index_type):
    if index_type == "IVF_PQR":  # built through the family, no registration needed
        return jpqr.FAMILY, ivf_pqr.FAMILY
    return j_get_family(index_type), get_family(index_type)


def _sealed():
    ds = reference_dataset()
    plan = plan_segments(ds.n, 1024, 0.75, 0.2)
    return stack_sealed(ds.data, plan)


def _config(index_type):
    if index_type == "IVF_PQR":  # the system defaults with the family's own
        return dict(default_config("FLAT"), index_type="IVF_PQR",
                    **{p.name: p.default for p in ivf_pqr.FAMILY.params})
    return default_config(index_type)


@pytest.mark.parametrize("index_type", FAMILIES)
def test_build_with_reference_draws_matches_reference(index_type):
    segs, gids = _sealed()
    cfg = _config(index_type)
    sys_ = dict(kmeans_iters=int(cfg["kmeans_iters"]), storage_bf16=False)
    jfam, tfam = _families(index_type)
    want = jfam.build(jax.random.PRNGKey(SEED), segs, gids, cfg, sys_)
    got = tfam.build(ReferenceDraws(SEED, "cpu"), torch.from_numpy(segs),
                     torch.from_numpy(gids), cfg, sys_)
    assert got.kind == want.kind and got.static == want.static
    assert set(got.arrays) == set(want.arrays)
    for name, w in want.arrays.items():
        w, g = np.asarray(w), got.arrays[name].numpy()
        assert g.shape == w.shape, name
        if name in ("centroids", "codebooks"):
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=name)
        else:  # assignments (as lists), codes, graphs, ids, stored vectors
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("index_type", ["IVF_PQ", "HNSW"])
def test_default_draws_are_the_generator_path(index_type):
    """``draws=None`` draws what the port drew before draws could be
    injected: one ``torch.Generator(seed)`` for the coarse k-means, then the
    codebooks, and the HNSW shortcuts from ``Generator(s * 7 + m_links)``."""
    ds = VectorDataset("parity", *(getattr(reference_dataset(), a) for a in
                                   ("data", "queries", "ground_truth", "k")))
    cfg = default_config(index_type)
    cfg.update(nbits=4, kmeans_iters=4)
    got = VDMSInstance(ds, cfg, seed=SEED, device="cpu").bundle.arrays
    segs, _ = _sealed()
    segs = torch.from_numpy(segs)
    n_seg, s, d = segs.shape
    gen = torch.Generator().manual_seed(SEED)
    if index_type == "IVF_PQ":
        cents, _ = kmeans(segs, 128, 4, init_idx=init_indices(n_seg, s, 128, gen))
        sample = segs.reshape(-1, 8, d // 8).transpose(0, 1).contiguous()
        cb, _ = kmeans_l2(sample, 16, 4, init_idx=init_indices(8, sample.shape[1], 16, gen))
        assert torch.equal(got["centroids"], cents) and torch.equal(got["codebooks"], cb)
    else:
        g = torch.Generator().manual_seed(s * 7 + 16)
        links = torch.randint(0, s, (s, 2), generator=g).to(torch.int32)
        assert torch.equal(got["graph"][:, :, -2:], links.expand(n_seg, -1, -1))
    again = build_index(BuildDraws(SEED, "cpu"), segs, torch.from_numpy(_sealed()[1]),
                        index_type, cfg, dict(kmeans_iters=4, storage_bf16=False))
    for name, a in got.items():
        assert torch.equal(again.arrays[name], a), name


# ---------------------------------------------------------------------------
# the tuning loop: the setting of tests/test_integration.py
# ---------------------------------------------------------------------------
N_OBS = 20


def _recorded_search(store, search):
    def wrapped(self, queries, topk):
        ids = search(self, queries, topk)
        store[json.dumps(self.config, sort_keys=True)] = np.asarray(ids)
        return ids
    return wrapped


@pytest.fixture(scope="module")
def sessions():
    """One reference session and one port session (``device="cpu"``, the
    reference's draws injected), with the result ids of every evaluation
    kept by configuration."""
    ds = j_make_dataset("glove_like", n=2048, n_queries=64, k=10, seed=3)
    ids = {"ref": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine.VDMSInstance, "search",
                   _recorded_search(ids["ref"], jengine.VDMSInstance.search))
        mp.setattr(tengine.VDMSInstance, "search",
                   _recorded_search(ids["port"], tengine.VDMSInstance.search))
        ref = JVDTuner(j_make_space(include=SEVEN), JEnv(ds, mode="analytic", seed=3), seed=3,
                       abandon_window=8).run(N_OBS)
        port_ds = VectorDataset(ds.name, ds.data, ds.queries, ds.ground_truth, ds.k)
        env = VDMSTuningEnv(port_ds, mode="analytic", seed=3, device="cpu",
                            draws=ReferenceDraws)
        port = VDTuner(make_space(include=SEVEN), env, seed=3, abandon_window=8,
                       device="cpu").run(N_OBS)
    return dict(ref=ref, port=port, env=env, ds=port_ds, ids=ids)


def test_session_on_vdms_matches_reference(sessions):
    """Configuration for configuration: speed equal (the same cost-model
    arithmetic), recall within the ids that differ at ties."""
    ref, port, ds = sessions["ref"], sessions["port"], sessions["ds"]
    assert len(port.history) == len(ref.history) == N_OBS
    for o_ref, o_port in zip(ref.history, port.history):
        assert o_port.config == o_ref.config, f"observation {o_ref.iteration}"
        assert o_port.failed == o_ref.failed is False
        assert o_port.y[0] == o_ref.y[0]
        key = json.dumps(o_ref.config, sort_keys=True)
        a, b = sessions["ids"]["port"][key], sessions["ids"]["ref"][key]
        n_diff = sum(len(set(x) ^ set(y)) for x, y in zip(a.tolist(), b.tolist()))
        assert abs(o_port.y[1] - o_ref.y[1]) <= n_diff / ds.ground_truth.size
    assert port.abandon.state_dict() == ref.abandon.state_dict()


def test_vdtuner_improves_over_default_on_real_vdms(sessions):
    """The twin of ``tests/test_integration.py``: a sampled configuration
    matches the default's recall with more speed."""
    port, env = sessions["port"], sessions["env"]
    default = env(make_space().default_config("AUTOINDEX"))
    better = [o for o in port.history
              if not o.failed and o.y[1] >= default["recall"] - 1e-9 and o.y[0] > default["speed"]]
    assert better, "tuning should find configs dominating the default"
