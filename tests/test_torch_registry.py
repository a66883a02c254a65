"""The public hook of the port's index-family registry
(``repro_torch.vdms.registry``) against the JAX package's: registry-derived
search spaces for subsets of families, registration round trips, and the
same errors. Every test leaves the port's registry as it found it (the seven
built-ins), so other port test files on the same worker see them."""
import numpy as np
import pytest
import torch

from repro.vdms import ivf_pqr as jpqr
from repro.vdms import registry as jreg
from repro_torch.core import Param
from repro_torch.vdms import (
    IndexBundle,
    IndexFamily,
    VDMSInstance,
    get_family,
    ivf_pqr,
    make_space,
    register_family,
    registered_families,
    registered_names,
    temporary_family,
    unregister_family,
)
from repro_torch.vdms.registry import REGISTRY
from torch_parity import SEVEN, default_config, port_dataset
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


@pytest.fixture(autouse=True)
def _restore_registries():
    """Both registries hold just their seven built-ins during the test
    (another module on this worker may have left IVF_PQR registered), and
    get back what they held after it."""
    port, ref = dict(REGISTRY._families), dict(jreg.REGISTRY._families)
    for names, unregister in ((jreg.registered_names(), jreg.unregister_family),
                              (registered_names(), unregister_family)):
        for name in names:
            if name not in SEVEN:
                unregister(name)
    try:
        yield
    finally:
        REGISTRY._families.clear()
        REGISTRY._families.update(port)
        jreg.REGISTRY._families.clear()
        jreg.REGISTRY._families.update(ref)


def _toy_build(draws, segs, gids, params, sys):
    stride = int(params["stride"])
    return IndexBundle(kind="TOY_STRIDED", arrays={"data": segs[:, ::stride].contiguous(),
                                                    "gids": gids[:, ::stride].contiguous()},
                       static={"stride": stride})


def _toy_search(q, arrays, *, k_seg, stride):
    sims = torch.einsum("bd,zsd->zbs", q, arrays["data"].float())
    sims = sims.masked_fill(arrays["gids"][:, None, :] < 0, float("-inf"))
    top_s, top_i = torch.topk(sims, min(k_seg, sims.shape[-1]), dim=-1)
    ids = torch.gather(arrays["gids"][:, None, :].expand(-1, q.shape[0], -1), 2, top_i)
    pad = k_seg - ids.shape[-1]
    return (torch.nn.functional.pad(ids, (0, pad), value=-1),
            torch.nn.functional.pad(top_s, (0, pad), value=float("-inf")))


TOY = IndexFamily(name="TOY_STRIDED", params=(Param("stride", "grid", choices=(1, 2, 4),
                                                    default=2),),
                  build=_toy_build, search=_toy_search, description="strided brute force")


def test_builtins_and_public_names():
    assert registered_names() == SEVEN
    assert tuple(f.name for f in registered_families()) == SEVEN
    assert "FLAT" in REGISTRY and "IVF_PQR" not in REGISTRY


@pytest.mark.parametrize("include", [
    None, ("FLAT",), ("IVF_PQ", "FLAT"), ("HNSW", "IVF_PQR", "IVF_SQ8"),
    ("IVF_PQR", "AUTOINDEX", "SCANN", "IVF_FLAT"), SEVEN + ("IVF_PQR",),
], ids=lambda v: "all" if v is None else "+".join(v))
def test_make_space_include_matches_reference(include):
    jpqr.register()
    ivf_pqr.register()
    port, ref = make_space(include=include), jreg.make_space(include=include)
    assert port.type_names == ref.type_names
    assert port.encoding_signature() == ref.encoding_signature()
    assert port.dims == ref.dims
    for t in ref.type_names:
        assert port.default_config(t) == ref.default_config(t)
        np.testing.assert_array_equal(port.free_mask(t), ref.free_mask(t))


def test_include_keeps_registration_order():
    assert make_space(include=("SCANN", "FLAT", "HNSW")).type_names == ("FLAT", "HNSW", "SCANN")


@pytest.mark.parametrize("include", [("FLAT", "NOPE"), ("IVF_PQR",), ()],
                         ids=["unknown", "unregistered-pqr", "empty"])
def test_make_space_errors_match_reference(include):
    with pytest.raises(ValueError) as want:
        jreg.make_space(include=include)
    with pytest.raises(ValueError) as got:
        make_space(include=include)
    assert str(got.value) == str(want.value)


def test_register_unregister_round_trip():
    before = make_space()
    assert register_family(TOY) is TOY
    assert registered_names() == SEVEN + ("TOY_STRIDED",)
    space = make_space()
    assert space.type_names[-1] == "TOY_STRIDED"
    assert space.default_config("TOY_STRIDED")["stride"] == 2
    cfg = dict(default_config("FLAT"), index_type="TOY_STRIDED", stride=2)
    r = VDMSInstance(port_dataset(), cfg, device="cpu").measure(mode="analytic")
    assert 0.0 < r["recall"] <= 1.0 and r["speed"] > 0  # the exhaustive-cost fallback
    assert unregister_family("TOY_STRIDED") is TOY
    assert registered_names() == SEVEN
    assert make_space().encoding_signature() == before.encoding_signature()


def test_temporary_family_round_trip():
    with temporary_family(TOY) as fam:
        assert fam is TOY and get_family("TOY_STRIDED") is TOY
    assert registered_names() == SEVEN
    with pytest.raises(RuntimeError, match="inside"):
        with temporary_family(TOY):
            raise RuntimeError("inside")
    assert "TOY_STRIDED" not in REGISTRY


def test_replace_and_ivf_pqr_idempotent():
    flat = get_family("FLAT")
    assert register_family(flat, replace=True) is flat
    assert registered_names() == SEVEN
    assert ivf_pqr.register() is ivf_pqr.register() is ivf_pqr.FAMILY
    assert registered_names() == SEVEN + ("IVF_PQR",)


def _errors(pkg_register, pkg_unregister, pkg_get, family, bad_kind):
    out = []
    for fn in (lambda: pkg_register(family), lambda: pkg_unregister("NOPE"),
               lambda: pkg_get("NOPE"), lambda: pkg_register(bad_kind),
               lambda: pkg_register("FLAT")):
        with pytest.raises((ValueError, TypeError)) as e:
            fn()
        out.append((type(e.value), str(e.value)))
    return out


def test_errors_match_reference():
    import dataclasses

    want = _errors(jreg.register_family, jreg.unregister_family, jreg.get_family,
                   jreg.get_family("FLAT"),
                   dataclasses.replace(jreg.get_family("AUTOINDEX"), name="AUTO2",
                                       builds_kind="NOPE"))
    got = _errors(register_family, unregister_family, get_family, get_family("FLAT"),
                  dataclasses.replace(get_family("AUTOINDEX"), name="AUTO2",
                                      builds_kind="NOPE"))
    assert got == want
    assert registered_names() == SEVEN


@pytest.mark.parametrize("with_pqr", [False, True], ids=["seven", "with-IVF_PQR"])
def test_capability_tables_match_reference(with_pqr):
    from repro_torch.vdms import fused_pipeline_table, registry_table

    if with_pqr:
        jpqr.register()
        ivf_pqr.register()
    assert registry_table() == jreg.registry_table()
    assert fused_pipeline_table() == jreg.fused_pipeline_table()
    for fam in registered_families():
        ref = jreg.get_family(fam.name)
        assert (fam.shared_arrays, fam.supports_frozen, fam.supports_incremental) == \
            (ref.shared_arrays, ref.supports_frozen, ref.supports_incremental), fam.name


def test_frozen_without_shared_arrays_errors_like_reference():
    import dataclasses

    with pytest.raises(ValueError) as want:
        dataclasses.replace(jreg.get_family("FLAT"), name="F2", supports_frozen=True)
    with pytest.raises(ValueError) as got:
        dataclasses.replace(get_family("FLAT"), name="F2", supports_frozen=True)
    assert str(got.value) == str(want.value)
    assert dataclasses.replace(TOY, shared_arrays=["data"]).shared_arrays == ("data",)
