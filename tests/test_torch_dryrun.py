"""The port's LM planning stack on the CPU against the JAX package: the
shape suites and ``input_specs`` (``configs/base.py``), the blocked flash
forward and its gradients (``kernels/flash_xla.py``) against
``repro.kernels.flash_xla``, its closed-form cost against a count of the
blocked version, ``ops.flash_attention``'s meta route, the meta-device
dry-run (``launch/dryrun.py``), the H100 ``Roofline``
(``launch/hlo_analysis.py``), the roofline table and the host mesh.

The reference's ``test_collective_bytes_parsing`` has no twin: it parses XLA
HLO text, which the port does not have (one device, no collective)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as ref_base
from repro.kernels.flash_xla import _forward as jax_flash_forward
from repro.kernels.flash_xla import flash_attention_xla as jax_flash
from repro_torch.bench.roofline_table import markdown_table, multipod_table
from repro_torch.configs import (SHAPES, get_arch, input_specs, list_archs, reduce, register,
                                 shape_applicable)
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import ShardingRules, params_sharding, spec_axes
from repro_torch.kernels import flash_xla, ops
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, virtual_mesh
from repro_torch.models.api import meta_params
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)
from torch_parity import scoped_registries  # noqa: F401  (autouse: registrations end with the test)

ARCHS = list_archs()
FLASH_TOL = 1e-5  # f32, the same blocked arithmetic in another order
GRAD_TOL = 2e-5


def reference_dryrun():
    """``repro.launch.dryrun``, imported without its 512-device XLA flag
    reaching this process: the backend is initialised first, and the flag
    the module sets at import is taken back."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return ref_dryrun


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def test_shapes_equal_the_references():
    assert list(SHAPES) == list(ref_base.SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(ref_base.SHAPES[name])


def test_shape_applicability_rules():
    long = SHAPES["long_500k"]
    ok, _ = shape_applicable(get_arch("mamba2-130m"), long)
    assert ok
    ok, why = shape_applicable(get_arch("deepseek-67b"), long)
    assert not ok and "full-attention" in why
    ok, _ = shape_applicable(get_arch("mixtral-8x7b"), long)
    assert ok  # SWA bounds the KV cache


@pytest.mark.parametrize("arch", ARCHS)
def test_applicability_and_model_flops_equal_the_references(arch):
    ref = reference_dryrun()
    cfg, rcfg = get_arch(arch), ref_base.get_arch(arch)
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == ref_base.shape_applicable(rcfg, ref_base.SHAPES[name])
        assert dryrun.model_flops_for(cfg, SHAPES[name]) == ref.model_flops_for(rcfg, ref_base.SHAPES[name])


def test_input_specs_no_allocation():
    for arch in ARCHS:
        cfg, rcfg = get_arch(arch), ref_base.get_arch(arch)
        for name, shape in SHAPES.items():
            specs = input_specs(cfg, shape)
            want = ref_base.input_specs(rcfg, ref_base.SHAPES[name])
            assert list(specs) == list(want)
            for key, t in specs.items():
                assert isinstance(t, torch.Tensor) and t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[key].shape)
                assert str(t.dtype).split(".")[-1] == str(want[key].dtype)


# ---------------------------------------------------------------------------
# the blocked flash
# ---------------------------------------------------------------------------
# (b, sq, sk, hq, hkv, dh, causal, window, bq, bk): padding on both axes,
# GQA, a tail offset (sk > sq), windows, bidirectional, one block
FLASH_CASES = [
    (2, 24, 40, 4, 2, 8, True, None, 16, 16),
    (1, 33, 33, 6, 2, 16, False, 7, 8, 16),
    (1, 20, 36, 4, 1, 8, True, 5, 64, 8),
    (2, 48, 48, 4, 4, 16, False, None, 16, 32),
    (1, 1, 30, 4, 2, 8, True, None, 8, 16),
]


def _qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sq, hq, dh)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,win,bq,bk", FLASH_CASES)
def test_blocked_flash_matches_reference(b, sq, sk, hq, hkv, dh, causal, win, bq, bk):
    q, k, v, do = _qkv(3, b, sq, sk, hq, hkv, dh)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, want_lse = jax_flash_forward(jq, jk, jv, causal, win, bq, bk)
    got_out, got_lse = flash_xla.flash_attention_xla_lse(*map(torch.from_numpy, (q, k, v)), causal, win,
                                                         bq, bk)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=FLASH_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(b, sq, hq), atol=FLASH_TOL)

    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal, win, bq, bk) * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_xla.flash_attention_xla(*leaves, causal, win, bq, bk)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL)


def test_default_blocks_set_and_get():
    prev = flash_xla.get_default_blocks()  # process-wide: restored below
    assert (flash_xla.DEFAULT_BQ, flash_xla.DEFAULT_BK) == prev
    try:
        flash_xla.set_default_blocks(64, 128)
        assert flash_xla.get_default_blocks() == (64, 128)
        q, k, v, _ = _qkv(4, 1, 40, 40, 2, 1, 8)
        a = flash_xla.flash_attention_xla(*map(torch.from_numpy, (q, k, v)))
        b = flash_xla.flash_attention_xla(*map(torch.from_numpy, (q, k, v)), bq=64, bk=128)
        assert torch.equal(a, b)
    finally:
        flash_xla.set_default_blocks(*prev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,win,bq,bk", FLASH_CASES)
def test_closed_form_cost_equals_the_count(b, sq, sk, hq, hkv, dh, causal, win, bq, bk, dtype):
    """``flash_xla.cost`` against a :class:`CostCounter` run of the blocked
    forward and backward on meta tensors: FLOPs, bytes and temp equal."""
    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, k, v, dout = t(b, sq, hq, dh), t(b, sk, hkv, dh), t(b, sk, hkv, dh), t(b, sq, hq, dh)
    with dryrun.CostCounter() as c:
        out, lse = flash_xla._forward(q, k, v, causal, win, bq, bk)
    fwd = dict(flops=c.product_flops, bytes=c.bytes, temp=c.peak)
    with dryrun.CostCounter() as c:
        flash_xla._bwd(causal, win, bq, bk, (q, k, v, out, lse), dout)
    bwd = dict(flops=c.product_flops, bytes=c.bytes, temp=c.peak)
    want = flash_xla.cost(b, sq, sk, hq, hkv, dh, dtype, causal, win, bq, bk)
    assert fwd == want["fwd"]
    assert bwd == want["bwd"]


def test_meta_route_reports_the_closed_form():
    """``ops.flash_attention`` on meta tensors: the output's shape and dtype,
    the forward's cost, and under autograd the backward's, at the default
    blocks, each beside the card's kernels' work (the forward without a
    gradient writes no lse); no score tensor is made."""
    b, sq, hq, hkv, dh = 2, 64, 4, 2, 16
    q = torch.empty(b, sq, hq, dh, dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty(b, sq, hkv, dh, dtype=torch.bfloat16, device="meta", requires_grad=True)
    v = torch.empty(b, sq, hkv, dh, dtype=torch.bfloat16, device="meta", requires_grad=True)
    got = []
    with flash_xla.cost_sink(lambda *c: got.append(c)):
        out = ops.flash_attention(q, k, v, causal=True)
        assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
        torch.autograd.grad(out.sum(), (q, k, v))
        with torch.no_grad():
            ops.flash_attention(q, k, v, causal=True)
    want = flash_xla.cost(b, sq, sq, hq, hkv, dh, torch.bfloat16, True, None)
    kern = flash_xla.kernel_cost(b, sq, sq, hq, hkv, dh, torch.bfloat16, True, None)
    no_lse = flash_xla.kernel_cost(b, sq, sq, hq, hkv, dh, torch.bfloat16, True, None, with_lse=False)
    assert got == [(want["fwd"], kern["fwd"]), (want["bwd"], kern["bwd"]),
                   (want["fwd"], no_lse["fwd"])]
    assert kern["fwd"]["bytes"] - no_lse["fwd"]["bytes"] == 4 * b * sq * hq


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,win,bq,bk", FLASH_CASES)
def test_kernel_cost_counts_the_visible_pairs(b, sq, sk, hq, hkv, dh, causal, win, bq, bk):
    """``flash_xla.kernel_cost``: 4 (forward) and 10 (backward) FLOPs per
    head dim for each (query, key) pair that the JAX package's mask leaves
    visible, and the bytes of the kernels' inputs and outputs, once each;
    never more than the blocked version's count at any blocks."""
    qpos = np.arange(sk - sq, sk)[:, None]
    kpos = np.arange(sk)[None, :]
    seen = np.ones((sq, sk), bool)
    if causal:
        seen &= kpos <= qpos
    if win is not None:
        seen &= kpos > qpos - win
    pairs = int(seen.sum())
    got = flash_xla.kernel_cost(b, sq, sk, hq, hkv, dh, torch.bfloat16, causal, win)
    assert got["fwd"]["flops"] == 4 * b * hq * dh * pairs
    assert got["bwd"]["flops"] == 10 * b * hq * dh * pairs
    nq, nk, nr = b * sq * hq * dh, b * sk * hkv * dh, b * sq * hq
    assert got["fwd"]["bytes"] == 2 * (2 * nq + 2 * nk) + 4 * nr
    assert got["bwd"]["bytes"] == 2 * (4 * nq + 4 * nk) + 4 * nr
    blocked = flash_xla.cost(b, sq, sk, hq, hkv, dh, torch.bfloat16, causal, win, bq, bk)
    for part in ("fwd", "bwd"):
        assert got[part]["flops"] <= blocked[part]["flops"]
        assert got[part]["bytes"] <= blocked[part]["bytes"]


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m", "mixtral-8x7b"])
def test_measure_costs_linear_in_depth(arch):
    """Every layer is traced, so the full count is count(1) plus (L - 1)
    times count(2) - count(1), as the reference extrapolates."""
    cfg = reduce(get_arch(arch))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2)
    mesh = make_host_mesh("meta")
    c = {u: dryrun.measure_costs(dryrun._with_depth(cfg, u), shape, mesh, "dots") for u in (1, 2, 4)}
    for key in ("flops", "bytes"):
        assert c[4][key] == c[1][key] + 3 * (c[2][key] - c[1][key])
    assert c[4]["coll_bytes"] == {} and c[4]["coll_counts"] == {}


def test_kernel_roofline_swaps_the_flash_share():
    """The record keeps attention's share apart: with remat "everything"
    (all saved) each layer runs one forward and one backward, so the blocked share is L
    times ``flash_xla.cost`` and the kernels' share L times
    ``kernel_cost``; ``kernel_roofline`` takes the one out and puts the
    other in, and its bound is the lower."""
    cfg = register(reduce(get_arch("glm4-9b")))
    roof, meta = dryrun.lower_cell(cfg.name, "train_4k", remat="everything")
    shape = SHAPES["train_4k"]
    geom = (shape.global_batch, shape.seq_len, shape.seq_len, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            torch.float32)  # the reduced arch's dtype
    blocked = flash_xla.cost(*geom)
    kern = flash_xla.kernel_cost(*geom)
    for got, want in ((meta["flash_blocked"], blocked), (meta["flash_kernels"], kern)):
        for key in ("flops", "bytes"):
            assert got[key] == cfg.n_layers * (want["fwd"][key] + want["bwd"][key])
    card = dryrun.kernel_roofline(roof, meta)
    assert card.hlo_flops == roof.hlo_flops - meta["flash_blocked"]["flops"] + meta["flash_kernels"]["flops"]
    assert card.hlo_bytes == roof.hlo_bytes - meta["flash_blocked"]["bytes"] + meta["flash_kernels"]["bytes"]
    assert 0 < card.bound_s < roof.bound_s
    assert (card.arch, card.shape, card.model_flops) == (roof.arch, roof.shape, roof.model_flops)


def test_dryrun_glm4_full_width_train_4k():
    """glm4-9b at full width and depth, train_4k (256 x 4,096), remat dots,
    on meta: arguments are the weights, their f32 moments, the AdamW step
    and the int32 batch; the counted products cover 6ND less the embedding
    lookup's share; the memory term binds; temp is positive."""
    roof, meta = dryrun.lower_cell("glm4-9b", "train_4k", remat="dots")
    cfg = get_arch("glm4-9b")
    from repro_torch.models.api import meta_params
    n = sum(p.numel() for p in meta_params(cfg).parameters())
    ma = meta["memory_analysis"]
    assert ma["argument_size_in_bytes"] == 2 * n + 8 * n + 4 + 4 * 256 * 4097
    tokens = 256 * 4096
    assert roof.hlo_flops >= roof.model_flops - 6.0 * cfg.vocab_padded * cfg.d_model * tokens
    assert roof.hlo_flops < 2 * roof.model_flops
    assert roof.chips == 1 and roof.mesh == "1x1" and roof.collective_s == 0.0
    assert ma["temp_size_in_bytes"] > 0 and roof.bottleneck in ("compute", "memory")


def test_dryrun_steps_trace_on_meta():
    """Every family's train, prefill and decode step traces on meta at a
    small shape (the MoE dispatch's scatter-gather, the SSD's chunk loop
    and the checkpointed blocks included)."""
    mesh = make_host_mesh("meta")
    for arch in ("glm4-9b", "mixtral-8x7b", "mamba2-130m", "zamba2-2.7b", "seamless-m4t-large-v2"):
        cfg = reduce(get_arch(arch))
        for kind in ("train", "prefill", "decode"):
            shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2, kind=kind)
            r = dryrun._compile_step(cfg, shape, mesh, ShardingRules(mesh), "dots")
            assert r["flops"] > 0 and r["bytes"] > 0 and r["arg_bytes"] > 0 and r["temp"] > 0, (arch, kind)


def test_production_mesh_waits_for_item_10():
    """Item 10's LM half is ported for the dense family: the production
    meshes are the reference's 16 x 16 ("data", "model") and 2 x 16 x 16
    ("pod", "data", "model") of ``meta`` devices, and a dense training cell
    lowers over the 512-chip one; the host mesh is still 1 x 1."""
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert single.size == 256 and multi.size == 512
    assert {d.type for d in single.devices + multi.devices} == {"meta"}
    cfg = register(reduce(get_arch("glm4-9b")))
    roof, meta = dryrun.lower_cell(cfg.name, "train_4k", multi_pod=True)
    assert roof.chips == 512 and roof.mesh == "2x16x16" and roof.collective_s > 0
    mesh = make_host_mesh("cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert mesh.size == 1


def test_cache_and_batch_sharding_specs():
    rules = ShardingRules(make_host_mesh("cpu"))
    cache = {"k": torch.empty(2, 4, 8, 2, 16, device="meta"), "h": torch.empty(2, 4, 3, 8, 16, device="meta")}
    sh = dryrun.cache_sharding(cache, rules)
    assert sh["k"].spec == (None, "data", "model", None, None)
    assert sh["h"].spec == (None, "data", "model", None, None)
    batch = dryrun.batch_sharding({"tokens": torch.empty(4, 9, device="meta")}, rules)
    assert batch["tokens"].spec == ("data", None)


# ---------------------------------------------------------------------------
# roofline, table, artifacts
# ---------------------------------------------------------------------------
def test_roofline_terms_and_bottleneck():
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW) == (989e12, 3.35e12)
    r = hlo_analysis.Roofline(
        arch="a", shape="s", mesh="1x1", chips=1, hlo_flops=1e15, hlo_bytes=1e11,
        coll_bytes=0.0, coll_breakdown={}, coll_counts={}, model_flops=5e14,
        peak_mem_per_dev=1e9,
    )
    assert r.compute_s == pytest.approx(1e15 / hlo_analysis.PEAK_FLOPS)
    assert r.memory_s == pytest.approx(1e11 / hlo_analysis.HBM_BW)
    assert r.bottleneck == "compute" and r.bound_s == r.compute_s
    assert 0 < r.roofline_fraction <= 1.0
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.collective_s == 0.0


def test_roofline_table_builds_from_artifacts(tmp_path):
    rec = {
        "arch": "glm4-9b", "shape": "train_4k", "mesh": "1x1", "chips": 1,
        "hlo_flops": 1e18, "hlo_bytes": 1e15, "coll_bytes": 0.0, "coll_breakdown": {},
        "coll_counts": {}, "model_flops": 5e17, "peak_mem_per_dev": 2**30,
        "compute_s": 0.02, "memory_s": 0.005, "collective_s": 0.0, "bottleneck": "compute",
        "useful_ratio": 0.5, "roofline_fraction": 0.5,
        "memory_analysis": {"temp_size_in_bytes": 2**30},
    }
    (tmp_path / "glm4-9b_train_4k_1.json").write_text(json.dumps(rec))
    (tmp_path / "x_long_500k_1.json").write_text(
        json.dumps({"arch": "x", "shape": "long_500k", "skipped": "full attention"}))
    table = markdown_table(str(tmp_path))
    assert "glm4-9b" in table and "compute" in table and "SKIP" in table


def _check_artifacts(d: Path) -> int:
    n = 0
    for f in d.glob("*_1.json"):
        r = json.loads(f.read_text())
        if "skipped" in r:
            continue
        assert r["hlo_flops"] > 0, f.name
        assert r["memory_analysis"]["temp_size_in_bytes"] > 0, f.name
        assert r["bottleneck"] in ("compute", "memory", "collective")
        n += 1
    return n


def test_dryrun_artifacts(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun`` on a reduced arch over the four
    shapes writes the reference's records ([OK] / [SKIP] lines), which the
    table reads; records already in the default output directory are held
    to the same checks."""
    register(reduce(get_arch("glm4-9b")))
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "glm4-9b-smoke", "--out", str(tmp_path), "--remat", "dots"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == 3 and "[SKIP] glm4-9b-smoke_long_500k_1" in out
    assert _check_artifacts(tmp_path) == 3
    assert "glm4-9b-smoke" in markdown_table(str(tmp_path))
    default = Path("experiments/dryrun_torch")
    if default.exists():
        _check_artifacts(default)


def test_dryrun_reports_a_failed_trace(tmp_path, capsys, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no meta kernel")

    monkeypatch.setattr(dryrun, "_compile_step", broken)
    register(reduce(get_arch("glm4-9b")))
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "glm4-9b-smoke", "--shape", "train_4k", "--out", str(tmp_path)])
    assert done.value.code == 1
    assert "[FAIL] glm4-9b-smoke_train_4k_1: RuntimeError: no meta kernel" in capsys.readouterr().out
    assert not list(tmp_path.glob("*.json"))


# ---------------------------------------------------------------------------
# the collective term over a mesh
# ---------------------------------------------------------------------------
# the mini dry-run of tests/test_distributed.py: glm4-9b's family at d 256,
# 8 / 4 heads of 32, d_ff 512, vocab 1,024, 2 layers, f32; 8 x 64 tokens;
# a (data 2, model 4) mesh; remat "nothing"
MINI = dict(name="mini", d_model=256, n_heads=8, n_kv_heads=4, head_dim=32, d_ff=512, vocab=1024,
            n_layers=2)
MINI_MESH = (2, 4)
MINI_SHAPE = dict(seq_len=64, global_batch=8)

MINI_REFERENCE = """
import dataclasses, json
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_arch, reduce, SHAPES
from repro.distributed.sharding import ShardingRules
from repro.launch import hlo_analysis
from repro.launch.dryrun import _compile_step
from repro.launch.dryrun import _compile_step  # sets the 512-device flag before JAX starts
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))  # Auto axes
cfg = dataclasses.replace(reduce(get_arch("glm4-9b")), **MINI)
shape = dataclasses.replace(SHAPES["train_4k"], **MINI_SHAPE)
lowered, compiled = _compile_step(cfg, shape, mesh, ShardingRules(mesh), "nothing")
text = compiled.as_text()
print(json.dumps({"bytes": hlo_analysis.collective_bytes(text),
                  "counts": hlo_analysis.count_collectives(text)}))
"""


def _mini():
    cfg = dataclasses.replace(reduce(get_arch("glm4-9b")), **MINI)
    return cfg, dataclasses.replace(SHAPES["train_4k"], **MINI_SHAPE)


def closed_form(cfg, shape, mesh_sizes):
    """One rank's collectives in a training step of the dense model under
    remat "nothing", with the sequence split over model (the rules'
    default), from the parameter specs and the activations' shapes: per kind
    the result bytes and the calls. Forward: each FSDP-split weight gathered
    over data on use (each block's on entry), the residual stream gathered
    along the sequence into the attention and the MLP and reduce-scattered
    out of them (the embedding's rows too), the final hidden states
    gathered, the head gathered, and the vocab-parallel loss's max, sum and
    true logit all-reduced, the loss over data. Backward: the loss chunk
    recomputed up to its last saved tensor (max and sum again); each block
    recomputed up to the MLP's last product (every gather again, the
    attention's reduce-scatter again); each collective's conjugate; the
    gradients of the weights not split over data all-reduced (the norm
    scales over data and model, the sequence being split); the global norm's
    two sums, over (data, model) and over model."""
    data, model = mesh_sizes
    rules = ShardingRules(virtual_mesh(mesh_sizes))
    params = meta_params(cfg)
    specs = {n: sh.spec for n, sh in params_sharding(params, rules).items()}
    item = 4 if cfg.param_dtype == "float32" else 2
    sizes = {"data": data, "model": model}

    def nbytes(name, gathered):
        n = 1
        for dim, entry in zip(params.get_parameter(name).shape, specs[name]):
            axes = spec_axes((entry,))
            n *= dim // int(np.prod([sizes[a] for a in axes if a != "data" or not gathered], initial=1))
        return n * item

    b, s, d = shape.global_batch // data, shape.seq_len, cfg.d_model
    full, part, tokens = b * s * d * item, b * (s // model) * d * item, b * s
    ag, rs, ar = [], [], []
    fsdp = [n for n in specs if "data" in spec_axes(specs[n])]
    other = [n for n in specs if n not in fsdp]
    blocks = [[n for n in specs if n.startswith(f"blocks.{i}.")] for i in range(cfg.n_layers)]
    # forward
    ag.append(nbytes("embed", True))
    rs.append(part)
    for names in blocks:
        ag += [nbytes(n, True) for n in names if n in fsdp] + [full, full]
        rs += [part, part]
    ag += [full, nbytes("head", True)]
    ar += [tokens * 4] * 3 + [4]
    # backward
    ar += [tokens * 4] * 2
    rs += [nbytes("head", False), part]
    ar += [nbytes("final_norm.scale", False)]
    for names in blocks:
        ag += [nbytes(n, True) for n in names if n in fsdp] + [full, full]
        rs += [part]
        ag += [full, full]
        rs += [part, part] + [nbytes(n, False) for n in names if n in fsdp]
        ar += [nbytes(n, False) for n in names if n in other]
    ag.append(full)
    rs.append(nbytes("embed", False))
    ar += [4, 4]
    return ({"all-gather": sum(ag), "reduce-scatter": sum(rs), "all-reduce": sum(ar)},
            {"all-gather": len(ag), "reduce-scatter": len(rs), "all-reduce": len(ar)})


def test_virtual_collectives_equal_the_closed_form(capfd):
    """The mini dry-run of ``tests/test_distributed.py`` on a (2, 4) mesh:
    the virtual group's per-kind bytes and calls equal :func:`closed_form`.
    The reference's compiled breakdown for the same step on an Auto (2, 4)
    mesh is printed beside them, not held: GSPMD chooses its own
    collectives."""
    cfg, shape = _mini()
    mesh = virtual_mesh(MINI_MESH)
    traced = dryrun._compile_step(cfg, shape, mesh, ShardingRules(mesh), "nothing")
    want_bytes, want_counts = closed_form(cfg, shape, MINI_MESH)
    assert traced["coll_bytes"] == want_bytes
    assert traced["coll_counts"] == want_counts
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    env.pop("XLA_FLAGS", None)
    code = (f"MINI = {MINI!r}\nMINI_SHAPE = {MINI_SHAPE!r}\n") + MINI_REFERENCE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    with capfd.disabled():
        print(f"\n[mini (2, 4)] port per rank: bytes {traced['coll_bytes']} calls "
              f"{traced['coll_counts']}; reference compiled (GSPMD) per device: bytes "
              f"{ref['bytes']} calls {ref['counts']}")
    assert sum(ref["bytes"].values()) > 0


def test_multipod_table_equals_the_references(tmp_path):
    """``bench.roofline_table.multipod_table`` and the JAX package's
    ``benchmarks/roofline_table.py::multipod_table`` give the same string on
    the same synthetic 512-chip records (a traced cell with fallbacks, one
    without, a skipped one; a 256-chip record that neither reads)."""
    from benchmarks.roofline_table import multipod_table as ref_multipod_table

    base = {"mesh": "2x16x16", "chips": 512, "memory_analysis": {"temp_size_in_bytes": 3 * 2**30}}
    records = {
        "glm4-9b_train_4k_512": dict(base, arch="glm4-9b", shape="train_4k",
                                     fallbacks=["kv_heads:dim2"]),
        "qwen2.5-32b_train_4k_512": dict(base, arch="qwen2.5-32b", shape="train_4k", fallbacks=[],
                                         memory_analysis={"temp_size_in_bytes": 7.5 * 2**30}),
        "glm4-9b_long_500k_512": {"arch": "glm4-9b", "shape": "long_500k", "skipped": "full attention"},
        "glm4-9b_train_4k_256": dict(base, arch="glm4-9b", shape="train_4k", chips=256),
    }
    for tag, rec in records.items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    got = multipod_table(str(tmp_path))
    assert got == ref_multipod_table(str(tmp_path))
    assert got.count("\n") == 4 and "kv_heads:dim2" in got and "SKIP" in got


def test_dryrun_main_over_the_production_meshes(tmp_path, capsys):
    """``dryrun --mesh both`` writes a dense training cell's 256- and 512-chip
    records (``multipod_table`` reads the second); the serving shapes and
    another family over a mesh print ``[TODO]`` with the ROADMAP item and
    write nothing."""
    register(reduce(get_arch("glm4-9b")))
    register(reduce(get_arch("mamba2-130m")))
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "glm4-9b-smoke", "--mesh", "both", "--out", str(tmp_path)])
    assert done.value.code == 0
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-130m-smoke", "--shape", "train_4k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "[OK] glm4-9b-smoke_train_4k_256" in out and "[OK] glm4-9b-smoke_train_4k_512" in out
    assert "[TODO] glm4-9b-smoke_prefill_32k_256" in out and "ROADMAP" in out
    assert "[TODO] mamba2-130m-smoke_train_4k_256" in out
    names = sorted(f.name for f in tmp_path.glob("*.json"))
    assert "glm4-9b-smoke_train_4k_256.json" in names and "glm4-9b-smoke_train_4k_512.json" in names
    assert not any(n.startswith("mamba2") or "prefill" in n or "decode" in n for n in names)
    rec = json.loads((tmp_path / "glm4-9b-smoke_train_4k_256.json").read_text())
    assert rec["chips"] == 256 and rec["coll_bytes"] > 0 and rec["collective_s"] > 0
    assert "glm4-9b-smoke | train_4k | yes" in multipod_table(str(tmp_path))
