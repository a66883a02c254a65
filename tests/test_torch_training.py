"""The port's training path on the CPU (``models`` loss and remat,
``optim``, ``data``, ``checkpoint``, ``launch.train``) against the JAX
package on the reduced glm4-9b (2 layers, d 128, 4/2 heads, head dim 32,
vocab 512, f32), plus twins of ``tests/test_training.py``.

Weights and optimizer state cannot be drawn alike, so the JAX package's are
carried across (``params_from_numpy``, ``named_from_numpy``,
``optim.state_from_numpy``); the QKV biases and norm scales are random so
that their gradients are compared too. The JAX side runs its CPU path
(``impl="xla"``: the blocked ``flash_xla`` and its custom VJP); the port's
CPU tensors take the plain flash forward under autograd.
"""
import dataclasses
import functools
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduce as jreduce
from repro.data.pipeline import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model, transformer as jtr
from repro.optim import adamw as jadamw
from repro.optim.compression import (CompressionConfig as JCompressionConfig,
                                     compress_grads as jcompress_grads)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduce
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.ft.monitor import PreemptionHandler, StragglerMonitor
from repro_torch.launch import train
from repro_torch.models import Model, build_model, named_from_numpy, params_from_numpy
from repro_torch.optim import (AdamWConfig, CompressionConfig, adamw, apply_updates,
                               compress_grads, init_state, state_from_numpy)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

REMATS = ("everything", "none", "nothing", "dots", "dots_no_batch")
# f32 on both sides: the same model, summed in other orders (XLA against
# PyTorch's CPU kernels, blocked against whole-matrix attention); the
# gradients reach ~1e-3 at most, so a few ulps of the loss's terms
LOSS_TOL = dict(atol=2e-6, rtol=2e-6)
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)
# the optimizer: the same f32 elementwise formula; pow, sqrt and the global
# norm's sum order may round differently by an ulp
OPT_TOL = dict(atol=1e-7, rtol=2e-6)
# a few training steps: the losses of both trainers, as LOSS_TOL, carried
# through updates scaled by lr 3e-4
RUN_TOL = dict(atol=2e-5, rtol=2e-6)


@functools.lru_cache(maxsize=None)
def _setup():
    """(port cfg, JAX cfg, numpy params) of the reduced glm4-9b."""
    jcfg = jreduce(jget_arch("glm4-9b"))
    cfg = reduce(get_arch("glm4-9b"))
    np_params = jax.tree_util.tree_map(np.array, jtr.init_params(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(0)
    attn = np_params["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(np.float32)
    for norm in (np_params["layers"]["attn_norm"], np_params["layers"]["mlp_norm"],
                 np_params["final_norm"]):
        norm["scale"] = rng.uniform(0.5, 1.5, norm["scale"].shape).astype(np.float32)
    return cfg, jcfg, np_params


def _port_params(cfg, np_params):
    return params_from_numpy(cfg, np_params).requires_grad_(True)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads():
    cfg, jcfg, np_params = _setup()
    batch = {"tokens": jnp.asarray(_tokens(1, (2, 33)))}
    loss, grads = jax.jit(jax.value_and_grad(jbuild_model(jcfg, remat="dots").loss))(
        _jax_tree(np_params), batch)
    return float(loss), named_from_numpy(cfg, jax.tree_util.tree_map(np.array, grads))


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(remat):
    cfg, _, np_params = _setup()
    params = _port_params(cfg, np_params)
    model = build_model(cfg, "cpu", remat=remat)
    loss = model.loss(params, {"tokens": torch.from_numpy(_tokens(1, (2, 33)))})
    names, leaves = zip(*params.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_match_reference(remat):
    """``Model.loss`` and every gradient against ``jax.value_and_grad`` of
    the JAX model's loss; under every remat policy the port's loss and
    gradients are bit-equal to those without recomputation."""
    want_loss, want = _reference_loss_and_grads()
    loss, grads = _port_loss_and_grads(remat)
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL, err_msg=name)
    base_loss, base = _port_loss_and_grads("everything")
    assert torch.equal(loss, base_loss)
    assert all(torch.equal(grads[n], base[n]) for n in grads)


def test_cross_entropy_and_chunked_loss_match_reference():
    """``cross_entropy`` and ``lm_loss`` at chunks smaller than the token
    count (the chunks summed in order) against the JAX package's."""
    from repro.models import common as jcm
    from repro_torch.models import common as cm

    cfg, jcfg, np_params = _setup()
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(cm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), **LOSS_TOL)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = jcm.lm_loss(_jax_tree(np_params), jnp.asarray(x), jnp.asarray(labels), jcfg,
                       chunk_tokens=5)
    with torch.no_grad():
        got = cm.lm_loss(_port_params(cfg, np_params), torch.from_numpy(x),
                         torch.from_numpy(labels), cfg, chunk_tokens=5)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_build_model_remat_and_families():
    cfg = reduce(get_arch("glm4-9b"))
    assert build_model(cfg, "cpu").remat == "dots"
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, "cpu", remat="some")
    assert build_model(dataclasses.replace(cfg, family="ssm"), "cpu").remat == "dots"
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="rwkv"), "cpu")


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------
def _opt_inputs(seed, big):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    scale = 10.0 if big else 0.01  # global norms well above and below the clip
    grads = [{n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("big", [True, False], ids=["clipped", "unclipped"])
def test_apply_updates_matches_reference(big):
    params, grads = _opt_inputs(4, big)
    cfg = AdamWConfig(lr=1e-2)
    jp, js = _jax_tree(params), jadamw.init_state(_jax_tree(params))
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ts = init_state(tp)
    for i, g in enumerate(grads):
        jp, js = jadamw.apply_updates(jp, _jax_tree(g), js, jadamw.AdamWConfig(lr=1e-2),
                                      lr_scale=0.5 + 0.25 * i)
        ts = apply_updates(tp, {n: torch.from_numpy(a) for n, a in g.items()}, ts, cfg,
                           lr_scale=0.5 + 0.25 * i)
    gn = float(adamw.global_norm({n: torch.from_numpy(a) for n, a in grads[0].items()}))
    assert (gn > cfg.grad_clip) == big
    assert int(ts.step) == int(js.step) == 3
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), **OPT_TOL, err_msg=n)
        np.testing.assert_allclose(ts.m[n].numpy(), np.asarray(js.m[n]), **OPT_TOL, err_msg=n)
        np.testing.assert_allclose(ts.v[n].numpy(), np.asarray(js.v[n]), **OPT_TOL, err_msg=n)


@pytest.mark.parametrize("kind", ["none", "bf16", "int8_ef"])
def test_compress_grads_matches_reference(kind):
    """Over several steps, the error-feedback residual carried along."""
    _, grads = _opt_inputs(5, True)
    jef = {n: jnp.zeros(a.shape, jnp.float32) for n, a in grads[0].items()}
    tef = {n: torch.zeros(a.shape) for n, a in grads[0].items()}
    if kind != "int8_ef":
        jef = tef = None
    for g in grads:
        jout, jef = jcompress_grads(_jax_tree(g), jef, JCompressionConfig(kind))
        tout, tef = compress_grads({n: torch.from_numpy(a) for n, a in g.items()}, tef,
                                   CompressionConfig(kind))
        for n in g:
            np.testing.assert_allclose(tout[n].numpy(), np.asarray(jout[n]), atol=1e-7, rtol=1e-6)
            if kind == "int8_ef":
                np.testing.assert_allclose(tef[n].numpy(), np.asarray(jef[n]), atol=1e-7, rtol=1e-6)


def test_adamw_descends_quadratic():
    params = {"w": torch.ones(4) * 5}
    state = init_state(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(120):
        state = apply_updates(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.3
    assert int(state.step) == 120


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    state = init_state(params)
    apply_updates(params, {"w": torch.tensor([1e6, 0.0, 0.0])}, state,
                  AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0))
    assert float(params["w"].abs().max()) < 10.0


def test_bf16_compression_close():
    g = {"a": torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))}
    out, _ = compress_grads(g, None, CompressionConfig("bf16"))
    assert float((out["a"] - g["a"]).abs().max()) < 0.01


def test_int8_ef_error_feedback_is_lossless_over_time():
    g_true = torch.from_numpy(np.random.default_rng(1).standard_normal(128).astype(np.float32))
    ef = {"a": torch.zeros(128)}
    acc = torch.zeros(128)
    for _ in range(50):
        out, ef = compress_grads({"a": g_true}, ef, CompressionConfig("int8_ef"))
        acc = acc + out["a"]
    assert float((acc / 50 - g_true).abs().max() / g_true.abs().max()) < 0.02


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_pipeline_batches_equal_reference_byte_for_byte():
    for cfg_kw, shards in ((dict(vocab=512, seq_len=32, global_batch=4, seed=7), (1, 2)),
                           (dict(vocab=151552, seq_len=64, global_batch=2, seed=0), (1,))):
        for num_shards in shards:
            for shard in range(num_shards):
                mine = TokenPipeline(DataConfig(**cfg_kw), shard, num_shards)
                theirs = JTokenPipeline(JDataConfig(**cfg_kw), shard, num_shards)
                for step in (0, 5, 13):
                    a, b = mine.batch_at(step), theirs.batch_at(step)
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=4, seed=7)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    assert np.array_equal(p1.batch_at(13), p2.batch_at(13))
    assert not np.array_equal(p1.batch_at(13), p1.batch_at(14))


def test_pipeline_shard_invariance():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=4, seed=7)
    whole = TokenPipeline(cfg).batch_at(5)
    s0 = TokenPipeline(cfg, shard=0, num_shards=2).batch_at(5)
    s1 = TokenPipeline(cfg, shard=1, num_shards=2).batch_at(5)
    assert np.array_equal(np.concatenate([s0, s1]), whole)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16) * 1.5}}
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"loss": float(step)})
    assert mgr.all_steps() == [2, 3]  # keep=2 garbage-collects step 1
    restored, extra = mgr.restore(tree)
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16 and torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert extra["loss"] == 3.0
    manifest = (mgr._step_dir(3) / "MANIFEST.json").read_text()
    assert "b/c::bf16" in manifest  # bf16 stored as its uint16 bits, as the JAX package does


def test_checkpoint_of_model_and_adamw_state(tmp_path):
    """The trainer's tree: a module restored in place, the AdamW state's step
    and moments restored under their JAX-style keys."""
    cfg, _, np_params = _setup()
    params = _port_params(cfg, np_params)
    state = init_state(params)
    state = apply_updates(params, {n: torch.ones_like(p) for n, p in params.named_parameters()},
                          state, AdamWConfig())
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": params, "opt": state})
    fresh = _port_params(cfg, np_params)
    restored, _ = mgr.restore({"params": fresh, "opt": init_state(fresh)})
    assert restored["params"] is fresh
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), params.parameters()))
    assert int(restored["opt"].step) == 1
    assert all(torch.equal(restored["opt"].m[n], state.m[n]) for n in state.m)
    assert "opt/.m/blocks.0.attn.wq" in (mgr._step_dir(1) / "MANIFEST.json").read_text()


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(1000)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_corruption_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    mgr.save(1, tree)
    mgr.save(2, {"w": tree["w"] + 1})
    (mgr._step_dir(2) / "arrays.npz").write_bytes(b"garbage")
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["w"], torch.arange(4, dtype=torch.float32))


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, {"w": torch.zeros(8)})
    assert all(not p.name.startswith(".tmp") for p in tmp_path.iterdir())


# ---------------------------------------------------------------------------
# fault tolerance monitors
# ---------------------------------------------------------------------------
def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=16, threshold=2.0, patience=2)
    for i in range(12):
        mon.record(i, 0.1)
    assert mon.record(12, 0.5).flagged
    assert not mon.should_replace
    mon.record(13, 0.5)
    assert mon.should_replace


def test_preemption_handler_sets_flag():
    with PreemptionHandler(signals=(signal.SIGUSR1,)) as h:
        assert not h.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert h.preempted


# ---------------------------------------------------------------------------
# train steps and the trainer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_reference():
    tcfg = train.TrainConfig(arch="x", steps=30, warmup=4)
    jcfg = jtrain.TrainConfig(arch="x", steps=30, warmup=4)
    for step in (0, 1, 3, 4, 5, 17, 29, 40):
        np.testing.assert_allclose(float(train.lr_schedule(tcfg, torch.tensor(step))),
                                   float(jtrain.lr_schedule(jcfg, jnp.asarray(step))),
                                   atol=1e-7, rtol=1e-6)
    assert float(train.lr_schedule(tcfg, torch.tensor(0))) == 0.0


def test_microbatched_grads_match_full_batch():
    cfg, _, np_params = _setup()
    model = build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(0, (4, 33), cfg.vocab))}
    outs = []
    for micro in (None, 2):
        params = _port_params(cfg, np_params)
        step = train.make_train_step(model, train.TrainConfig(arch="x", global_batch=4,
                                                              microbatch=micro, steps=1),
                                     AdamWConfig(), CompressionConfig("none"))
        loss, params, _, _ = step(params, init_state(params), batch, None)
        outs.append((float(loss), [p.detach().clone() for p in params.parameters()]))
    assert abs(outs[0][0] - outs[1][0]) < 5e-3
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


@pytest.mark.parametrize("micro,comp", [(None, "none"), (2, "int8_ef")], ids=["full", "micro-int8ef"])
def test_train_step_matches_reference(micro, comp):
    """Three ``make_train_step`` steps of both trainers from the same weights
    and the same (non-zero) AdamW state, carried across after one step of
    the JAX trainer."""
    cfg, jcfg, np_params = _setup()
    tkw = dict(arch="x", global_batch=4, microbatch=micro, steps=8, warmup=2, compression=comp)
    jmodel = jbuild_model(jcfg)
    jstep = jtrain.make_train_step(jmodel, jtrain.TrainConfig(**tkw), jadamw.AdamWConfig(),
                                   JCompressionConfig(comp))
    jp, js = _jax_tree(np_params), jadamw.init_state(_jax_tree(np_params))
    jef = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32), jp) if comp == "int8_ef" else None
    _, jp, js, jef = jstep(jp, js, {"tokens": jnp.asarray(_tokens(10, (4, 33)))}, jef)
    np_p = jax.tree_util.tree_map(np.array, jp)
    params = _port_params(cfg, np_p)
    state = state_from_numpy(js.step, named_from_numpy(cfg, jax.tree_util.tree_map(np.array, js.m)),
                             named_from_numpy(cfg, jax.tree_util.tree_map(np.array, js.v)))
    ef = ({n: torch.from_numpy(a.copy()) for n, a in named_from_numpy(
        cfg, jax.tree_util.tree_map(np.array, jef)).items()} if jef is not None else None)
    step = train.make_train_step(build_model(cfg, "cpu"), train.TrainConfig(**tkw), AdamWConfig(),
                                 CompressionConfig(comp))
    for i in range(3):
        tokens = _tokens(11 + i, (4, 33))
        jl, jp, js, jef = jstep(jp, js, {"tokens": jnp.asarray(tokens)}, jef)
        tl, params, state, ef = step(params, state, {"tokens": torch.from_numpy(tokens)}, ef)
        np.testing.assert_allclose(float(tl), float(jl), **RUN_TOL)
    assert int(state.step) == int(js.step) == 4
    want = named_from_numpy(cfg, jax.tree_util.tree_map(np.array, jp))
    for n, p in params.named_parameters():
        got = p.detach().numpy()
        # Adam divides by sqrt(v): where a gradient is within rounding of 0
        # the two packages' updates may differ by up to ~lr a step. Without
        # compression every other element agrees closely; int8_ef rounds each
        # gradient to one of 255 levels, and a rounding that flips there
        # moves the element by up to ~lr too
        np.testing.assert_allclose(got, want[n], atol=3 * 2 * 3e-4, rtol=0, err_msg=n)
        if comp == "none":
            close = np.isclose(got, want[n], atol=2e-6, rtol=2e-5)
            assert close.mean() >= 0.99, (n, close.mean())


def _inject_reference_init(monkeypatch, jcfg):
    """The port's ``Model.init`` returns the JAX trainer's initial weights
    (``init_params(PRNGKey(seed))``) carried across, as ``ReferenceDraws``
    injects build draws."""
    def init(self, generator):
        key = jax.random.PRNGKey(generator.initial_seed())
        np_params = jax.tree_util.tree_map(np.array, jbuild_model(jcfg).init(key))
        return params_from_numpy(self.cfg, np_params)

    monkeypatch.setattr(Model, "init", init)


RUN = dict(arch="glm4-9b", smoke=True, seq_len=32, global_batch=2, warmup=2, log_every=100)


def test_run_matches_reference(monkeypatch):
    """``run()`` on the reduced glm4-9b: six losses equal to the JAX
    trainer's from the same initial weights and the same batches."""
    _, jcfg, _ = _setup()
    _inject_reference_init(monkeypatch, jcfg)
    mine = train.run(train.TrainConfig(steps=6, **RUN), device="cpu")
    theirs = jtrain.run(jtrain.TrainConfig(steps=6, **RUN))
    assert len(mine["losses"]) == len(theirs["losses"]) == 6
    np.testing.assert_allclose(mine["losses"], theirs["losses"], **RUN_TOL)
    assert mine["losses"][-1] < mine["losses"][0]


def preempt_at(monkeypatch, step):
    """Send this process SIGTERM when ``run()`` records ``step``: its
    preemption handler then saves a final checkpoint after that step and
    stops (the learning-rate schedule depends on ``steps``, so a run that
    is to be resumed into a 30-step run must be a 30-step run cut short)."""
    record = StragglerMonitor.record

    def recording(self, s, seconds):
        if s == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return record(self, s, seconds)

    monkeypatch.setattr(train.StragglerMonitor, "record", recording)


def test_run_resumes_bit_identically(tmp_path, monkeypatch):
    """A 30-step run with a checkpoint every 10, preempted after 25 steps,
    then resumed to 30, against an uninterrupted 30-step run: the same
    losses, bit for bit."""
    kw = dict(RUN, steps=30, seq_len=16, ckpt_every=10, async_ckpt=False)
    whole = train.run(train.TrainConfig(**kw), device="cpu")["losses"]
    with monkeypatch.context() as m:
        preempt_at(m, 24)
        first = train.run(train.TrainConfig(**kw, ckpt_dir=str(tmp_path)), device="cpu")["losses"]
    assert len(first) == 25 and CheckpointManager(tmp_path).all_steps() == [10, 20, 25]
    rest = train.run(train.TrainConfig(**kw, ckpt_dir=str(tmp_path)), device="cpu")["losses"]
    assert len(rest) == 5
    assert first + rest == whole
    assert whole[-1] < whole[0]


def test_run_raises_on_a_mesh_and_unported_family(capsys):
    """A mesh of two devices with no process group behind it raises
    ``ValueError`` naming the missing group (nothing falls back to one
    device); the default ``--arch`` (mamba2-130m) trains one smoke step."""
    from repro_torch.distributed.sharding import ShardMesh

    with pytest.raises(ValueError, match="no process group"):
        train.run(train.TrainConfig(**RUN), mesh=ShardMesh((torch.device("cpu"),) * 2), device="cpu")
    train.main(["--smoke", "--device", "cpu", "--steps", "1", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "[train] step=0 loss=" in out and "[train] done: first=" in out
