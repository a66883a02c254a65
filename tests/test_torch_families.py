"""The port's MoE, SSM, hybrid and encoder-decoder families
(``repro_torch.models.moe``, ``mamba2``, ``zamba2``, ``encdec``, through
``build_model``, ``launch.serve`` and ``launch.train``) against the JAX
package on the CPU, each at ``reduce(cfg)`` in f32.

The JAX package's initialised parameters are carried across with
``params_from_numpy``; the norm scales and the SSM's biases, ``D`` and
``a_log`` are replaced by random values first, so that their paths (and
gradients) are compared too. The JAX side runs its default CPU path (the
blocked ``flash_xla`` and its custom VJP); the port's CPU tensors take the
plain flash version under autograd.

Tolerances, f32 on both sides with the sums in other orders:
* ``TOL`` (logits, caches, hidden states): as ``tests/test_torch_models.py``,
  atol = rtol = 2e-5;
* ``LOSS_TOL``, ``GRAD_TOL``, ``RUN_TOL`` (losses, every leaf's gradient, a
  few training steps): as ``tests/test_torch_training.py``;
* zamba2's gradients (``HYBRID_GRAD_REL``): ``GRAD_TOL``, with the absolute
  part raised to 5e-5 of each leaf's own largest |gradient| where that is
  more. Its four SSM layers carry cumulative decay sums in the exponent,
  where one f32 rounding of a large |cum| moves exp(cum) by ~1e-5 relative,
  and the two packages sum cum in other orders (XLA's cumsum against
  PyTorch's); the embedding's gradient (largest 2.7, through x0 at every site)
  then differs by up to 1.4e-5 of its largest value, block 0's in_proj by
  2.5e-5. A wrong term moves a leaf by percents.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, list_archs as jlist_archs, reduce as jreduce
from repro.kernels.flash_xla import flash_attention_xla
from repro.launch import serve as jserve, train as jtrain
from repro.models import (build_model as jbuild_model, common as jcm, mamba2 as jmb, moe as jmoe,
                          zamba2 as jzamba2)
from repro_torch.configs import get_arch, list_archs, reduce
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.launch import serve, train
from repro_torch.models import (Model, build_model, common as cm, encdec, mamba2 as mb, moe,
                                named_from_numpy, params_from_numpy, zamba2)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_TOL = dict(atol=2e-6, rtol=2e-6)
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)
RUN_TOL = dict(atol=2e-5, rtol=2e-6)
HYBRID_GRAD_REL = 5e-5
# bf16 prefill(t) + decode against prefill(t + 1): the port's gap may differ
# from the reference's on the same weights by this factor either way (both
# round to bf16 at the same points; XLA and PyTorch sum in other orders).
# Read on the CPU: mamba2 9.401e-3 against 8.320e-3, zamba2 1.455e-2
# against 1.390e-2 (the reference's in f32: 5.6e-7 and 7.1e-7).
BF16_GAP_RATIO = 1.5

ARCHS = {"moe": "mixtral-8x7b", "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
         "encdec": "seamless-m4t-large-v2"}
FAMILIES = tuple(ARCHS)


def _randomize(tree, rng):
    """Norm scales, SSM biases, D and a_log off their init values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "scale" or k == "ssm_d":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("conv_bias", "dt_bias"):
            out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif k == "a_log":
            out[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _setup(family):
    """(port cfg, JAX cfg, numpy params, JAX params, port params)."""
    arch = ARCHS[family]
    jcfg, cfg = jreduce(jget_arch(arch)), reduce(get_arch(arch))
    np_params = jax.tree_util.tree_map(np.array, jbuild_model(jcfg).init(jax.random.PRNGKey(2)))
    np_params = _randomize(np_params, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return cfg, jcfg, np_params, jparams, params_from_numpy(cfg, np_params)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _batch(family, seed, t=17, src=24):
    """Numpy inputs: tokens (2, t), or encdec's source frames (2, src, 128)
    and target tokens (2, t)."""
    if family == "encdec":
        rng = np.random.default_rng(seed)
        return {"src_embeds": rng.standard_normal((2, src, 128)).astype(np.float32),
                "tgt_tokens": _tokens(seed + 1, (2, t))}
    return {"tokens": _tokens(seed, (2, t))}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _close_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert tuple(got.shape) == tuple(want.shape), (path, got.shape, want.shape)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL, err_msg=path)


# ---------------------------------------------------------------------------
# configs and the model API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jlist_archs()))
def test_config_and_param_count_match_reference(name):
    """Every field, ``d_inner``, ``ssm_heads``, ``param_count`` and
    ``active_param_count`` of all ten architectures and their reductions."""
    for port, want in ((get_arch(name), jget_arch(name)), (reduce(get_arch(name)), jreduce(jget_arch(name)))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(want, f.name), f.name
        for prop in ("hd", "vocab_padded", "d_inner", "ssm_heads"):
            assert getattr(port, prop) == getattr(want, prop), prop
        assert port.param_count() == want.param_count()
        assert port.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("family", FAMILIES)
def test_init_params_names_shapes_and_distributions(family):
    """The port's random weights hold a parameter for every leaf of the JAX
    package's, of its shape; the same seed gives the same weights."""
    cfg, _, np_params, _, _ = _setup(family)
    model = build_model(cfg, "cpu")
    p = model.init(torch.Generator().manual_seed(0))
    want = named_from_numpy(cfg, np_params)
    got = dict(p.named_parameters())
    assert set(got) == set(want)
    assert all(tuple(got[n].shape) == want[n].shape for n in want)
    assert abs(float(p.embed.std()) - 0.02) < 2e-3
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


@pytest.mark.parametrize("family", FAMILIES)
def test_init_cache_matches_reference(family):
    cfg, jcfg, _, _, _ = _setup(family)
    got = build_model(cfg, "cpu").init_cache(3, 20)
    want = jbuild_model(jcfg).init_cache(3, 20)
    flat_g, flat_w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert [tuple(t.shape) for t in flat_g] == [tuple(t.shape) for t in flat_w]
    assert [str(t.dtype).split(".")[-1] for t in flat_g] == [str(t.dtype) for t in flat_w]


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(family):
    """``Model.loss`` and every leaf's gradient against
    ``jax.value_and_grad`` of the JAX model's loss (remat "dots" on both;
    MoE's includes the aux loss at weight 0.01)."""
    cfg, jcfg, np_params, jparams, _ = _setup(family)
    batch = _batch(family, 1, t=33)
    want_loss, want = jax.jit(jax.value_and_grad(jbuild_model(jcfg).loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = named_from_numpy(cfg, jax.tree_util.tree_map(np.array, want))
    params = params_from_numpy(cfg, np_params).requires_grad_(True)
    loss = build_model(cfg, "cpu").loss(params, _torch_batch(batch))
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **LOSS_TOL)
    assert set(grads) == set(want)
    for name, g in grads.items():
        atol = GRAD_TOL["atol"]
        if family == "hybrid":
            atol = max(atol, HYBRID_GRAD_REL * float(np.abs(want[name]).max()))
        np.testing.assert_allclose(g.numpy(), want[name], rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=name)


def test_zamba2_shared_block_gradient_sums_over_sites():
    """The shared block's gradient is the sum of what each site would get
    from an untied copy of its own (here 2 sites), and every copy gets a
    gradient of its own: the weights are read at every site."""
    cfg, _, np_params, _, _ = _setup("hybrid")
    tokens = torch.from_numpy(_tokens(3, (2, 13))).long()
    tied = params_from_numpy(cfg, np_params).requires_grad_(True)
    loss = zamba2.loss_fn(tied, {"tokens": tokens}, cfg)
    names = [n for n, _ in tied.shared.named_parameters()]
    tied_g = torch.autograd.grad(loss, list(tied.shared.parameters()))

    untied = params_from_numpy(cfg, np_params).requires_grad_(True)
    sites = [params_from_numpy(cfg, np_params).shared.requires_grad_(True)
             for _ in zamba2.group_slices(cfg)]

    def forward(tokens):
        x = cm.embed(untied, tokens)
        x0 = x
        for (lo, hi), site in zip(zamba2.group_slices(cfg), sites):
            for blk in untied.blocks[lo:hi]:
                x = blk(x)
            x = zamba2.shared_block(site, x, x0, cfg)
        return cm.rms_norm(x, untied.final_norm.scale)

    inp = tokens[:, :-1]
    l2 = cm.lm_loss(untied, forward(inp), tokens[:, 1:], cfg)
    per_site = [torch.autograd.grad(l2, list(s.parameters()), retain_graph=True) for s in sites]
    np.testing.assert_allclose(float(l2.detach()), float(loss.detach()), **LOSS_TOL)
    for i, name in enumerate(names):
        assert all(float(g[i].abs().max()) > 0 for g in per_site), name
        np.testing.assert_allclose(sum(g[i] for g in per_site).numpy(), tied_g[i].numpy(),
                                   **GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_and_decode_step_match_reference(family):
    """Prefill's last-token logits and every cache leaf, then one decode
    step's logits and cache, against the JAX model's."""
    cfg, jcfg, _, jparams, params = _setup(family)
    batch = _batch(family, 5, t=13)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model, jmodel = build_model(cfg, "cpu"), jbuild_model(jcfg)
    logits, cache = model.prefill(params, _torch_batch(batch))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jbatch)
    assert logits.shape == (2, cfg.vocab_padded)
    _close(logits, jlogits)
    _close_tree(cache, jcache)
    nxt = _tokens(6, (2,))
    pos = 13
    logits, cache = model.decode(params, cache, torch.from_numpy(nxt).long(), pos)
    jlogits, jcache = jax.jit(jmodel.decode)(jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
    _close(logits, jlogits)
    _close_tree(cache, jcache)


def test_mixtral_windowed_decode_wraps_the_ring():
    """A window of 8 under 13 prompt tokens: prefill keeps the last 8 keys,
    and three decode steps write the ring buffer's slots as the JAX
    package's do."""
    cfg, jcfg, _, jparams, params = _setup("moe")
    cfg, jcfg = dataclasses.replace(cfg, window=8), dataclasses.replace(jcfg, window=8)
    tokens = _tokens(7, (2, 16))
    logits, cache = moe.prefill(params, {"tokens": torch.from_numpy(tokens).long()}, cfg)
    jlogits, jcache = jmoe.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    assert cache["k"].shape[2] == 8
    _close(logits, jlogits)
    for pos in (16, 17, 18):
        nxt = _tokens(pos, (2,))
        logits, cache = moe.decode_step(params, cache, torch.from_numpy(nxt).long(), pos, cfg)
        jlogits, jcache = jmoe.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32), jcfg)
        _close(logits, jlogits)
        _close_tree(cache, jcache)


def _inject_reference_init(monkeypatch, jcfg):
    """The port's ``Model.init`` returns the JAX driver's initial weights
    (``init_params(PRNGKey(seed))``) carried across."""
    def init(self, generator):
        key = jax.random.PRNGKey(generator.initial_seed())
        return params_from_numpy(self.cfg, jax.tree_util.tree_map(np.array, jbuild_model(jcfg).init(key)))

    monkeypatch.setattr(Model, "init", init)


@pytest.mark.parametrize("family", FAMILIES)
def test_serve_run_greedy_tokens_match_reference_driver(family, monkeypatch):
    """``launch.serve.run(smoke=True)`` against ``repro.launch.serve.run``
    from the same weights, token for token: the prompt (for encdec the
    source frames, then max(4, gen // 2) target tokens) drawn in the same
    order from the same generator, decode from the same position. A MoE
    route that a last-bit near-tie flips would show here as a different
    token; none does at this seed."""
    _, jcfg, _, _, _ = _setup(family)
    _inject_reference_init(monkeypatch, jcfg)
    kw = dict(smoke=True, batch=2, prompt_len=16, gen=6, seed=3)
    mine = serve.run(ARCHS[family], device="cpu", **kw)
    theirs = jserve.run(ARCHS[family], **kw)
    np.testing.assert_array_equal(mine["tokens"], theirs["tokens"])
    assert mine["logits_finite"] and mine["tokens"].shape == (2, 7)


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------
def _reference_dispatch(p, x, cfg, groups=32):
    """The reference's routing buffers, its lines step for step
    (``repro/models/moe.py:46-80``, which keeps them local)."""
    import math

    xt = x.reshape(-1, x.shape[-1])
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    g = min(groups, t)
    while t % g:
        g -= 1
    tl = t // g
    cap = min(max(int(math.ceil(cfg.capacity_factor * tl * k / e)), 1), tl * k)
    xg = xt.reshape(g, tl, -1)
    probs = jax.nn.softmax((xg @ p["router"]).astype(jnp.float32), axis=-1)
    topw, topi = jax.lax.top_k(probs, k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    eid = topi.reshape(g, tl * k)
    w = topw.reshape(g, tl * k)
    order = jnp.argsort(eid, axis=1)
    sorted_eid = jnp.take_along_axis(eid, order, axis=1)
    seg_start = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(e), side="left"))(sorted_eid)
    rank = jnp.arange(tl * k)[None, :] - jnp.take_along_axis(seg_start, sorted_eid, axis=1)
    keep = rank < cap
    dest = jnp.where(keep, sorted_eid * cap + rank, e * cap)
    gidx = jnp.arange(g)[:, None]
    buf_tok = jnp.zeros((g, e * cap + 1), jnp.int32).at[gidx, dest].set((order // k).astype(jnp.int32))
    buf_valid = jnp.zeros((g, e * cap + 1), bool).at[gidx, dest].set(keep)
    buf_w = jnp.zeros((g, e * cap + 1), xt.dtype).at[gidx, dest].set(
        jnp.where(keep, jnp.take_along_axis(w, order, axis=1), 0))
    return dict(g=g, cap=cap, topi=topi, buf_tok=buf_tok[:, :e * cap],
                buf_valid=buf_valid[:, :e * cap], buf_w=buf_w[:, :e * cap], dropped=int((~keep).sum()))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
def test_moe_mlp_routing_output_and_aux(capacity_factor):
    """``moe.dispatch``'s groups, capacity and (E * cap) buffers equal the
    reference's, then ``moe_mlp``'s output and aux loss. 96 tokens make 32
    groups of 3 (capacity 2 of an expert's 6 slots at 1.25, 1 at 0.5), so
    pairs are dropped at both factors (counted by ``count_drops``), and
    the drop rule is held: the later pairs of an expert's sorted run go."""
    cfg, jcfg, np_params, jparams, params = _setup("moe")
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    x = np.random.default_rng(11).standard_normal((4, 24, 128)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["moe"])
    p = params.blocks[0].moe
    want = _reference_dispatch(jp, jnp.asarray(x), jcfg)
    with moe.count_drops() as drops:
        got = moe.dispatch(p.router, torch.from_numpy(x), cfg)
    assert (got["g"], got["cap"]) == (want["g"], want["cap"]) == (32, got["cap"])
    np.testing.assert_array_equal(got["topi"].numpy(), np.asarray(want["topi"]))
    np.testing.assert_array_equal(got["buf_tok"].numpy(), np.asarray(want["buf_tok"]))
    np.testing.assert_array_equal(got["buf_valid"].numpy(), np.asarray(want["buf_valid"]))
    _close(got["buf_w"], want["buf_w"])
    assert sum(int(d) for d in drops) == want["dropped"] > 0
    out, aux = moe.moe_mlp(p, torch.from_numpy(x), cfg)
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), **LOSS_TOL)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
def test_ssd_scan_ragged_length_and_initial_state(with_h0):
    """21 positions at chunks of 16 (the last chunk padded), from a zero or
    a given state: y and the final state against ``_ssd_scan``."""
    cfg, jcfg, _, _, _ = _setup("ssm")
    rng = np.random.default_rng(12)
    b, l, nh, hp, ns = 2, 21, 8, 32, 16
    x = rng.standard_normal((b, l, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, l, nh)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, nh).astype(np.float32)
    bi, ci = (rng.standard_normal((b, l, ns)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, nh, hp, ns)).astype(np.float32) if with_h0 else None
    y, h = mb.ssd_scan(*(torch.from_numpy(v) for v in (x, dt, a, bi, ci)), cfg,
                       h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = jmb._ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, bi, ci)), jcfg,
                           h0=None if h0 is None else jnp.asarray(h0))
    _close(y, jy, atol=2e-5, rtol=2e-5)
    _close(h, jh, atol=2e-5, rtol=2e-5)


def test_mamba2_decode_matches_full_forward():
    """Port twin of tests/test_models.py's: prefill(t tokens) then decode(token
    t) equals the full forward over t + 1, at the reference test's tolerance."""
    cfg, _, np_params, _, params = _setup("ssm")
    tokens = torch.from_numpy(_tokens(13, (2, 12))).long()
    full = cm.lm_logits(params, mb.forward(params, tokens, cfg), cfg)[:, -1]
    _, cache = mb.prefill(params, {"tokens": tokens[:, :-1]}, cfg)
    dec, _ = mb.decode_step(params, cache, tokens[:, -1], 11, cfg)
    _close(dec, full, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("family", ["hybrid", "encdec"])
def test_decode_matches_full_forward(family):
    """prefill(t) + one decode step against the last logits of prefill(t +
    1): zamba2's SSM states and per-site KV caches, encdec's self cache."""
    cfg, _, _, _, params = _setup(family)
    model = build_model(cfg, "cpu")
    batch = _torch_batch(_batch(family, 14, t=12))
    key = "tgt_tokens" if family == "encdec" else "tokens"
    head = dict(batch, **{key: batch[key][:, :-1]})
    if family == "hybrid":
        _, cache = zamba2.prefill(params, head, cfg, cache_len=12)
    else:
        _, cache = model.prefill(params, head)
    dec, _ = model.decode(params, cache, batch[key][:, -1], 11)
    full, _ = model.prefill(params, batch)
    _close(dec, full, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_bf16_prefill_decode_gap_is_the_references(family):
    """prefill(t) + one decode step against the last logits of prefill(t +
    1), in bf16 on the same weights in both packages: the reference's own
    gap is over a thousand times its f32 gap (the chunked scan and the
    recurrence round to bf16 at different points of every Mamba layer), and
    the port's is of the same size, within ``BF16_GAP_RATIO``."""
    arch, t = ARCHS[family], 32
    jmod, mod = (jmb, mb) if family == "ssm" else (jzamba2, zamba2)
    tokens = _tokens(16, (4, t + 1))
    ref = {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jreduce(jget_arch(arch)), param_dtype=dt)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
        prefill = jax.jit(jmod.prefill, static_argnames=("cfg", "cache_len"))
        _, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens[:, :t])}, cfg=jcfg, cache_len=t + 1)
        jdec, _ = jax.jit(jmod.decode_step, static_argnames="cfg")(
            jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t, jnp.int32), cfg=jcfg)
        jfull, _ = prefill(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg)
        jdec, jfull = np.asarray(jdec, np.float32), np.asarray(jfull, np.float32)
        ref[dt] = float(np.linalg.norm(jdec - jfull) / np.linalg.norm(jfull))
    cfg = dataclasses.replace(reduce(get_arch(arch)), param_dtype="bfloat16")
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.array, jparams))  # the bf16 weights
    tt = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        _, cache = mod.prefill(params, {"tokens": tt[:, :t]}, cfg, cache_len=t + 1)
        dec, _ = mod.decode_step(params, cache, tt[:, t], t, cfg)
        full, _ = mod.prefill(params, {"tokens": tt}, cfg)
    dec, full = dec.float(), full.float()
    port = float((dec - full).norm() / full.norm())
    assert ref["bfloat16"] > 1e3 * ref["float32"], ref
    assert 1 / BF16_GAP_RATIO <= port / ref["bfloat16"] <= BF16_GAP_RATIO, (port, ref)


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------
def test_encdec_cross_attention_sq_ne_sk():
    """Cross-attention of 5 target positions over 19 memory frames (no
    RoPE, non-causal, q projected alone) against the JAX package's
    ``attention(kv_override=)``, and its decode-side read of a cross cache."""
    cfg, jcfg, _, jparams, params = _setup("encdec")
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    mem = rng.standard_normal((2, 19, 128)).astype(np.float32)
    p = params.decoder[1].cross
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["decoder"]["cross"])
    kv = encdec.cross_kv(p, torch.from_numpy(mem), cfg)
    jk = ((jnp.asarray(mem) @ jp["wk"]).reshape(2, 19, jcfg.n_kv_heads, jcfg.hd),
          (jnp.asarray(mem) @ jp["wv"]).reshape(2, 19, jcfg.n_kv_heads, jcfg.hd))
    _close(encdec.cross_attention(p, torch.from_numpy(x), kv, cfg),
           jcm.attention(jp, jnp.asarray(x), jcfg, causal=False, kv_override=jk, use_rope=False))
    out, _ = cm.attention_decode(p, torch.from_numpy(x[:, 0]), {"k": kv[0], "v": kv[1]}, cfg, 18,
                                 update_cache=False, use_rope=False)
    jout, _ = jcm.attention_decode(jp, jnp.asarray(x[:, 0]), {"k": jk[0], "v": jk[1]}, jcfg,
                                   jnp.asarray(18), update_cache=False, use_rope=False)
    _close(out, jout)


def test_plain_flash_at_head_dim_80_matches_flash_xla():
    """zamba2's head dim: the plain flash forward and its autograd VJP
    against ``flash_xla`` and its custom VJP, causal, GQA 4/2, 40 x 40."""
    rng = np.random.default_rng(16)
    q = rng.standard_normal((2, 40, 4, 80)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 80)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = flash_attention_torch(tq, tk, tv, causal=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    jout, vjp = jax.vjp(lambda a, b_, c: flash_attention_xla(a, b_, c, True, None),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(out, jout)
    for g, jg in zip(grads, vjp(jnp.asarray(do))):
        _close(g, jg, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_train_main_default_arch_matches_reference(monkeypatch):
    """``train.main(["--smoke", "--device", "cpu", "--steps", "3"])`` trains
    the default arch, mamba2-130m (8 x 128 tokens a step), and its losses
    equal the JAX trainer's from the same initial weights and batches."""
    _, jcfg, _, _, _ = _setup("ssm")
    _inject_reference_init(monkeypatch, jcfg)
    runs = []
    run = train.run
    monkeypatch.setattr(train, "run", lambda *a, **kw: runs.append(run(*a, **kw)) or runs[-1])
    train.main(["--smoke", "--device", "cpu", "--steps", "3"])
    theirs = jtrain.run(jtrain.TrainConfig(arch="mamba2-130m", smoke=True, steps=3))
    assert len(runs[0]["losses"]) == len(theirs["losses"]) == 3
    np.testing.assert_allclose(runs[0]["losses"], theirs["losses"], **RUN_TOL)


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_train_run_matches_reference(family, monkeypatch):
    """``run()`` on the reduced mixtral and zamba2: three losses equal to the
    JAX trainer's from the same initial weights and batches."""
    _, jcfg, _, _, _ = _setup(family)
    _inject_reference_init(monkeypatch, jcfg)
    kw = dict(arch=ARCHS[family], smoke=True, steps=3, seq_len=32, global_batch=2, warmup=1,
              log_every=100)
    mine = train.run(train.TrainConfig(**kw), device="cpu")
    theirs = jtrain.run(jtrain.TrainConfig(**kw))
    np.testing.assert_allclose(mine["losses"], theirs["losses"], **RUN_TOL)


def test_encdec_trainer_exits_as_the_reference():
    with pytest.raises(SystemExit, match="decoder-only"):
        train.run(train.TrainConfig(arch="seamless-m4t-large-v2", steps=1), device="cpu")


@pytest.mark.parametrize("what", ["train", "prefill", "decode"])
def test_profile_lm_runs_on_the_cpu(what):
    """``bench.profile_lm`` drives a reduced zamba2's training step, prefill
    and decode step under the profiler; on the CPU it reports the window's
    wall time and no device time."""
    from repro_torch.bench import profile_lm

    cpu = torch.device("cpu")
    r = profile_lm.profile_window(profile_lm.path_fn(reduce(get_arch("zamba2-2.7b")), what, 2, 16, cpu), cpu)
    assert r["wall_ms"] > 0 and r["busy_ms"] is None and r["idle_share"] is None
