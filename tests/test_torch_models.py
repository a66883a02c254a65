"""The port's LM serving path (``repro_torch.configs``, ``models``,
``launch.serve``) against the JAX package on the reduced glm4-9b in f32.

Weights cannot be drawn alike (``jax.random`` vs ``torch.Generator``), so
the JAX package's initialised parameters are carried across with
``params_from_numpy``; the QKV biases and norm scales are replaced by random
values first, so that their paths are compared too. The JAX side runs its
default CPU path (``impl="xla"``, the blocked ``flash_xla``); the port's CPU
tensors take the plain flash version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduce as jreduce
from repro.models import build_model as jbuild_model, common as jcm, transformer as jtr
from repro_torch.configs import get_arch, list_archs, reduce
from repro_torch.launch.serve import generate, run
from repro_torch.models import build_model, common as cm, params_from_numpy, transformer as tr

DENSE = ("chameleon-34b", "deepseek-67b", "glm4-9b", "internlm2-20b", "qwen2.5-32b")
# f32 on both sides; the sums run in other orders (XLA vs PyTorch CPU kernels,
# blocked vs plain attention), a few ulps per layer at unit-scale activations
TOL = dict(atol=2e-5, rtol=2e-5)


@functools.lru_cache(maxsize=None)
def _setup():
    """(port cfg, JAX cfg, numpy params, JAX params, port params)."""
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
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return cfg, jcfg, np_params, jparams, params_from_numpy(cfg, np_params)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE)
def test_config_matches_reference(name):
    assert name in list_archs()
    for port, want in ((get_arch(name), jget_arch(name)), (reduce(get_arch(name)), jreduce(jget_arch(name)))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(want, f.name), f.name
        assert (port.hd, port.vocab_padded) == (want.hd, want.vocab_padded)


def test_list_archs_names_only_the_port():
    assert list_archs() == DENSE


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------
def test_rms_norm_and_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    _close(cm.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jcm.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    h = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(2040, 2047)]).astype(np.int32)
    _close(cm.rope(torch.from_numpy(h), torch.from_numpy(pos), 1e4),
           jcm.rope(jnp.asarray(h), jnp.asarray(pos), 1e4))


def _layer0(jparams, name):
    return jax.tree_util.tree_map(lambda a: a[0], jparams["layers"][name])


@pytest.mark.parametrize("cache_len", [12, 16])
def test_attention_prefill(cache_len):
    cfg, jcfg, _, jparams, params = _setup()
    x = np.random.default_rng(2).standard_normal((2, 12, 128)).astype(np.float32)
    out, cache = cm.attention_prefill(params.blocks[0].attn, torch.from_numpy(x), cfg, cache_len)
    jout, jcache = jcm.attention_prefill(_layer0(jparams, "attn"), jnp.asarray(x), jcfg, cache_len)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("cache_len,pos", [(16, 12), (12, 12)], ids=["free-slot", "last-slot"])
def test_attention_decode(cache_len, pos):
    """A free slot at ``pos``, and the full cache whose last slot the step
    overwrites (the reference serve loop's case)."""
    cfg, jcfg, _, jparams, params = _setup()
    rng = np.random.default_rng(3)
    x, xd = rng.standard_normal((2, 12, 128)).astype(np.float32), rng.standard_normal((2, 128)).astype(np.float32)
    p, jp = params.blocks[0].attn, _layer0(jparams, "attn")
    _, cache = cm.attention_prefill(p, torch.from_numpy(x), cfg, cache_len)
    _, jcache = jcm.attention_prefill(jp, jnp.asarray(x), jcfg, cache_len)
    out, cache = cm.attention_decode(p, torch.from_numpy(xd), cache, cfg, pos)
    jout, jcache = jcm.attention_decode(jp, jnp.asarray(xd), jcache, jcfg, jnp.asarray(pos, jnp.int32))
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_windowed_attention_prefill_and_decode():
    """A sliding-window variant (window 8 < 12 tokens): prefill keeps the
    last 8 keys, decode writes the ring-buffer slot ``pos % 8``."""
    cfg, jcfg, _, jparams, params = _setup()
    cfg, jcfg = dataclasses.replace(cfg, window=8), dataclasses.replace(jcfg, window=8)
    assert tr.cache_len_for(cfg, 12) == jtr.cache_len_for(jcfg, 12) == 8
    rng = np.random.default_rng(9)
    x, xd = rng.standard_normal((2, 12, 128)).astype(np.float32), rng.standard_normal((2, 128)).astype(np.float32)
    p, jp = params.blocks[1].attn, jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["attn"])
    out, cache = cm.attention_prefill(p, torch.from_numpy(x), cfg, 8)
    jout, jcache = jcm.attention_prefill(jp, jnp.asarray(x), jcfg, 8)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    for pos in (12, 13):
        out, cache = cm.attention_decode(p, torch.from_numpy(xd), cache, cfg, pos)
        jout, jcache = jcm.attention_decode(jp, jnp.asarray(xd), jcache, jcfg, jnp.asarray(pos, jnp.int32))
        _close(out, jout)
        _close(cache["v"], jcache["v"])


def test_init_cache():
    cfg, jcfg, _, _, _ = _setup()
    cache = build_model(cfg, "cpu").init_cache(3, 20)
    want = jtr.init_cache(jcfg, 3, 20)
    assert cache["k"].shape == want["k"].shape and cache["k"].dtype == torch.float32
    assert not bool(cache["v"].any())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_forward():
    cfg, jcfg, _, jparams, params = _setup()
    tokens = _tokens(4, (2, 12))
    _close(tr.forward(params, torch.from_numpy(tokens).long(), cfg),
           jtr.forward(jparams, jnp.asarray(tokens), jcfg))


def test_prefill_and_decode_step():
    cfg, jcfg, _, jparams, params = _setup()
    tokens = _tokens(5, (2, 12))
    logits, cache = tr.prefill(params, {"tokens": torch.from_numpy(tokens).long()}, cfg, cache_len=16)
    jlogits, jcache = jtr.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, cache_len=16)
    assert logits.shape == (2, cfg.vocab_padded) and cache["k"].shape == (2, 2, 16, 2, 32)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    nxt = _tokens(6, (2,))
    logits, cache = tr.decode_step(params, cache, torch.from_numpy(nxt).long(), 12, cfg)
    jlogits, jcache = jtr.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(12, jnp.int32), jcfg)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_dense_decode_matches_full_forward():
    """Port twin of tests/test_models.py's: prefill(t tokens) then decode(token
    t) equals the full forward over t + 1, at the reference test's tolerance."""
    cfg, _, np_params, _, _ = _setup()
    params = params_from_numpy(cfg, jax.tree_util.tree_map(
        np.array, jtr.init_params(jax.random.PRNGKey(2), jreduce(jget_arch("glm4-9b")))))
    tokens = torch.from_numpy(_tokens(7, (2, 12))).long()
    full = cm.lm_logits(params, tr.forward(params, tokens, cfg), cfg)[:, -1]
    _, cache = tr.prefill(params, {"tokens": tokens[:, :-1]}, cfg, cache_len=12)
    dec, _ = tr.decode_step(params, cache, tokens[:, -1], 11, cfg)
    _close(dec, full, atol=2e-3, rtol=2e-3)


def test_generate_matches_reference_greedy_loop():
    """Token for token the ids of the reference driver's loop
    (repro/launch/serve.py), written out here with the JAX model's jitted
    prefill and decode: batch 2, prompt 16, 4 generated tokens."""
    cfg, jcfg, _, jparams, params = _setup()
    prompt = _tokens(8, (2, 16), cfg.vocab)
    jmodel = jbuild_model(jcfg)
    logits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(prompt)})
    decode_fn = jax.jit(jmodel.decode)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(4):
        logits, jcache = decode_fn(jparams, jcache, tok, jnp.asarray(16 + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    out = generate(build_model(cfg, "cpu"), params, prompt, 4)
    np.testing.assert_array_equal(out["tokens"], np.stack(want, axis=1))
    assert out["logits_finite"]


def test_serve_driver_generates_tokens():
    """Port twin of tests/test_integration.py's, on the CPU."""
    out = run("glm4-9b", smoke=True, batch=2, prompt_len=16, gen=4, device="cpu")
    assert out["tokens"].shape == (2, 5)
    assert out["decode_tokens_per_s"] > 0
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all() and out["logits_finite"]


def test_init_params_distributions():
    """The JAX package's init distributions, drawn from an explicit
    generator: the same seed gives the same weights."""
    cfg = dataclasses.replace(reduce(get_arch("glm4-9b")), d_model=256, d_ff=512)
    model = build_model(cfg, "cpu")
    p = model.init(torch.Generator().manual_seed(0))
    blk = p.blocks[1]
    assert abs(float(p.embed.std()) - 0.02) < 1e-3
    assert abs(float(p.head.std()) - 256**-0.5) < 2e-3
    assert abs(float(blk.mlp.w_down.std()) - 512**-0.5) < 2e-3
    assert abs(float(blk.attn.wq.std()) - 256**-0.5) < 3e-3
    assert float(blk.attn.bq.abs().max()) == 0.0 and bool((blk.mlp_norm.scale == 1).all())
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


def test_build_model_families():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(dataclasses.replace(get_arch("glm4-9b"), family="moe"), "cpu")
    cfg, _, np_params, _, _ = _setup()
    bad = dict(np_params, embed=np_params["embed"][:, :64])
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy(cfg, bad)
