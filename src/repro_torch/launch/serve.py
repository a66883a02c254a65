"""Batched serving driver: prefill + greedy decode with a KV/SSM cache.

Serves a (reduced or full) architecture of any family with a batch of
random prompts (for encdec: random source frame embeddings and target
tokens); reports prefill latency and decode throughput. The port of
``repro/launch/serve.py``; runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
        --device cpu --batch 4 --prompt-len 64 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..configs.base import get_arch, reduce as reduce_cfg
from ..device import sync
from ..models import Model, build_model
from ..models.common import act_dtype


def generate(model: Model, params, prompt: Union[np.ndarray, Mapping[str, np.ndarray]],
             gen: int) -> dict:
    """Greedy generation: prefill ``prompt`` (tokens (b, s), or for encdec
    ``{"src_embeds" (b, s_src, d), "tgt_tokens" (b, t)}``), then ``gen``
    decode steps from position s (t), each feeding back the argmax over the
    padded vocabulary (the first maximum on ties, as ``jnp.argmax``). A
    decoder-only prefill cache has exactly s slots, as the reference
    driver's has, so every decode step writes the last slot (the ring
    buffer's next one under a window).

    Returns ``tokens`` (b, gen + 1) int32, ``prefill_s``, ``decode_s``,
    ``decode_tokens_per_s`` and ``logits_finite`` (every logit of the run
    finite). The tokens stay on the device until the loop ends.
    """
    device = model.device
    if isinstance(prompt, Mapping):
        batch = {"src_embeds": torch.as_tensor(np.asarray(prompt["src_embeds"]), device=device).to(
                     act_dtype(model.cfg)),
                 "tgt_tokens": torch.as_tensor(np.asarray(prompt["tgt_tokens"]), dtype=torch.long,
                                               device=device)}
        b, start_pos = batch["tgt_tokens"].shape
    else:
        batch = {"tokens": torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device)}
        b, start_pos = batch["tokens"].shape
    sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    sync(device)
    prefill_s = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = model.decode(params, cache, tok, start_pos + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    sync(device)
    decode_s = time.perf_counter() - t0
    return {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": b * gen / max(decode_s, 1e-9),
        "tokens": torch.stack(out, dim=1).cpu().numpy().astype(np.int32),
        "logits_finite": bool(finite),
    }


def run(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int, seed: int = 0,
        device: Optional[str] = None) -> dict:
    """Random weights from ``seed`` and a prompt drawn as the reference
    driver draws it from ``default_rng(seed)``: (batch, prompt_len) tokens,
    or for encdec (batch, prompt_len, d) standard-normal source frames and
    then (batch, max(4, gen // 2)) target tokens. Then :func:`generate`.
    ``device=None`` is the GPU."""
    cfg = reduce_cfg(get_arch(arch)) if smoke else get_arch(arch)
    model = build_model(cfg, device)
    rng = np.random.default_rng(seed)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    if cfg.family == "encdec":
        prompt = {"src_embeds": rng.standard_normal((batch, prompt_len, cfg.d_model)),
                  "tgt_tokens": rng.integers(0, cfg.vocab, (batch, max(4, gen // 2)))}
    else:
        prompt = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return generate(model, params, prompt, gen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action="store_true", help="the reduced config (2 layers, 4 for hybrid; f32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64, help="source frames for encdec")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    out = run(args.arch, args.smoke, args.batch, args.prompt_len, args.gen, args.seed,
              args.device)
    print(
        f"[serve] {args.arch} prefill={out['prefill_s']*1e3:.0f}ms "
        f"decode={out['decode_tokens_per_s']:.1f} tok/s "
        f"(batch={args.batch}, gen={args.gen})"
    )


if __name__ == "__main__":
    main()
