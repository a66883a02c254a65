"""Where an LM path's time goes: one ``torch.profiler`` window over a
training step, a prefill or a decode step of an architecture at its
published width (random weights from seed 0, bf16), after one warm-up
call. Prints the call's wall time, the device's busy time and idle share,
and the kernels with the most device time. On the GPU unless given
``--device cpu`` (then only the wall time: the CPU has no device time).

    PYTHONPATH=src python -m repro_torch.bench.profile_lm --arch zamba2-2.7b \\
        --what train --batch 2 --seq-len 2048
    PYTHONPATH=src python -m repro_torch.bench.profile_lm --arch mixtral-8x7b \\
        --layers 16 --what decode --batch 2 --seq-len 8192

The profiler's own bookkeeping slows the host, so the idle share is taken
against the wall time of the same call run alone just before the window.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig, get_arch
from ..data.pipeline import DataConfig, TokenPipeline
from ..device import sync
from ..launch import train
from ..models import build_model
from ..optim import AdamWConfig, CompressionConfig, init_state


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


#: kernels listed, by device time
TOP = 12


def profile_window(fn: Callable[[], object], device: torch.device) -> dict:
    """``fn`` once to warm up, once timed alone, then once under
    ``torch.profiler``: the unprofiled call's wall ms, the profiled window's
    (the profiler's bookkeeping slows the host), device busy ms and the idle
    share against the unprofiled wall (None on the CPU), and the ``TOP``
    kernels by device time as (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    window_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(r[1] for r in rows) if device.type == "cuda" else None
    return dict(wall_ms=wall_ms, window_ms=window_ms, busy_ms=busy_ms,
                idle_share=None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
                top=sorted(rows, key=lambda r: -r[1])[:TOP])


def path_fn(cfg: ArchConfig, what: str, batch: int, seq_len: int, device=None) -> Callable[[], object]:
    """The call to profile: one ``make_train_step`` step on a batch of the
    token pipeline, one prefill of (batch, seq_len) random tokens, or one
    decode step after that prefill (its cache written in place each call)."""
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    if what == "train":
        tcfg = train.TrainConfig(arch=cfg.name, seq_len=seq_len, global_batch=batch)
        params.requires_grad_(True)
        state = init_state(params)
        step = train.make_train_step(model, tcfg, AdamWConfig(lr=tcfg.lr), CompressionConfig())
        tokens = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch)).batch_at(0)
        data = {"tokens": torch.from_numpy(tokens).to(model.device)}
        return lambda: step(params, state, data, None)
    if cfg.family == "encdec":
        raise SystemExit("profile_lm: prefill and decode of the decoder-only families")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (batch, seq_len)),
                             device=model.device)
    if what == "prefill":
        return lambda: model.prefill(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens})
    return lambda: model.decode(params, cache, tokens[:, -1], seq_len)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--what", choices=("train", "prefill", "decode"), required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = torch.device("cuda" if args.device is None else args.device)
    r = profile_window(path_fn(cfg, args.what, args.batch, args.seq_len, device), device)
    label = f"{args.what} {args.arch}" + (f" (depth {args.layers})" if args.layers else "") + \
        f" {args.batch} x {args.seq_len}"
    if r["busy_ms"] is None:
        print(f"[profile_lm] {label}: {r['wall_ms']:.1f} ms on the CPU; device time not measured")
        return r
    print(f"[profile_lm] {label} on {torch.cuda.get_device_name(device)}: {r['wall_ms']:.1f} ms "
          f"(profiled window {r['window_ms']:.1f} ms), device busy {r['busy_ms']:.1f} ms, idle share "
          f"{r['idle_share']:.3f}")
    for name, ms, count in r["top"]:
        print(f"  {ms:10.2f} ms  x{count:6d}  {name[:120]}")
    return r


if __name__ == "__main__":
    main()
