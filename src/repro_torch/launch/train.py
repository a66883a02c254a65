"""The training entry point: the synthetic token pipeline, AdamW, checkpoints with
auto-resume, preemption handling, straggler monitoring and optional
gradient compression. The port of ``repro/launch/train.py``; runs on the
GPU unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --device cpu --steps 20 --ckpt-dir /tmp/ckpt

Trains the decoder-only families (dense, moe, ssm, hybrid; the default
``--arch`` is mamba2-130m, as the reference's); encdec exits, as the
reference's trainer does. Each step: the model's loss and its gradients
(the flash attention forward and backward kernels on the card, where the
model has attention), gradient compression, then
``adamw.apply_updates`` at ``lr_schedule(step)``. One device only: a mesh
of more than one raises (the multi-card layout waits for ROADMAP Queue 1
item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import get_arch, reduce as reduce_cfg
from ..data.pipeline import DataConfig, TokenPipeline
from ..device import resolve_device
from ..distributed.sharding import ShardingRules, use_rules
from ..ft.monitor import PreemptionHandler, StragglerMonitor
from ..models import build_model
from ..optim import adamw
from ..optim.compression import CompressionConfig, compress_grads


@dataclasses.dataclass
class TrainConfig:
    arch: str
    smoke: bool = True
    steps: int = 200
    seq_len: int = 128
    global_batch: int = 8
    microbatch: Optional[int] = None  # gradient accumulation
    lr: float = 3e-4
    warmup: int = 20
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    async_ckpt: bool = True
    seed: int = 0
    remat: str = "dots"
    compression: str = "none"  # none | bf16 | int8_ef
    log_every: int = 10


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup to 1, then a cosine to 0.1, in f32 (0 at step 0)."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.steps - cfg.warmup, 1), 0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (0.1 + 0.9 * cosine)


def make_train_step(model, tcfg: TrainConfig, opt_cfg: adamw.AdamWConfig,
                    comp: CompressionConfig):
    """``train_step(params, opt_state, batch, ef_state) -> (loss, params,
    opt_state, ef_state)``; the parameters and moments are updated in place.
    With ``microbatch`` the gradients of each microbatch are summed in f32
    buffers and scaled by 1 / nmicro, as the JAX package's scan does."""
    nmicro = 1
    if tcfg.microbatch:
        if tcfg.global_batch % tcfg.microbatch:
            raise ValueError(f"global_batch {tcfg.global_batch} is not a multiple of "
                             f"microbatch {tcfg.microbatch}")
        nmicro = tcfg.global_batch // tcfg.microbatch

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())
        if nmicro == 1:
            loss = model.loss(params, batch)
            return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
        tokens = batch["tokens"].reshape(nmicro, tcfg.microbatch, -1)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in zip(names, leaves)}
        for mb in tokens:
            loss = model.loss(params, {"tokens": mb})
            for n, g in zip(names, torch.autograd.grad(loss, leaves)):
                g_acc[n].add_(g)
            loss_acc = loss_acc + loss.detach()
        scale = 1.0 / nmicro
        return loss_acc * scale, {n: g * scale for n, g in g_acc.items()}

    def train_step(params, opt_state, batch, ef_state):
        loss, grads = grads_of(params, batch)
        grads, ef_state = compress_grads(grads, ef_state, comp)
        opt_state = adamw.apply_updates(params, grads, opt_state, opt_cfg,
                                        lr_scale=lr_schedule(tcfg, opt_state.step))
        return loss, params, opt_state, ef_state

    return train_step


def run(tcfg: TrainConfig, mesh=None, device=None) -> dict:
    """Train ``tcfg.arch`` from random weights (seed ``tcfg.seed``), resuming
    from the newest checkpoint in ``ckpt_dir`` when there is one. Returns
    the losses of the steps run, the final loss, the monitor's median step
    seconds and every step's seconds."""
    device = resolve_device(device)
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices: the port trains on one device (the multi-card "
            "layout is ROADMAP Queue 1 item 10)")
    arch = get_arch(tcfg.arch)
    cfg = reduce_cfg(arch) if tcfg.smoke else arch
    if cfg.family == "encdec":
        raise SystemExit("use a decoder-only arch for the token-LM trainer")
    model = build_model(cfg, device, remat=tcfg.remat)
    rules = ShardingRules(mesh)
    opt_cfg = adamw.AdamWConfig(lr=tcfg.lr)
    comp = CompressionConfig(kind=tcfg.compression)

    pipeline = TokenPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
                   seed=tcfg.seed)
    )
    ckpt = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None

    with use_rules(rules):
        params = model.init(torch.Generator(device=device).manual_seed(tcfg.seed))
        params.requires_grad_(True)
        opt_state = adamw.init_state(params)
        ef_state = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.named_parameters()}
                    if comp.kind == "int8_ef" else None)
        start_step = 0
        if ckpt is not None and ckpt.latest_step() is not None:
            restored, _ = ckpt.restore({"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start_step = ckpt.latest_step()
            print(f"[train] resumed from step {start_step}")

        train_step = make_train_step(model, tcfg, opt_cfg, comp)
        monitor = StragglerMonitor()
        losses = []
        with PreemptionHandler() as pre:
            for step in range(start_step, tcfg.steps):
                t0 = time.perf_counter()
                batch = {"tokens": torch.from_numpy(pipeline.batch_at(step)).to(device)}
                loss, params, opt_state, ef_state = train_step(params, opt_state, batch, ef_state)
                loss = float(loss)  # waits for the step's device work
                losses.append(loss)
                stat = monitor.record(step, time.perf_counter() - t0)
                if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                    print(
                        f"[train] step={step} loss={loss:.4f} "
                        f"dt={stat.seconds*1e3:.0f}ms"
                        + (" STRAGGLER" if stat.flagged else ""),
                        flush=True,
                    )
                if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state},
                              extra={"loss": loss}, blocking=not tcfg.async_ckpt)
                if pre.preempted:
                    print("[train] preemption requested -> final checkpoint")
                    break
        if ckpt is not None and losses:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      extra={"loss": losses[-1]}, blocking=True)
            ckpt.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else float("nan"),
            "median_step_s": monitor.median_step(),
            "step_s": [s.seconds for s in monitor.history]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true", help="the reduced config (2 layers, 4 for hybrid; f32)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    tcfg = TrainConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatch=args.microbatch, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        compression=args.compression, remat=args.remat,
    )
    out = run(tcfg, device=args.device)
    print(f"[train] done: first={out['losses'][0]:.4f} final={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
