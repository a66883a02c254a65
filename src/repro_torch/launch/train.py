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
``adamw.apply_updates`` at ``lr_schedule(step)``.

On a ``("data", "model")`` mesh over a process group (``run(tcfg,
mesh=launch.mesh.make_train_mesh(D, M))`` on every rank, or ``--mesh D,M``,
which spawns the D * M ranks) the dense family trains with FSDP over data
and tensor parallelism over model: the parameters, gradients and moments
are each rank's blocks under ``params_sharding``, each data rank reads its
rows of the global batch, and checkpoints hold the full arrays, so a run
resumes on another mesh. The other families on a mesh wait for ROADMAP
Queue 1 (the MoE's expert axis, the SSM's ``ssm_inner`` axis).

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \
        --device cpu --steps 5 --mesh 2,2 --backend gloo
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs.base import get_arch, reduce as reduce_cfg
from ..data.pipeline import DataConfig, TokenPipeline
from ..device import resolve_device
from ..distributed.collectives import DP_AXES, comm_for
from ..distributed.sharding import (ShardingRules, params_sharding, shard_params, spawn_ranks,
                                    use_rules)
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
                    comp: CompressionConfig, dp: int = 1):
    """``train_step(params, opt_state, batch, ef_state) -> (loss, params,
    opt_state, ef_state)``; the parameters and moments are updated in place.
    With ``microbatch`` the gradients of each microbatch are summed in f32
    buffers and scaled by 1 / nmicro, as the JAX package's scan does. On a
    mesh of ``dp`` data-parallel ranks a batch is the rank's rows, and each
    microbatch ``microbatch / dp`` of them: every microbatch holds as many
    tokens, so the mean of their losses is still the global token mean."""
    nmicro = micro_rows = 1
    if tcfg.microbatch:
        if tcfg.global_batch % tcfg.microbatch or tcfg.microbatch % dp:
            raise ValueError(f"global_batch {tcfg.global_batch} is not a multiple of microbatch "
                             f"{tcfg.microbatch}, or microbatch not a multiple of the {dp} "
                             "data-parallel ranks")
        nmicro, micro_rows = tcfg.global_batch // tcfg.microbatch, tcfg.microbatch // dp

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())
        if nmicro == 1:
            loss = model.loss(params, batch)
            return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
        tokens = batch["tokens"].reshape(nmicro, micro_rows, -1)
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
        grads, ef_state = compress_grads(grads, ef_state, comp, adamw.shard_axes(params))
        opt_state = adamw.apply_updates(params, grads, opt_state, opt_cfg,
                                        lr_scale=lr_schedule(tcfg, opt_state.step))
        return loss, params, opt_state, ef_state

    return train_step


def _rank_layout(mesh, cfg):
    """(comm, data-parallel size, this rank's data-parallel index) of a
    training mesh; refuses a mesh without a process group, and a family
    the port does not shard yet."""
    comm = comm_for(mesh)  # ValueError: several devices and no process group
    if comm.backend != "group":
        raise ValueError(f"a mesh of {mesh.size} {mesh.devices[0].type} devices trains over a "
                         "process group (launch.mesh.make_train_mesh)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh waits for ROADMAP Queue 1 (the MoE's "
            "expert axis, the SSM and hybrid ssm_inner axis); the dense family trains on one")
    dp = comm.axes(DP_AXES)
    return comm, comm.size(dp), comm.index(dp)


def run(tcfg: TrainConfig, mesh=None, device=None) -> dict:
    """Train ``tcfg.arch`` from random weights (seed ``tcfg.seed``), resuming
    from the newest checkpoint in ``ckpt_dir`` when there is one. Returns
    the losses of the steps run, the final loss, the monitor's median step
    seconds and every step's seconds; on a mesh of several devices also
    ``collectives``, each step's per-kind bytes, calls and seconds
    inside its collectives on this rank.

    ``mesh`` of several devices: every rank of its process group calls
    ``run`` with it (:func:`~repro_torch.launch.mesh.make_train_mesh`);
    the device is the rank's. A mesh without a process group raises
    ``ValueError``."""
    arch = get_arch(tcfg.arch)
    cfg = reduce_cfg(arch) if tcfg.smoke else arch
    if cfg.family == "encdec":
        raise SystemExit("use a decoder-only arch for the token-LM trainer")
    sharded = mesh is not None and mesh.size > 1
    comm, dp, dp_index = _rank_layout(mesh, cfg) if sharded else (None, 1, 0)
    device = mesh.device if sharded else resolve_device(device)
    if tcfg.global_batch % dp:
        raise ValueError(f"global_batch {tcfg.global_batch} over {dp} data-parallel ranks")
    model = build_model(cfg, device, remat=tcfg.remat)
    rules = ShardingRules(mesh)
    opt_cfg = adamw.AdamWConfig(lr=tcfg.lr)
    comp = CompressionConfig(kind=tcfg.compression)

    pipeline = TokenPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
                   seed=tcfg.seed), shard=dp_index, num_shards=dp)
    ckpt = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    talk = not sharded or comm.rank == 0  # one rank logs the steps

    with use_rules(rules):
        params = model.init(torch.Generator(device=device).manual_seed(tcfg.seed))
        shardings = None
        if sharded:
            p_shard = params_sharding(params, rules)
            shard_params(params, p_shard)
            shardings = {"params": p_shard, "opt": adamw.AdamWState(step=None, m=p_shard, v=p_shard)}
        params.requires_grad_(True)
        opt_state = adamw.init_state(params)
        ef_state = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.named_parameters()}
                    if comp.kind == "int8_ef" else None)
        start_step = 0
        if ckpt is not None and ckpt.latest_step() is not None:
            # elastic auto-resume: the blocks placed under the CURRENT mesh
            restored, _ = ckpt.restore({"params": params, "opt": opt_state}, shardings=shardings)
            params, opt_state = restored["params"], restored["opt"]
            start_step = ckpt.latest_step()
            if talk:
                print(f"[train] resumed from step {start_step}")

        train_step = make_train_step(model, tcfg, opt_cfg, comp, dp=dp)
        monitor = StragglerMonitor()
        losses, coll = [], []
        with PreemptionHandler() as pre:
            for step in range(start_step, tcfg.steps):
                t0 = time.perf_counter()
                batch = {"tokens": torch.from_numpy(pipeline.batch_at(step)).to(device)}
                if sharded:
                    comm.stats.reset()
                loss, params, opt_state, ef_state = train_step(params, opt_state, batch, ef_state)
                loss = float(loss)  # waits for the step's device work
                if sharded:
                    coll.append(comm.stats.snapshot())
                losses.append(loss)
                stat = monitor.record(step, time.perf_counter() - t0)
                if talk and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
                    print(
                        f"[train] step={step} loss={loss:.4f} "
                        f"dt={stat.seconds*1e3:.0f}ms"
                        + (" STRAGGLER" if stat.flagged else ""),
                        flush=True,
                    )
                if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state},
                              extra={"loss": loss}, blocking=not tcfg.async_ckpt,
                              shardings=shardings)
                preempted = pre.preempted
                if sharded:  # every rank stops after the same step
                    flag = torch.tensor([float(preempted)], device=mesh.staging)
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                    preempted = bool(flag.item())
                if preempted:
                    if talk:
                        print("[train] preemption requested -> final checkpoint")
                    break
        if ckpt is not None and losses:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      extra={"loss": losses[-1]}, blocking=True, shardings=shardings)
            ckpt.wait()
    out = {"losses": losses, "final_loss": losses[-1] if losses else float("nan"),
           "median_step_s": monitor.median_step(),
           "step_s": [s.seconds for s in monitor.history]}
    if sharded:
        out["collectives"] = coll
    return out


def _train_rank(rank: int, tcfg: TrainConfig, data: int, model: int, device) -> int:
    """One spawned rank of ``--mesh``: the mesh over the group, then
    :func:`run`; rank 0 prints the result."""
    from .mesh import make_train_mesh

    out = run(tcfg, mesh=make_train_mesh(data, model, device=device))
    if rank == 0:
        print(f"[train] done on {data} x {model}: first={out['losses'][0]:.4f} "
              f"final={out['final_loss']:.4f}", flush=True)
    return 0


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
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train on a data x model mesh of D * M spawned ranks")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the process group's backend under --mesh (nccl: one GPU a rank)")
    args = ap.parse_args(argv)
    tcfg = TrainConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatch=args.microbatch, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        compression=args.compression, remat=args.remat,
    )
    if args.mesh:
        data, model = (int(n) for n in args.mesh.split(","))
        spawn_ranks(_train_rank, data * model, backend=args.backend, device=args.device,
                    args=(tcfg, data, model, args.device))
        return
    out = run(tcfg, device=args.device)
    print(f"[train] done: first={out['losses'][0]:.4f} final={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
