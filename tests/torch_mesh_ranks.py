"""What the ranks of ``tests/test_torch_mesh_train.py`` run.

A spawned rank imports its function by name, so it lives in a module of its
own that imports no JAX: a rank starts with torch and the port only. The
one rank function, :func:`mesh_ranks`, runs every case of the test file in
one process group of four ``gloo`` ranks on the CPU and pickles what each
rank saw to ``work/rank{r}.pkl``; the test process asserts on those files
(and reads the checkpoints that rank 0 wrote).
"""
import contextlib
import functools
import os
import pickle
import signal
from pathlib import Path

import numpy as np

WORLD = 4
#: the reduced glm4-9b (2 layers, d 128, 4 / 2 heads, head dim 32, d_ff 256,
#: vocab 512, f32), trained for 3 steps at a learning rate that moves the
#: weights (warmup 1: the updates of steps 1 and 2 are at the full rate)
TRAIN = dict(arch="glm4-9b", smoke=True, steps=3, seq_len=32, global_batch=4, lr=1e-3, warmup=1,
             log_every=100, async_ckpt=False, ckpt_every=1000)
#: the reference's runs on an Auto 2 x 2 mesh: name -> TrainConfig overrides
REFERENCE_RUNS = {"base": {}, "micro": {"microbatch": 2}, "int8": {"compression": "int8_ef"},
                  "whole4": {"steps": 4}}
#: the port's runs: name -> ((data, model), seq_parallel, overrides, the reference run)
RUNS = {
    "2x2": ((2, 2), True, {}, "base"),
    "2x2-nosp": ((2, 2), False, {}, "base"),
    "1x4": ((1, 4), True, {}, "base"),
    "1x4-nosp": ((1, 4), False, {}, "base"),
    "2x2-micro": ((2, 2), True, {"microbatch": 2}, "micro"),
    "2x2-int8": ((2, 2), True, {"compression": "int8_ef"}, "int8"),
}
#: one loss and its gradients on a mesh: ((data, model), seq_parallel, remat)
GRAD_CASES = (((2, 2), True, "dots"), ((2, 2), False, "nothing"), ((1, 4), True, "everything"),
              ((1, 4), False, "dots_no_batch"), ((4, 1), True, "none"))
GRAD_TOKENS = (4, 33)  # rows x (seq + 1) of the gradient cases' batch
#: the collectives' cases: the axes of the 2 x 2 mesh and the dims
COLL_AXES = (("data",), ("model",), ("data", "model"))
COLL_OPS = ("all_gather", "reduce_scatter", "all_reduce", "copy_to")
COLL_SHAPE = (4, 8)
#: the elastic resume: 4 steps, preempted after step 1 (a checkpoint at 2)
ELASTIC_STEPS, PREEMPT_AFTER = 4, 1


def cfg():
    from repro_torch.configs import get_arch, reduce

    return reduce(get_arch("glm4-9b"))


def coll_inputs(rank, axes, op, dim):
    """The f64 input and upstream gradient of one collective case on one
    rank (the test rebuilds every rank's)."""
    rng = np.random.default_rng([rank, COLL_AXES.index(axes), COLL_OPS.index(op), dim])
    x = rng.normal(size=COLL_SHAPE)
    n = 4 if axes == ("data", "model") else 2
    out_shape = list(COLL_SHAPE)
    if op == "all_gather":
        out_shape[dim] *= n
    elif op == "reduce_scatter":
        out_shape[dim] //= n
    return x, rng.normal(size=out_shape)


NORM_LEAVES = {"a": ((4, 8), ("data", "model")), "b": ((5,), (None,)), "c": ((8, 4), ("model", None))}


def norm_leaves():
    """Full f32 arrays of the clipping case, and their specs."""
    rng = np.random.default_rng(7)
    return {n: (rng.normal(size=shape).astype(np.float32), spec)
            for n, (shape, spec) in NORM_LEAVES.items()}


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def reference_init(np_params):
    """``Model.init`` returns the JAX package's initial weights (full; the
    trainer cuts each rank's blocks)."""
    from repro_torch.models import Model, params_from_numpy

    with patched(Model, "init", lambda self, generator: params_from_numpy(self.cfg, np_params)):
        yield


@contextlib.contextmanager
def seq_parallel(on):
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import train

    with patched(train, "ShardingRules", functools.partial(ShardingRules, seq_parallel=on)):
        yield


@contextlib.contextmanager
def preempt_after(step):
    """SIGTERM to this process when the trainer records ``step``."""
    from repro_torch.launch import train

    record = train.StragglerMonitor.record

    def recording(self, s, seconds):
        if s == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return record(self, s, seconds)

    with patched(train.StragglerMonitor, "record", recording):
        yield


def _collectives(rank, mesh):
    import torch

    from repro_torch.distributed import collectives as col

    comm = col.comm_for(mesh)
    out = {}
    for axes in COLL_AXES:
        for op in COLL_OPS:
            for dim in (0, 1):
                x_np, g_np = coll_inputs(rank, axes, op, dim)
                x = torch.tensor(x_np, requires_grad=True)
                fn = getattr(col, op)
                y = fn(x, axes, dim, comm) if op in ("all_gather", "reduce_scatter") else fn(x, axes, comm)
                (dx,) = torch.autograd.grad(y, x, torch.tensor(g_np))
                out[(axes, op, dim)] = (y.detach().numpy(), dx.numpy())
        x_np, _ = coll_inputs(rank, axes, "all_reduce", 0)
        out[(axes, "max")] = col.all_reduce_max(torch.tensor(x_np), axes, comm).numpy()
    return out


def _norm(mesh):
    import torch

    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import ShardingRules, local_block, spec_axes, use_rules
    from repro_torch.optim import adamw

    comm = col.comm_for(mesh)
    grads, axes = {}, {}
    for n, (full, spec) in norm_leaves().items():
        grads[n] = local_block(torch.from_numpy(full), spec, comm).clone()
        axes[n] = spec_axes(spec)
    with use_rules(ShardingRules(mesh)):
        return float(adamw.global_norm(grads, axes)), float(adamw.global_norm(grads))


def _grads(mesh, sp, remat, np_params, tokens):
    """The loss and every gradient (gathered whole) of one step on the mesh,
    the weights carried across by ``params_from_numpy(shardings=)``."""
    import torch

    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import (ShardingRules, gather_params, params_sharding,
                                                  use_rules)
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.models.api import meta_params

    c = cfg()
    rules = ShardingRules(mesh, seq_parallel=sp)
    comm = col.comm_for(mesh)
    dp = comm.axes(col.DP_AXES)
    rows = tokens.shape[0] // comm.size(dp)
    mine = torch.from_numpy(tokens[comm.index(dp) * rows:(comm.index(dp) + 1) * rows])
    shardings = params_sharding(meta_params(c), rules)
    with use_rules(rules):
        params = params_from_numpy(c, np_params, shardings=shardings).requires_grad_(True)
        names, leaves = zip(*params.named_parameters())
        comm.stats.reset()
        loss = build_model(c, "cpu", remat=remat).loss(params, {"tokens": mine})
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        stats = comm.stats.snapshot()
        full = gather_params(grads, shardings)
        shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    return dict(loss=float(loss), grads={n: g.numpy() for n, g in full.items()}, stats=stats,
                local_shapes=shapes)


def _train(mesh, sp, overrides, ckpt_dir, np_params):
    from repro_torch.launch import train

    with reference_init(np_params), seq_parallel(sp):
        out = train.run(train.TrainConfig(**dict(TRAIN, **overrides), ckpt_dir=ckpt_dir), mesh=mesh)
    return dict(losses=out["losses"], collectives=out["collectives"])


def mesh_ranks(rank, work):
    """Every case of the test file on this rank of the four (see the module
    text); returns 0."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_train_mesh

    work = Path(work)
    inputs = pickle.loads((work / "inputs.pkl").read_bytes())
    np_params = inputs["params"]
    meshes = {dm: make_train_mesh(*dm, device="cpu") for dm in ((2, 2), (1, 4), (4, 1))}
    out = {"rank": rank, "coords": {dm: m.rank for dm, m in meshes.items()}}
    out["collectives"] = _collectives(rank, meshes[(2, 2)])
    out["norm"] = _norm(meshes[(2, 2)])
    out["grads"] = {}
    for dm, sp, remat in GRAD_CASES:
        g = _grads(meshes[dm], sp, remat, np_params, inputs["tokens"])
        if rank:
            g.pop("grads")
        out["grads"][(dm, sp, remat)] = g
    out["runs"] = {}
    for name, (dm, sp, overrides, _) in RUNS.items():
        out["runs"][name] = _train(meshes[dm], sp, overrides, str(work / name), np_params)

    # the elastic resume: 2 x 2 preempted, then one device; one device
    # preempted (rank 0 alone), then 2 x 2
    elastic = dict(TRAIN, steps=ELASTIC_STEPS)
    with reference_init(np_params):
        with preempt_after(PREEMPT_AFTER):
            first = train.run(train.TrainConfig(**elastic, ckpt_dir=str(work / "to_one")),
                              mesh=meshes[(2, 2)])["losses"]
        rest = None
        if rank == 0:
            rest = train.run(train.TrainConfig(**elastic, ckpt_dir=str(work / "to_one")),
                             device="cpu")["losses"]
            with preempt_after(PREEMPT_AFTER):
                solo = train.run(train.TrainConfig(**elastic, ckpt_dir=str(work / "to_mesh")),
                                 device="cpu")["losses"]
        dist.barrier()
        resumed = train.run(train.TrainConfig(**elastic, ckpt_dir=str(work / "to_mesh")),
                            mesh=meshes[(2, 2)])["losses"]
    out["elastic"] = dict(to_one=(first, rest), to_mesh=(solo if rank == 0 else None, resumed))
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.barrier()
    return 0
