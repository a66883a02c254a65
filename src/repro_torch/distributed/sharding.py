"""Logical-axis sharding rules of the port (the counterpart of the JAX
package's ``distributed/sharding.py``) and the serving-side segment
placement.

The rules map *logical* axis names onto mesh axes with divisibility
fallbacks (a dimension that does not divide by its mesh axes is left
replicated, and the fallback is recorded):

  batch      -> (pod, data)     activations' batch dim (DP)
  seq        -> None            (train/prefill activations; SP uses "data")
  seq_sp     -> (data,)         sequence-parallel prefill for long contexts
  kv_seq     -> (model,)        decode KV cache sequence
  embed      -> None            activation feature dim
  heads/ff/vocab/experts/ssm_inner -> (model,)   tensor parallel
  kv_heads   -> (model,) if divisible else None
  fsdp       -> (pod, data)     parameter & optimizer-state sharding
  segments   -> (shard,)        a sealed VDMS segment stack's leading dim

``ShardingRules.spec`` returns a plain tuple of mesh-axis names (``None``
for replicated, a tuple where several mesh axes share a dim), the shape of
a ``PartitionSpec``; it works with any mesh object that has ``axis_names``
and a ``shape`` mapping.

Training and serving span devices through a ``torch.distributed`` process
group, one process a rank: :func:`init_shard_group` starts (or adopts) the
default group with an explicit backend and a timeout of its own,
:func:`spawn_ranks` runs a function on N spawned ranks and fails when one of
them does, and :func:`make_shard_mesh` returns a ``("shard",)`` mesh over the
group's ranks once the group is up (else over the devices of this one
process); ``launch/mesh.py::make_train_mesh`` a ``("data", "model")`` mesh.

The LM stack's parameters are laid out by :func:`params_sharding` (the
reference's specs, by path and shape): :func:`shard_params` cuts each rank's
block out of the full weights (and records its spec on the parameter,
``shard_spec``), :func:`gather_params` puts the full tensors back together.
The model code is explicit SPMD over ``distributed/collectives.py``: where
the reference annotates an activation for GSPMD, the port writes the
collective out, so :func:`constrain` is the identity inside a rank.

The placement contract sharded serving relies on is
:func:`segment_placement`: contiguous blocks, dead padding at the tail, so
flattening shards in axis order preserves the unsharded segment order, the
property that keeps the sharded top-k merge's tie-breaks identical to the
single-device results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_STATE = threading.local()

#: a ``PartitionSpec``-like tuple: per dim a mesh-axis name, a tuple of them, or None
Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A mesh of named axes over torch devices: ``axis_names``, their
    ``axis_sizes`` (the device count over one ``"shard"`` axis by default),
    a ``shape`` mapping and the devices in row-major axis order. The
    serving mesh is ``("shard",)``; the LM stack's ``("data", "model")``.

    ``rank`` is set on a mesh over the ranks of a process group: then
    ``devices[r]`` is rank ``r``'s device, this process is rank ``rank``
    and holds only ``device``, and ``backend`` is the group's."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("shard",)
    axis_sizes: Optional[Tuple[int, ...]] = None
    rank: Optional[int] = None
    backend: Optional[str] = None

    def __post_init__(self):
        sizes = self.axis_sizes if self.axis_sizes is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names) or int(np.prod(sizes)) != len(self.devices):
            raise ValueError(f"axes {self.axis_names} of sizes {sizes} do not cover "
                             f"{len(self.devices)} devices")
        object.__setattr__(self, "axis_sizes", tuple(int(n) for n in sizes))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device: its rank's on a process-group mesh."""
        return self.devices[self.rank or 0]

    @property
    def staging(self) -> torch.device:
        """Where tensors pass through a collective: the host under ``gloo``
        (its scatter takes host tensors only; its broadcast and all_gather
        take CUDA tensors too, but stage them more slowly than a copy to the
        host does), the rank's device under ``nccl``."""
        return torch.device("cpu") if self.backend == "gloo" else self.device


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where an array goes: a mesh and a per-dim spec of its axes."""

    mesh: object
    spec: Spec


class ShardingRules:
    def __init__(self, mesh=None, fsdp: bool = True, seq_parallel: bool = True):
        self.mesh = mesh
        self.fsdp = fsdp
        self.seq_parallel = seq_parallel
        self.fallbacks: list[str] = []
        axes = tuple(mesh.axis_names) if mesh is not None else ()
        dp = tuple(a for a in ("pod", "data") if a in axes)
        tp = ("model",) if "model" in axes else ()
        self.logical: Dict[str, Tuple[str, ...]] = {
            "batch": dp,
            "seq": (),
            "seq_sp": ("data",) if "data" in axes else (),
            # sequence parallelism for the residual stream between blocks
            "seq_act": tp if seq_parallel else (),
            "kv_seq": tp,
            "embed": (),
            "heads": tp,
            "kv_heads": tp,
            "head_dim": (),
            "ff": tp,
            "vocab": tp,
            "experts": tp,
            "ssm_inner": tp,
            "ssm_state": (),
            "fsdp": dp if fsdp else (),
            "layers": (),
            "replicated": (),
            # serving: sealed-segment stacks shard their leading segment dim
            # over the "shard" axis; meshes without it leave them replicated
            "segments": ("shard",) if "shard" in axes else (),
        }

    def _axis_size(self, names: Tuple[str, ...]) -> int:
        if self.mesh is None:
            return 1
        return int(np.prod([self.mesh.shape[a] for a in names], initial=1))

    def spec(self, axes: Sequence[Optional[str]], shape: Optional[Tuple[int, ...]] = None) -> Spec:
        """Spec from logical axis names, with divisibility fallback. A mesh
        axis may appear once per spec: later logical axes that resolve to an
        already-used mesh axis fall back to replicated."""
        parts = []
        used: set = set()
        for i, name in enumerate(axes):
            mesh_axes = tuple(
                a for a in self.logical.get(name or "replicated", ()) if a not in used
            )
            if not mesh_axes:
                parts.append(None)
                continue
            if shape is not None:
                sz = self._axis_size(mesh_axes)
                if shape[i] % sz != 0:
                    # fallback: try a prefix of the mesh axes, else replicate
                    for cut in range(len(mesh_axes) - 1, 0, -1):
                        if shape[i] % self._axis_size(mesh_axes[:cut]) == 0:
                            mesh_axes = mesh_axes[:cut]
                            break
                    else:
                        self.fallbacks.append(f"{name}:dim{shape[i]}")
                        parts.append(None)
                        continue
                    if shape[i] % self._axis_size(mesh_axes) != 0:
                        self.fallbacks.append(f"{name}:dim{shape[i]}")
                        parts.append(None)
                        continue
            used.update(mesh_axes)
            parts.append(mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes)
        return tuple(parts)

    def sharding(self, axes: Sequence[Optional[str]], shape=None) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(axes, shape))


# ---------------------------------------------------------------------------
# the process group: one process a rank
# ---------------------------------------------------------------------------
#: a collective that waits longer than this fails (``init_process_group``'s
#: timeout), so a rank that hangs ends the run in minutes
GROUP_TIMEOUT_S = 300.0
FAILURE_GRACE_S = 5.0
BACKENDS = ("gloo", "nccl")


def group_world_size() -> Optional[int]:
    """The default process group's world size, None when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` when
    ``device`` is None or a CUDA device, the CPU for ``device="cpu"``.
    ``LOCAL_RANK`` defaults to the group rank (one host)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if group_world_size() is not None else 0
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def check_backend(backend: str, world_size: int, device=None) -> None:
    """Refuse a backend the ranks cannot use: ``nccl`` needs CUDA and one
    device a rank (NCCL refuses two ranks on one GPU), counting the ranks
    on this host (``LOCAL_WORLD_SIZE``, else ``world_size``). ``gloo`` runs
    anywhere, the CPU and ranks sharing one card included. Nothing picks a
    backend on its own."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if resolve_device(device).type != "cuda":
        raise ValueError("backend='nccl' needs CUDA devices; use backend='gloo' on the CPU")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    n_dev = torch.cuda.device_count()
    if local > n_dev:
        raise ValueError(f"backend='nccl' with {local} ranks on {n_dev} CUDA device(s): ranks "
                         "would share a device, which NCCL refuses; use backend='gloo'")


def init_shard_group(backend: str, *, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = GROUP_TIMEOUT_S, device=None) -> torch.device:
    """Start the default process group, or adopt the one already running,
    and return this rank's device (:func:`rank_device`). ``backend`` is
    explicit (``"gloo"`` or ``"nccl"``, checked by :func:`check_backend`);
    an adopted group must have been started with it. ``init_method``,
    ``world_size`` and ``rank`` go to ``init_process_group`` (None there
    reads the ``env://`` variables); its collectives time out after
    ``timeout_s``."""
    if group_world_size() is not None:
        if dist.get_backend() != backend:
            raise ValueError(f"the running process group uses {dist.get_backend()!r}, "
                             f"not {backend!r}")
        return rank_device(device)
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    check_backend(backend, world, device)
    kw = {k: v for k, v in dict(init_method=init_method, world_size=world_size,
                                rank=rank).items() if v is not None}
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current device
    return dev


def _rank_main(fn, rank, world_size, backend, init_method, device, timeout_s, threads, args):
    """A spawned rank: its environment, the group, ``fn(rank, *args)``; a
    non-zero int returned by ``fn`` is the process's exit code."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(threads)
    init_shard_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                     timeout_s=timeout_s, device=device)
    try:
        code = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    if code:
        raise SystemExit(int(code))


def spawn_ranks(fn: Callable, world_size: int, *, backend: str, device=None,
                args: Sequence = (), join_timeout_s: float = 900.0,
                timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned processes joined in
    one process group (``backend``, a ``file://`` rendezvous in a fresh
    temporary directory). ``spawn``, not ``fork``: CUDA does not survive a
    fork. ``fn`` must be importable by name (a module-level function). On
    the GPU the kernels are built once here first, not by every rank.

    Raises ``RuntimeError`` when a rank exits non-zero or the join passes
    ``join_timeout_s``; the other ranks are then terminated."""
    import multiprocessing as mp

    check_backend(backend, world_size, device)
    if resolve_device(device).type == "cuda":
        from ..kernels import _build

        _build.build_all()
    threads = max(1, len(os.sched_getaffinity(0)) // world_size)  # the cores this process may use
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="shard-group-")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world_size, backend, init, device, timeout_s, threads,
                               tuple(args)))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                # a failed rank takes its peers down with it: give them a few
                # seconds to exit, so the report names every rank that failed
                grace = time.monotonic() + FAILURE_GRACE_S
                while any(p.is_alive() for p in procs) and time.monotonic() < grace:
                    time.sleep(0.05)
                codes = [p.exitcode for p in procs]
                failed = ", ".join(f"rank {r} exit {c}" for r, c in enumerate(codes)
                                   if c not in (None, 0))
                raise RuntimeError(f"rank(s) failed: {failed}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise RuntimeError(f"ranks {late} did not finish within {join_timeout_s:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# serving-side segment placement (sharded vector search)
# ---------------------------------------------------------------------------
def make_shard_mesh(n_shards: Optional[int] = None, device=None) -> ShardMesh:
    """1-D serving mesh over the "shard" axis.

    With the default process group initialised (:func:`init_shard_group`)
    it is a mesh over the group's ranks, one device a rank (each rank's
    :func:`rank_device`, gathered, so every rank builds the same mesh; the
    call is collective); ``n_shards``, when given, must equal the world
    size. Otherwise it is a mesh over this process's devices: the CUDA
    devices present (``device`` None or a CUDA device), or the one CPU
    device (``device="cpu"``); ``n_shards`` defaults to every such device,
    and asking for more shards than devices is an error."""
    if group_world_size() is not None:
        world = dist.get_world_size()
        if n_shards is not None and int(n_shards) != world:
            raise ValueError(f"n_shards={n_shards} differs from the process group's "
                             f"{world} ranks")
        names: List[Optional[str]] = [None] * world
        dist.all_gather_object(names, str(rank_device(device)))
        devices = tuple(torch.device(n) for n in names)
        backend = dist.get_backend()
        if backend == "nccl" and len(set(devices)) < world:
            raise ValueError(f"nccl ranks share devices {names}: NCCL needs one device a rank")
        return ShardMesh(devices, rank=dist.get_rank(), backend=backend)
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(
            f"n_shards={n} exceeds the {len(devices)} available devices; "
            "ShardedVDMS emulates more shards on one device with dispatch='vmap'"
        )
    return ShardMesh(tuple(devices[:n]))


def segment_placement(n_seg: int, n_shards: int) -> Tuple[int, int, np.ndarray]:
    """THE placement contract for sealed segments on a shard mesh.

    Returns ``(per_shard, n_pad, shard_of)``: segments are laid out in
    contiguous blocks of ``per_shard = ceil(n_seg / n_shards)`` — segment
    ``z`` lives on shard ``z // per_shard`` (``shard_of[z]``) — and the
    stack is padded with ``n_pad`` dead segments (gids all -1) so every
    shard holds exactly ``per_shard``. Contiguous blocks + tail padding mean
    concatenating shard-local stacks in shard order reproduces the original
    segment order, which is what keeps the merge tree's lowest-flat-index
    tie-break identical to the unsharded merge.
    """
    if n_seg < 0 or n_shards < 1:
        raise ValueError(f"invalid placement: n_seg={n_seg}, n_shards={n_shards}")
    per_shard = max(1, -(-n_seg // n_shards))
    n_pad = per_shard * n_shards - n_seg
    shard_of = np.arange(n_seg, dtype=np.int32) // per_shard
    return per_shard, n_pad, shard_of


# ---------------------------------------------------------------------------
# context for activation constraints inside model code
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The identity: inside a rank each tensor is already the block the
    model code placed there (explicit SPMD), so a constraint has nothing to
    move. Kept so model code can annotate its activations."""
    return x


# ---------------------------------------------------------------------------
# parameter axis inference by path convention
# ---------------------------------------------------------------------------
_PARAM_AXES_BY_NAME: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("vocab", "fsdp"),
    "head": ("fsdp", "vocab"),
    # attention
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wo": ("heads", "fsdp"),
    "bq": ("heads",),
    "bk": ("kv_heads",),
    "bv": ("kv_heads",),
    # mlp
    "w_gate": ("fsdp", "ff"),
    "w_up": ("fsdp", "ff"),
    "w_down": ("ff", "fsdp"),
    # moe (leading expert dim)
    "we_gate": ("experts", "fsdp", "ff"),
    "we_up": ("experts", "fsdp", "ff"),
    "we_down": ("experts", "ff", "fsdp"),
    "router": ("fsdp", "experts"),
    # ssm
    "in_proj": ("fsdp", "ssm_inner"),
    "out_proj": ("ssm_inner", "fsdp"),
    "conv_w": (None, "ssm_inner"),
    "a_log": (None,),
    "ssm_d": (None,),
    "dt_bias": (None,),
    # norms / misc
    "scale": (None,),
    "bias": (None,),
}


def param_axes_for(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    name = path[-1]
    axes = _PARAM_AXES_BY_NAME.get(name)
    if axes is None:
        axes = (None,) * len(shape)
    # layer-stacked params carry a leading "layers" dim
    if len(shape) == len(axes) + 1:
        axes = ("layers",) + axes
    elif len(shape) != len(axes):
        axes = (None,) * len(shape)
    return axes


def params_sharding(params, rules: ShardingRules) -> Dict[str, Optional[NamedSharding]]:
    """``{name: NamedSharding}`` for every named parameter of a port module
    (or of a mapping name -> tensor, such as AdamW's moments): the
    reference's spec for the same leaf (``param_axes_for`` and
    ``ShardingRules.spec``; None entries without a mesh). The reference
    stacks a family's blocks into one leaf with a leading layer dim, which
    its rules leave replicated; the port's per-block parameters
    (``blocks.<i>.``) share one spec, computed once, so a divisibility
    fallback is recorded once a stacked leaf, as the reference records it."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else dict(params)
    by_leaf: Dict[Tuple[str, Tuple[int, ...]], Optional[NamedSharding]] = {}
    out = {}
    for name, t in named.items():
        shape = tuple(t.shape)
        leaf = (re.sub(r"(^|\.)blocks\.\d+\.", r"\1blocks.*.", name), shape)
        if leaf not in by_leaf:
            by_leaf[leaf] = rules.sharding(param_axes_for(tuple(name.split(".")), shape), shape)
        out[name] = by_leaf[leaf]
    return out


def spec_axes(spec: Optional[Spec]) -> Tuple[str, ...]:
    """The mesh axes a spec splits its tensor over, in spec order."""
    out: List[str] = []
    for entry in spec or ():
        out.extend((entry,) if isinstance(entry, str) else (entry or ()))
    return tuple(out)


def local_block(full: torch.Tensor, spec: Optional[Spec], comm) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view): a dim split
    over mesh axes is cut into their product of equal blocks, block
    ``comm.index(axes)`` (row-major over the axes, as ``NamedSharding``)."""
    out = full
    for dim, entry in enumerate(spec or ()):
        if entry is None:
            continue
        n = comm.size(entry)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over {entry} ({n})")
        size = out.shape[dim] // n
        out = out.narrow(dim, comm.index(entry) * size, size)
    return out


def shard_params(params: torch.nn.Module, shardings: Mapping[str, Optional[NamedSharding]]):
    """Replace each parameter of ``params`` by this rank's block of it (a
    copy: the full tensor is freed) and record the spec on it
    (``param.shard_spec``), in place; returns ``params``. Parameters that
    already carry a spec are left as they are (it must be the same)."""
    from .collectives import comm_for

    with torch.no_grad():
        for name, p in params.named_parameters():
            sh = shardings[name]
            spec = sh.spec if sh is not None else None
            if hasattr(p, "shard_spec"):
                if p.shard_spec != spec:
                    raise ValueError(f"{name} is sharded as {p.shard_spec}, not {spec}")
                continue
            if sh is not None:
                p.data = local_block(p.data, spec, comm_for(sh.mesh)).clone()
            p.shard_spec = spec
    return params


def gather_full(t: torch.Tensor, spec: Optional[Spec], comm) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's block under ``spec``
    (collective: every rank of the mesh calls it; no gradient)."""
    out = t.detach()
    for dim, entry in enumerate(spec or ()):
        if entry is not None:
            out = comm.gather_raw(out, entry, dim)
    return out


def gather_params(params, shardings: Mapping[str, Optional[NamedSharding]]) -> Dict[str, torch.Tensor]:
    """``{name: full tensor}`` of a sharded module or mapping (collective)."""
    from .collectives import comm_for

    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else dict(params)
    return {n: gather_full(t, shardings[n].spec if shardings[n] is not None else None,
                           comm_for(shardings[n].mesh if shardings[n] is not None else None))
            for n, t in named.items()}
