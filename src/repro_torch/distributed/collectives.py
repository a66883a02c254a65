"""Collectives over the named axes of a mesh, with autograd.

The LM stack runs on a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh as explicit SPMD: each rank computes with its own shards as
plain tensors, and the model code says where data crosses ranks. Every
collective here takes the mesh axes it runs over; the ranks of a mesh are
numbered row-major over its axes, so the ranks that share every other
coordinate form one group, and a tensor gathered over several axes is laid
out row-major over them (the layout of ``NamedSharding``).

Differentiable, each the conjugate of the other in the backward:

* :func:`all_gather` (backward: reduce-scatter of the gradient);
* :func:`reduce_scatter` of a sum (backward: all-gather);
* :func:`all_reduce` of a sum (backward: the identity), where partial sums
  leave a tensor-parallel region;
* :func:`copy_to` (the identity; backward: all-reduce of the gradient), where
  a tensor replicated over an axis enters computations whose gradients are
  partial over it.

Without gradient: :func:`all_reduce_max` and :func:`all_reduce_sum`.

A :class:`MeshComm` carries out the collectives of one mesh in one of three
ways:

* ``"group"``: the mesh lies over a ``torch.distributed`` process group (one
  rank a device, ``launch/mesh.py::make_train_mesh``); the sub-group of each
  set of axes comes from ``dist.new_group`` over the mesh's row-major rank
  layout. Under ``gloo`` a CUDA tensor is staged through the host (and
  half-precision sums are taken in f32); under ``nccl`` it stays on its
  device;
* ``"virtual"``: a mesh of ``meta`` devices (the dry-run's production mesh):
  each collective returns a correctly shaped ``meta`` tensor and moves
  nothing; the step is traced as rank 0 sees it;
* ``"none"``: one device, where every collective is the identity.

Each comm counts what its collectives move (:class:`CollectiveStats`): per
kind, under the names the reference's HLO gives them (``all-gather``,
``reduce-scatter``, ``all-reduce``, ``all-to-all``), the bytes of each
result on this rank (the reference's ``hlo_analysis.collective_bytes``
counts result shapes too) and the number of calls; a process-group comm
also the seconds spent inside them (the device synchronised on both sides).
A collective over axes of total size 1 is the identity and is not counted.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .sharding import ShardMesh, current_rules

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
#: the data-parallel mesh axes (the batch and the FSDP shards)
DP_AXES = ("pod", "data")

Axes = Union[str, Sequence[str]]

# torch 2.13 deprecates all_gather_into_tensor and reduce_scatter_tensor for
# all_gather_single and reduce_scatter_single, which older releases lack;
# each pair takes the same (output, input, ..., group) arguments
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@dataclasses.dataclass
class CollectiveStats:
    """Bytes of the results and calls per kind, and seconds inside the
    collectives (process-group comms only)."""

    bytes: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    counts: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    seconds: float = 0.0

    def reset(self) -> None:
        self.bytes = dict.fromkeys(KINDS, 0)
        self.counts = dict.fromkeys(KINDS, 0)
        self.seconds = 0.0

    def snapshot(self) -> Dict:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts), "seconds": self.seconds}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MeshComm:
    """The collectives of one :class:`ShardMesh` (see the module's text).
    Built by :func:`comm_for`; building a process-group comm is collective
    (every rank creates every sub-group, in the same order)."""

    def __init__(self, mesh: ShardMesh):
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.sizes = dict(mesh.shape)
        if mesh.size == 1:
            self.backend = "none"
        elif mesh.rank is not None:
            self.backend = "group"
        elif all(d.type == "meta" for d in mesh.devices):
            self.backend = "virtual"
        else:
            raise ValueError(
                f"a mesh of {mesh.size} devices {mesh.axis_sizes} with no process group behind it: "
                "start one (distributed.init_shard_group, or spawn_ranks) and build the mesh over "
                "it with launch.mesh.make_train_mesh")
        self.rank = mesh.rank or 0
        self.coords = dict(zip(self.names, (int(c) for c in np.unravel_index(self.rank, mesh.axis_sizes))))
        self.stats = CollectiveStats()
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.backend == "group":
            self._make_groups()

    # ------------------------------------------------------------------
    def axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` in mesh order, those of size 1 and those the mesh lacks
        dropped."""
        want = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.names if a in want and self.sizes[a] > 1)

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.sizes[a] for a in self.axes(axes)], initial=1))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes`` (its block of a dim
        split over them)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.sizes[a] + self.coords[a]
        return i

    def _make_groups(self) -> None:
        if dist.get_world_size() != self.mesh.size:
            raise ValueError(f"a mesh of {self.mesh.size} devices over a process group of "
                             f"{dist.get_world_size()} ranks")
        live = tuple(a for a in self.names if self.sizes[a] > 1)
        shape = [self.sizes[a] for a in self.names]
        for n in range(1, len(live) + 1):
            for sub in itertools.combinations(live, n):
                if len(sub) == len(live):
                    self._groups[sub] = None  # every rank: the default group
                    continue
                others = [a for a in self.names if a not in sub]
                for fixed in itertools.product(*(range(self.sizes[a]) for a in others)):
                    at = dict(zip(others, fixed))
                    ranks = sorted(
                        int(np.ravel_multi_index(
                            [at[a] if a in at else c[sub.index(a)] for a in self.names], shape))
                        for c in itertools.product(*(range(self.sizes[a]) for a in sub)))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[sub] = group

    # ------------------------------------------------------------------
    def _record(self, kind: str, result: torch.Tensor) -> None:
        self.stats.bytes[kind] += _nbytes(result)
        self.stats.counts[kind] += 1

    def _run(self, axes, kind, inp: torch.Tensor, out_shape, call) -> torch.Tensor:
        """``call(out, inp, group)`` on this process group, staged through
        the host under gloo; the result on ``inp``'s device and dtype."""
        dev, dtype = inp.device, inp.dtype
        cuda = dev.type == "cuda"
        gloo = self.mesh.backend == "gloo"
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x = inp.cpu() if cuda and gloo else inp
        if gloo and kind != "all-gather" and dtype in (torch.bfloat16, torch.float16):
            x = x.float()  # the sums in f32
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        call(out, x.contiguous(), self._groups[axes])
        out = out.to(device=dev, dtype=dtype)
        if cuda:
            torch.cuda.synchronize(dev)
        self.stats.seconds += time.perf_counter() - t0
        return out

    def gather_raw(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The blocks of ``x`` over ``axes``, concatenated along ``dim`` in
        row-major order of the axes."""
        axes = self.axes(axes)
        n = self.size(axes)
        if n == 1:
            return x
        x0 = x.movedim(dim, 0).contiguous()
        shape = (n * x0.shape[0],) + tuple(x0.shape[1:])
        if self.backend == "virtual":
            out = x0.new_empty(shape)
        else:
            out = self._run(axes, "all-gather", x0, shape,
                            lambda o, i, g: _all_gather_into(o, i, group=g))
        self._record("all-gather", out)
        return out.movedim(0, dim).contiguous() if dim % x.dim() else out

    def reduce_scatter_raw(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The sum of ``x`` over ``axes``, this rank's block along ``dim``."""
        axes = self.axes(axes)
        n = self.size(axes)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) over {n} ranks")
        x0 = x.movedim(dim, 0).contiguous()
        shape = (x0.shape[0] // n,) + tuple(x0.shape[1:])
        if self.backend == "virtual":
            out = x0.new_empty(shape)
        else:
            out = self._run(axes, "reduce-scatter", x0, shape,
                            lambda o, i, g: _reduce_scatter_into(o, i, group=g))
        self._record("reduce-scatter", out)
        return out.movedim(0, dim).contiguous() if dim % x.dim() else out

    def all_reduce_raw(self, x: torch.Tensor, axes: Axes, op: str = "sum") -> torch.Tensor:
        """The sum (or max) of ``x`` over ``axes``, a new tensor."""
        axes = self.axes(axes)
        if self.size(axes) == 1:
            return x
        if self.backend == "virtual":
            out = torch.empty_like(x)
        else:
            rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

            def call(o, i, g):
                o.copy_(i)
                dist.all_reduce(o, op=rop, group=g)

            out = self._run(axes, "all-reduce", x, tuple(x.shape), call)
        self._record("all-reduce", out)
        return out


# ---------------------------------------------------------------------------
# the comm of a mesh, and of the rules in force
# ---------------------------------------------------------------------------
_COMMS: Dict[ShardMesh, MeshComm] = {}
_NONE = MeshComm(ShardMesh((torch.device("cpu"),)))


def comm_for(mesh: Optional[ShardMesh]) -> MeshComm:
    """The comm of ``mesh`` (built at the first call, which is collective
    on a process-group mesh); one device's when ``mesh`` is None."""
    if mesh is None:
        return _NONE
    comm = _COMMS.get(mesh)
    if comm is None:
        comm = _COMMS[mesh] = MeshComm(mesh)
    return comm


def current_comm() -> MeshComm:
    """The comm of the active rules' mesh (``sharding.use_rules``)."""
    rules = current_rules()
    return comm_for(rules.mesh if rules is not None else None)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.args = (comm, axes, dim)
        return comm.gather_raw(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axes, dim = ctx.args
        return comm.reduce_scatter_raw(g, axes, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.args = (comm, axes, dim)
        return comm.reduce_scatter_raw(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axes, dim = ctx.args
        return comm.gather_raw(g, axes, dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm.all_reduce_raw(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.args = (comm, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        comm, axes = ctx.args
        return comm.all_reduce_raw(g, axes), None, None


def _resolve(comm: Optional[MeshComm], axes: Axes):
    comm = comm if comm is not None else current_comm()
    return comm, comm.axes(axes)


def all_gather(x: torch.Tensor, axes: Axes, dim: int, comm: Optional[MeshComm] = None) -> torch.Tensor:
    """``x``'s blocks over ``axes`` concatenated along ``dim``; backward: the
    gradient reduce-scattered."""
    comm, axes = _resolve(comm, axes)
    return x if comm.size(axes) == 1 else _AllGather.apply(x, comm, axes, dim)


def reduce_scatter(x: torch.Tensor, axes: Axes, dim: int,
                   comm: Optional[MeshComm] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, this rank's block along ``dim``;
    backward: the gradient all-gathered."""
    comm, axes = _resolve(comm, axes)
    return x if comm.size(axes) == 1 else _ReduceScatter.apply(x, comm, axes, dim)


def all_reduce(x: torch.Tensor, axes: Axes, comm: Optional[MeshComm] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes``; backward: the identity."""
    comm, axes = _resolve(comm, axes)
    return x if comm.size(axes) == 1 else _AllReduce.apply(x, comm, axes)


def copy_to(x: torch.Tensor, axes: Axes, comm: Optional[MeshComm] = None) -> torch.Tensor:
    """The identity; backward: the gradient summed over ``axes``."""
    comm, axes = _resolve(comm, axes)
    return x if comm.size(axes) == 1 else _CopyTo.apply(x, comm, axes)


def all_reduce_sum(x: torch.Tensor, axes: Axes, comm: Optional[MeshComm] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, without a gradient."""
    comm, axes = _resolve(comm, axes)
    return comm.all_reduce_raw(x.detach(), axes, "sum")


def all_reduce_max(x: torch.Tensor, axes: Axes, comm: Optional[MeshComm] = None) -> torch.Tensor:
    """The largest of ``x`` over ``axes``, elementwise, without a gradient."""
    comm, axes = _resolve(comm, axes)
    return comm.all_reduce_raw(x.detach(), axes, "max")
