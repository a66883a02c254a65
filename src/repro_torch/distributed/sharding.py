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

The port runs on one device: :func:`make_shard_mesh` describes a
``("shard",)`` mesh over the CUDA devices present (or the one CPU device),
``launch/mesh.py::make_host_mesh`` a 1 x 1 ``("data", "model")`` mesh, and
:func:`constrain` is the identity. A dispatch over several devices, and
:func:`params_sharding` for the LM stack, are not ported (ROADMAP Queue 1
item 10).

The placement contract sharded serving relies on is
:func:`segment_placement`: contiguous blocks, dead padding at the tail, so
flattening shards in axis order preserves the unsharded segment order, the
property that keeps the sharded top-k merge's tie-breaks identical to the
single-device results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

_STATE = threading.local()

#: a ``PartitionSpec``-like tuple: per dim a mesh-axis name, a tuple of them, or None
Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A mesh of named axes over torch devices: ``axis_names``, their
    ``axis_sizes`` (the device count over one ``"shard"`` axis by default),
    a ``shape`` mapping and the devices in row-major axis order. The
    serving mesh is ``("shard",)``; the LM stack's ``("data", "model")``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("shard",)
    axis_sizes: Optional[Tuple[int, ...]] = None

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
# serving-side segment placement (sharded vector search)
# ---------------------------------------------------------------------------
def make_shard_mesh(n_shards: Optional[int] = None, device=None) -> ShardMesh:
    """1-D serving mesh over the "shard" axis: the CUDA devices present
    (``device`` None or a CUDA device), or the one CPU device
    (``device="cpu"``). ``n_shards`` defaults to every such device; asking
    for more shards than devices is an error."""
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
    """The identity: the port runs on one device, where every constraint
    is met. Kept so model code can annotate its activations."""
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


def params_sharding(params, rules: ShardingRules):
    """The reference's per-leaf parameter shardings: not ported. The port
    trains and serves on one device; sharded parameters are ROADMAP Queue 1
    item 10."""
    raise NotImplementedError("params_sharding: the port runs on one device; sharded "
                              "parameters are ROADMAP Queue 1 item 10")


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
