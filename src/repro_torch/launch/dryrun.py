"""Dry-run: trace one step of an (architecture x input shape) cell on the
``meta`` device, count its work, prove its memory fits, and extract the
roofline terms. The port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k \\
        --out experiments/dryrun_torch [--remat dots]

Where the reference lowers and compiles the step for a 256- or 512-chip
mesh and reads XLA's cost and memory analyses, the port runs the step (a
training step with loss, backward and AdamW; a prefill; or one decode
step) on tensors of the ``meta`` device, which have shapes and dtypes and
no storage, under a ``TorchDispatchMode`` counter (:class:`CostCounter`):

* FLOPs of the products, by ``torch.utils.flop_counter``;
* bytes: each aten op's tensor inputs read once and its outputs written
  once, views free (the eager analogue of XLA's "bytes accessed");
* temp: the most bytes of storages that the step allocated and held at
  once (its arguments excluded; ``temp_size_in_bytes``), tracked by weak
  references to the storages (:class:`CostCounter`).

Attention goes through ``ops.flash_attention``'s meta route, which reports
the blocked plain version's closed-form cost at the process-wide blocks
(``kernels/flash_xla.py``), as the reference compiles ``flash_xla``: the
counts, the ``Roofline`` and the serving tuner's objectives hold that
cost. The record keeps attention's share apart (``flash_blocked``) beside
the least work of the card's flash kernels for the same calls
(``flash_kernels``); :func:`kernel_roofline` swaps one for the other, the
bound that a step on the card cannot beat.
Every layer is traced: the reference extrapolated from depths 1 and 2 only
because XLA counts a loop body once. A step that cannot be traced is a
``[FAIL]`` with its error.

``--mesh host`` (the default) traces the step on one device: chips = 1 and
no collective (``{arch}_{shape}_1.json``). ``--mesh single|multi|both``
traces one rank's training step over the reference's production mesh
(``launch/mesh.py::make_production_mesh``, 256 or 512 ``meta`` devices;
``{arch}_{shape}_256.json`` / ``_512.json``): the rank's blocks of the
weights and moments (``params_sharding``) and its rows of the batch, the
model's explicit collectives run by the virtual group, which counts each
kind's bytes and calls (``distributed/collectives.py``); the ``Roofline``
takes the per-rank counts times the chips, as the reference scales its
per-device HLO. The dense family's training cells are sharded; another
family, or a serving shape, on a mesh raises ``NotImplementedError``
naming the ROADMAP item it waits for (``[TODO]`` lines, no record).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import SHAPES, get_arch, input_specs, list_archs, shape_applicable
from ..distributed.collectives import DP_AXES, comm_for
from ..distributed.sharding import ShardingRules, params_sharding, shard_params, use_rules
from ..kernels import flash_xla
from ..models import build_model
from ..models.api import meta_params
from ..optim import adamw
from . import hlo_analysis
from .mesh import make_host_mesh, make_production_mesh, virtual_mesh


# ---------------------------------------------------------------------------
def _cache_axes(path, shape):
    name = path[-1]
    rank = len(shape)
    if name in ("k", "v", "ck", "cv"):  # (L, b, s, kv, hd)
        return (None, "batch", "kv_seq", None, None)[:rank]
    if name == "h":  # (L, b, nh, hp, ns)
        return (None, "batch", "heads", None, None)[:rank]
    if name == "conv":  # (L, b, w, conv_dim)
        return (None, "batch", None, "ssm_inner")[:rank]
    return (None,) * rank


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def cache_sharding(cache, rules: ShardingRules):
    """Per leaf of a KV / SSM cache (nested dicts of tensors) its
    ``NamedSharding`` under ``rules`` (None without a mesh)."""
    return _map_tree(lambda path, x: rules.sharding(_cache_axes(path, tuple(x.shape)), tuple(x.shape)),
                     cache)


def batch_sharding(batch, rules: ShardingRules):
    """Per input of a batch: its leading dim over the batch axes."""
    return _map_tree(lambda _, x: rules.sharding(("batch",) + (None,) * (x.dim() - 1), tuple(x.shape)),
                     batch)


# ---------------------------------------------------------------------------
def model_flops_for(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    if cfg.family == "encdec":
        # encoder params see b*s source frames; decoder params see b*tgt
        d, ff = cfg.d_model, cfg.d_ff
        attn = (
            d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
            + cfg.n_heads * cfg.hd * d
        )
        enc_params = cfg.enc_layers * (attn + 3 * d * ff)
        dec_params = cfg.n_layers * (2 * attn + 3 * d * ff) + 2 * cfg.vocab_padded * d
        b, s = shape.global_batch, shape.seq_len
        tgt = min(cfg.dec_target_len, max(s // 32, 16))
        if shape.kind == "decode":
            return mult * dec_params * b
        return mult * (enc_params * b * s + dec_params * b * tgt)
    if shape.kind == "decode":
        return mult * n_active * shape.global_batch  # one token per sequence
    return mult * n_active * shape.global_batch * shape.seq_len


def _with_depth(cfg, units: int):
    """Reduced-depth copy: ``units`` layers for most families, groups of
    ``attn_every`` layers for the hybrid, encoder and decoder layers each
    for encdec."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=units, enc_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
#: ops that alias their input, beyond those the schema marks as views
_FREE = {_aten._unsafe_view.default, _aten.lift_fresh.default}
#: allocations that write nothing
_EMPTY = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
          _aten.new_empty_strided.default, _aten.empty_like.default}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the aten ops run inside it (any device; ``meta`` in the
    dry-run): ``product_flops`` (by ``torch.utils.flop_counter``, plus the
    FLOPs of meta-route attention reported by ``flash_xla.cost``; that
    share, and the card's kernels' for the same calls, also apart in
    ``flash_blocked`` and ``flash_kernels``),
    ``bytes`` (tensor inputs read once and outputs written once a call,
    views and empty allocations free) and ``peak`` (the most bytes of
    storages allocated inside and alive at once; a storage is alive while a
    tensor or autograd holds it, followed by a weak reference to its
    Python object, which PyTorch keeps for the storage's lifetime).
    Meta-route attention adds its closed-form bytes, and its temp as a
    transient over the live bytes of that moment."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.flash_blocked = {"flops": 0.0, "bytes": 0.0}
        self.flash_kernels = {"flops": 0.0, "bytes": 0.0}
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._tracked = weakref.WeakSet()
        self._flop = FlopCounterMode(display=False)
        self._sink = flash_xla.cost_sink(self._take)

    @property
    def product_flops(self) -> float:
        return float(self._flop.get_total_flops()) + self.flash_blocked["flops"]

    def __enter__(self):
        self._flop.__enter__()
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)
            self._flop.__exit__(*exc)

    def _take(self, blocked: Dict[str, float], kernels: Dict[str, float]) -> None:
        for key in ("flops", "bytes"):
            self.flash_blocked[key] += blocked[key]
            self.flash_kernels[key] += kernels[key]
        self.bytes += blocked["bytes"]
        self.peak = max(self.peak, self.live + int(blocked["temp"]))

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if func.is_view or func in _FREE:
            return out
        ins = {id(t): t for t in _tensors((args, kwargs))}
        outs = list(_tensors(out))
        if func not in _EMPTY:
            self.bytes += sum(_nbytes(t) for t in ins.values()) + sum(_nbytes(t) for t in outs)
        in_storages = {id(t.untyped_storage()) for t in ins.values()}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in in_storages or st in self._tracked:
                continue
            self._tracked.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._freed, n)
        self.peak = max(self.peak, self.live)
        return out


def _check_storage_identity() -> None:
    t = torch.empty(1, device="meta")
    if t.untyped_storage() is not t.untyped_storage():
        raise RuntimeError("this PyTorch gives a new Python object per storage access; the dry-run's "
                           "memory tracker needs one object a storage")


def _unique_bytes(*trees) -> int:
    seen, n = set(), 0
    for t in _tensors(list(trees)):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def _step_inputs(cfg, shape, rules: ShardingRules = None) -> Tuple[torch.nn.Module, object, Dict]:
    """The step's arguments on ``meta``: the weights (with gradients for a
    training step), the AdamW state (training) or the cache (decode, of
    ``shape.seq_len`` slots), and the batch. Over a virtual mesh of several
    devices: rank 0's blocks of the weights and its rows of the batch."""
    params = meta_params(cfg)
    batch = input_specs(cfg, shape)
    comm = comm_for(rules.mesh if rules is not None else None)
    if comm.backend != "none":
        shard_params(params, params_sharding(params, rules))
        dp = comm.axes(DP_AXES)
        rows = shape.global_batch // comm.size(dp)
        batch = {k: v[comm.index(dp) * rows:(comm.index(dp) + 1) * rows] for k, v in batch.items()}
    if shape.kind == "train":
        params.requires_grad_(True)
        return params, adamw.init_state(params), batch
    if shape.kind == "decode":
        model = build_model(cfg, "meta")
        return params, model.init_cache(shape.global_batch, shape.seq_len), batch
    return params, None, batch


def _check_sharded(cfg, shape, mesh) -> None:
    """What the port traces over a mesh of several devices: the dense
    family's training step, its global batch split evenly over the
    data-parallel axes."""
    if mesh is None or mesh.size == 1:
        return
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh waits for ROADMAP Queue 1 (the MoE's "
            "expert axis, the SSM and hybrid ssm_inner axis)")
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.name}: serving on a mesh (the kv_seq cache axis) waits "
                                  "for ROADMAP Queue 1")
    dp = comm_for(mesh).size(DP_AXES)
    if shape.global_batch % dp:
        raise ValueError(f"{shape.name}: global batch {shape.global_batch} over {dp} data-parallel ranks")


def _compile_step(cfg, shape, mesh, rules: ShardingRules, remat: str) -> Dict:
    """Trace the step of ``cfg`` at ``shape`` on meta tensors under a
    :class:`CostCounter`; returns its counts (``flops``, ``bytes``,
    ``arg_bytes``, ``out_bytes``, ``temp``, ``ops``; attention's share as
    the blocked version and as the card's kernels, ``flash_blocked`` and
    ``flash_kernels``; ``coll_bytes`` and ``coll_counts`` per kind). On the
    1 x 1 host mesh there is no collective; over a virtual mesh of several
    devices the counts are rank 0's."""
    _check_storage_identity()
    _check_sharded(cfg, shape, mesh)
    model = build_model(cfg, "meta", remat=remat)
    params, state, batch = _step_inputs(cfg, shape, rules)
    arg_bytes = _unique_bytes(dict(params.named_parameters()), state, batch)
    comm = comm_for(mesh if mesh is not None and mesh.size > 1 else None)
    comm.stats.reset()
    counter = CostCounter()
    with use_rules(rules), counter:
        if shape.kind == "train":
            names, leaves = zip(*params.named_parameters())
            loss = model.loss(params, batch)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            adamw.apply_updates(params, grads, state, adamw.AdamWConfig())
            outs = (loss,)
            del grads
        elif shape.kind == "prefill":
            outs = model.prefill(params, batch)
        else:
            pos = (cfg.dec_target_len if cfg.family == "encdec" else shape.seq_len) - 1
            outs = model.decode(params, state, batch["tokens"], pos)[:1]
    coll = {k: v for k, v in comm.stats.bytes.items() if v}
    return {"flops": counter.product_flops, "bytes": counter.bytes, "arg_bytes": arg_bytes,
            "out_bytes": _unique_bytes(outs), "temp": counter.peak, "ops": counter.ops,
            "flash_blocked": counter.flash_blocked, "flash_kernels": counter.flash_kernels,
            "coll_bytes": coll, "coll_counts": {k: comm.stats.counts[k] for k in coll}}


def _costs_of(traced: Dict) -> Dict:
    return {"flops": traced["flops"], "bytes": traced["bytes"], "coll_bytes": traced["coll_bytes"],
            "coll_counts": traced["coll_counts"]}


def measure_costs(cfg, shape, mesh, remat: str, units=(1, 2)) -> Dict:
    """The step's costs, counted at full depth in one trace: every layer of
    an eager step is traced, so nothing is extrapolated. ``units`` is the
    reference's pair of depths and is not used."""
    return _costs_of(_compile_step(cfg, shape, mesh, ShardingRules(mesh), remat))


def lower_cell(arch_name: str, shape_name: str, multi_pod: Optional[bool] = None,
               remat: str = "dots"):
    """Trace one (arch, shape) cell. Returns (Roofline, meta), or (None,
    {"skipped": why}). ``multi_pod`` None traces on one device (chips 1, no
    collective); False and True trace one rank's step over the reference's
    256- and 512-chip production meshes (``make_production_mesh``), with
    the collective term: per-rank collective bytes times the chips, as the
    reference's ``Roofline`` (``src/repro/launch/dryrun.py``). The costs are
    exact: one trace counts every layer."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    mesh = make_host_mesh("meta") if multi_pod is None else make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    mesh_name = "x".join(str(n) for n in mesh.axis_sizes)
    rules = ShardingRules(mesh)

    t0 = time.perf_counter()
    traced = _compile_step(cfg, shape, mesh, rules, remat)
    meta = {
        "prod_compile_s": time.perf_counter() - t0,
        "fallbacks": sorted(set(rules.fallbacks)),
        "memory_analysis": {
            "argument_size_in_bytes": int(traced["arg_bytes"]),
            "output_size_in_bytes": int(traced["out_bytes"]),
            "temp_size_in_bytes": int(traced["temp"]),
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": 0,
        },
        "costs_exact": True,
        "traced_ops": traced["ops"],
        "flash_blocks": list(flash_xla.get_default_blocks()),
        "flash_blocked": traced["flash_blocked"],
        "flash_kernels": traced["flash_kernels"],
        "remat": remat,
    }
    costs = _costs_of(traced)
    roof = hlo_analysis.Roofline(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=costs["flops"] * chips, hlo_bytes=costs["bytes"] * chips,
        coll_bytes=float(sum(costs["coll_bytes"].values())) * chips,
        coll_breakdown={k: int(v * chips) for k, v in costs["coll_bytes"].items()},
        coll_counts=costs["coll_counts"],
        model_flops=model_flops_for(cfg, shape),
        peak_mem_per_dev=float(traced["temp"]),
    )
    return roof, meta


def kernel_roofline(roof: hlo_analysis.Roofline, meta: Dict) -> hlo_analysis.Roofline:
    """``roof`` (of :func:`lower_cell`) with attention counted as the card's
    flash kernels do it (``meta["flash_kernels"]``) in place of the blocked
    plain version (``meta["flash_blocked"]``): every other op runs on the
    card as it was traced, so a step on the card cannot be faster than this
    bound. The blocked count stays the dry-run's and the tuner's, as the
    reference compiles ``flash_xla``."""
    blocked, kernels = meta["flash_blocked"], meta["flash_kernels"]
    return dataclasses.replace(
        roof, hlo_flops=roof.hlo_flops + (kernels["flops"] - blocked["flops"]) * roof.chips,
        hlo_bytes=roof.hlo_bytes + (kernels["bytes"] - blocked["bytes"]) * roof.chips)


def _run_cell(arch: str, shape: str, multi_pod: Optional[bool], remat: str, out_dir: Path) -> int:
    """Trace one cell, print its line and write its record; 1 if it failed."""
    tag = f"{arch}_{shape}_{ {None: 1, False: 256, True: 512}[multi_pod] }"
    t0 = time.perf_counter()
    try:
        roof, meta = lower_cell(arch, shape, multi_pod=multi_pod, remat=remat)
    except NotImplementedError as e:
        print(f"[TODO] {tag}: {e}", flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 -- a cell that cannot be traced is reported
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        return 1
    if roof is None:
        print(f"[SKIP] {tag}: {meta['skipped']}", flush=True)
        record = {"arch": arch, "shape": shape, "skipped": meta["skipped"]}
    else:
        record = {**roof.to_dict(), **meta}
        print(
            f"[OK] {tag}: compute={roof.compute_s*1e3:.2f}ms "
            f"memory={roof.memory_s*1e3:.2f}ms coll={roof.collective_s*1e3:.2f}ms "
            f"bound={roof.bottleneck} useful={roof.useful_ratio:.2f} "
            f"frac={roof.roofline_fraction:.3f} "
            f"temp/dev={meta['memory_analysis']['temp_size_in_bytes']/2**30:.2f}GiB "
            f"(trace {meta['prod_compile_s']:.1f}s, {meta['traced_ops']} ops)",
            flush=True,
        )
    record["wall_s"] = time.perf_counter() - t0
    (out_dir / f"{tag}.json").write_text(json.dumps(record, indent=1))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["host", "single", "multi", "both"], default="host",
                    help="host: one device (_1.json); single / multi / both: one rank over the "
                         "256- / 512-chip production meshes (_256.json / _512.json)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = 0
    meshes = {"host": [None], "single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                failures += _run_cell(arch, shape, mp, args.remat, out_dir)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
