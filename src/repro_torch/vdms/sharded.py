"""Sharded segment serving of the port (the counterpart of the JAX package's
``vdms/sharded.py``): sealed segments placed on a ``("shard",)`` mesh and
searched through a two-level top-k merge tree.

Sealed segments are embarrassingly parallel: each is searched on its own and
only the per-segment top-k lists meet at the merge. So a corpus is placed in
contiguous blocks of segments (``distributed.segment_placement``, dead
padding at the tail) and searched as

* **leaf (per shard)**: the family's fused ``shard_search`` hook (or its
  composed ``search``) scores the shard's segments, then
  ``merge.partial_topk`` folds them, alive gating included, into one
  ``(B, k_shard)`` partial list;
* **root**: the partial lists concatenate in shard order and
  ``merge.merge_flat`` finishes the reduction with the growing tail, the
  same arithmetic the single-device engine runs, which is why
  ``n_shards=1`` results are byte-identical and every shard count returns
  the same (gid, score) sets.

Dispatch modes: ``direct`` (one shard: the stage, then ``merge_topk``),
``vmap`` (several shards emulated on one device, the same math) and
``shard_map`` (one shard a rank of a ``torch.distributed`` process group,
the counterpart of the JAX package's ``shard_map`` over a device mesh). The
kernels score every segment on its own, so the ``vmap`` leaves run the
family's stage once over the whole padded stack (one kernel launch) and
every shard's ``partial_topk`` as one batched stable top-k
(``merge.shard_partial_topk``), with no host synchronization between
shards. Under ``shard_map`` each rank holds only its block of segments
(rank 0, the root, holds the whole state it was built from), runs the
stage and its ``partial_topk`` on its own device, and the ranks
``all_gather`` the partial lists; every rank then finishes the same root
merge and returns the same ids and scores.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import ShardMesh, group_world_size, make_shard_mesh, segment_placement
from .datasets import VectorDataset, recall_at_k
from .engine import VDMSInstance, _bucket, analytic_chunk_seconds, get_search_pipeline
from .merge import merge_flat, merge_topk, partial_topk, shard_partial_topk
from .registry import get_family

# sharded additions to the analytic cost model (same convention as the
# engine's calibration constants: documented, deterministic)
_SHARD_MERGE_OVERHEAD = 8.0e-5  # one partial list folded at the root, per chunk (s)
_SHARD_DISPATCH_OVERHEAD = 1.5e-4  # collective dispatch per chunk, n_shards > 1 (s)

#: gate: minimum analytic QPS scaling from 1 to 4 shards at bench scale.
MIN_QPS_SCALING_1_TO_4 = 1.5

#: The invariants the sharded engine guarantees (and the bench gate); the
#: JAX package's ``docs/SHARDING.md`` embeds the same table.
SHARD_INVARIANTS: Tuple[Tuple[str, str, str], ...] = (
    (
        "placement",
        "contiguous blocks",
        "segment `z` lives on shard `z // ceil(n_seg / n_shards)`; the stack "
        "pads with dead segments (gids all `-1`) so every shard holds the "
        "same count",
    ),
    (
        "result sets",
        "shard-count-invariant",
        "the per-query `(gid, score)` set is identical for every `n_shards` "
        "(gated by `bench_sharded --check-invariants`)",
    ),
    (
        "single shard",
        "bit-identical",
        "`n_shards=1` returns byte-identical ids to the unsharded engine — "
        "same kernels, same `merge_topk`",
    ),
    (
        "tie-break",
        "lowest flat index",
        "equal scores resolve to the lowest `(segment, slot)` flat position "
        "at every merge level (`lax.top_k` order)",
    ),
    (
        "growing tail",
        "replicated",
        "the tail is brute-forced once at the merge root, after all sealed "
        "candidates — never sharded, never stale across shards",
    ),
    (
        "recall",
        "oracle-exact accounting",
        "bench recall is scored against the brute-force oracle and must "
        "match the unsharded engine exactly",
    ),
    (
        "QPS scaling",
        f">= {MIN_QPS_SCALING_1_TO_4}x at 4 shards",
        "1→4 shard throughput scaling gated in CI at n_base >= 1M "
        "(analytic mode; wall mode reports alongside)",
    ),
)


def shard_invariants_table() -> str:
    """Markdown table of :data:`SHARD_INVARIANTS`."""
    rows = ["| Invariant | Rule | Detail |", "|---|---|---|"]
    for name, rule, detail in SHARD_INVARIANTS:
        rows.append(f"| {name} | {rule} | {detail} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# one query chunk through the merge tree
# ---------------------------------------------------------------------------
def _shard_stage(kind: str, statics: Dict[str, Any], k_seg: int, use_hook: bool) -> Callable:
    """Per-shard candidate stage: the family's fused ``shard_search`` hook
    when registered (and the pipeline mode is fused), else its composed
    ``search``; both return per-segment (n_seg, B, k_seg) GLOBAL ids and
    sims with the same masking."""
    family = get_family(kind)
    if use_hook and family.shard_search is not None:
        return lambda q, arrays: family.shard_search(q, arrays, k_seg=k_seg, **statics)
    return lambda q, arrays: family.search(q, arrays, k_seg=k_seg, **statics)


def _sharded_chunk(q, arrays, alive, growing, growing_gids, *, dispatch, kind, statics, k_seg,
                   topk, n_shards, use_hook, live, return_scores, mesh=None):
    """One query chunk through the two-level merge tree. ``arrays`` carry a
    flat leading segment axis of ``n_shards * per`` (under ``shard_map``
    this rank's block of ``per``, and ``mesh`` is the group's); ``alive`` is
    the global mask (+ sentinel) of the live flavour (ignored when
    ``live=False``); ``growing`` / ``growing_gids`` are the tail, merged
    once at the root."""
    stage = _shard_stage(kind, statics, k_seg, use_hook)
    alive_arg = alive if live else None
    if dispatch == "direct":
        ids, sims = stage(q, arrays)
        return merge_topk(ids, sims, q, growing, growing_gids, topk, alive=alive_arg,
                          return_scores=return_scores)
    if dispatch == "shard_map":
        per = arrays["gids"].shape[0]
        ids, sims = stage(q, arrays)  # this rank's leaf, on its own device
        pid, psc = partial_topk(ids, sims, min(topk, per * k_seg), alive=alive_arg)
        ids2, sims2 = gather_partials(pid, psc, mesh)
    elif dispatch == "vmap":
        per = arrays["gids"].shape[0] // n_shards
        ids, sims = stage(q, arrays)  # every shard's leaf stage in one pass
        ids2, sims2 = shard_partial_topk(ids, sims, n_shards, min(topk, per * k_seg),
                                         alive=alive_arg)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    return merge_flat(ids2, sims2, q, growing, growing_gids, topk, live=live,
                      return_scores=return_scores)


# ---------------------------------------------------------------------------
# the collectives of the shard_map dispatch (every rank calls each, in order)
# ---------------------------------------------------------------------------
def _broadcast(t: Optional[torch.Tensor], shape, dtype, mesh: ShardMesh) -> torch.Tensor:
    """The root's tensor ``t`` on every rank's device. Moved as bytes, so
    every dtype goes through the backend the same way."""
    if mesh.rank == 0:
        buf = t.to(mesh.staging).contiguous()
    else:
        buf = torch.empty(shape, dtype=dtype, device=mesh.staging)
    if buf.numel():
        dist.broadcast(buf.view(torch.uint8), src=0)
    return buf.to(mesh.device)


def _broadcast_object(obj, mesh: ShardMesh):
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_partials(pid: torch.Tensor, psc: torch.Tensor, mesh: ShardMesh):
    """Every rank's (B, k_shard) partial ids and scores, in one
    ``all_gather`` of their bytes, concatenated in rank order: (B, n_shards
    * k_shard), the shard-major flat order of the ``vmap`` dispatch, so the
    root merge breaks ties as the single-device merge does."""
    b, ks = pid.shape
    packed = torch.cat([pid.contiguous().view(torch.uint8), psc.contiguous().view(torch.uint8)],
                       dim=1).to(mesh.staging)
    parts = [torch.empty_like(packed) for _ in range(mesh.size)]
    dist.all_gather(parts, packed)
    flat = torch.cat(parts, dim=1).to(mesh.device).view(b, mesh.size, -1)
    n_id = ks * pid.element_size()
    ids2 = flat[:, :, :n_id].contiguous().view(pid.dtype).reshape(b, -1)
    sims2 = flat[:, :, n_id:].contiguous().view(psc.dtype).reshape(b, -1)
    return ids2, sims2


def _block(name: str, v: torch.Tensor, r: int, per: int) -> torch.Tensor:
    """Shard ``r``'s contiguous block of ``per`` segments of ``v``, dead
    padding appended where the stack runs out."""
    blk = v[r * per : (r + 1) * per]
    short = per - blk.shape[0]
    return _pad_segments(name, blk, short) if short else blk


def _scatter_state(state: Optional[Dict[str, Any]], mesh: ShardMesh) -> Dict[str, Any]:
    """Collective placement: the root (rank 0) holds ``state``; every rank
    returns its own state, whose ``arrays`` are its block of ``per_shard``
    segments (``segment_placement``, dead padding at the tail) and the
    family's shared arrays. The alive mask and the growing tail are
    replicated; the rest travels as one object, with the root's placement
    telemetry. No rank but the root sees another rank's block."""
    root = mesh.rank == 0
    meta = None
    if root:
        n_sealed = int(state["n_sealed"])
        if n_sealed <= 0:
            meta = {"error": "nothing sealed to shard: the corpus has no sealed segments"}
        else:
            per, _, shard_of = segment_placement(n_sealed, mesh.size)
            shared = tuple(get_family(state["kind"]).shared_arrays)
            arrays = state["arrays"]
            ds = state.get("dataset")
            meta = {k: v for k, v in state.items()
                    if k not in ("arrays", "growing", "growing_gids", "alive", "dataset",
                                 "device")}
            meta.update(
                per=per,
                specs={k: (tuple(v.shape), v.dtype, k in shared) for k, v in arrays.items()},
                growing=(tuple(state["growing"].shape), state["growing"].dtype),
                growing_gids=(tuple(state["growing_gids"].shape), state["growing_gids"].dtype),
                alive=None if state["alive"] is None else len(state["alive"]),
                telemetry=_telemetry(arrays, shared, mesh.size, per, shard_of, state["alive"]),
                # what measure() reads on every rank (the vectors stay on the root)
                dataset=None if ds is None else (ds.name, ds.queries, ds.ground_truth, ds.k),
            )
    meta = _broadcast_object(meta, mesh)
    if "error" in meta:
        raise ValueError(meta["error"])
    per, specs, n_alive, ds = (meta.pop(k) for k in ("per", "specs", "alive", "dataset"))
    tail = {k: meta.pop(k) for k in ("growing", "growing_gids")}
    out = dict(meta, device=mesh.device)
    arrays = {}
    for name, (shape, dtype, shared) in specs.items():
        if shared:
            arrays[name] = _broadcast(state["arrays"][name] if root else None, shape, dtype, mesh)
            continue
        buf = torch.empty((per,) + shape[1:], dtype=dtype, device=mesh.staging)
        blocks = None
        if root:
            v = state["arrays"][name]
            blocks = [_block(name, v, r, per).to(mesh.staging).contiguous().view(torch.uint8)
                      for r in range(mesh.size)]
        if buf.numel():
            dist.scatter(buf.view(torch.uint8), blocks, src=0)
        arrays[name] = buf.to(mesh.device)
    out["arrays"] = arrays
    for name, (shape, dtype) in tail.items():
        out[name] = _broadcast(state[name] if root else None, shape, dtype, mesh)
    out["alive"] = None
    if n_alive is not None:
        alive = torch.from_numpy(np.ascontiguousarray(state["alive"])) if root else None
        out["alive"] = _broadcast(alive, (n_alive,), torch.bool, mesh).cpu().numpy()
    out["dataset"] = state["dataset"] if root else (
        None if ds is None else VectorDataset(ds[0], np.empty((0, int(meta["dim"])), np.float32),
                                              *ds[1:]))
    return out


# ---------------------------------------------------------------------------
# the sharded serving instance
# ---------------------------------------------------------------------------
class ShardedVDMS:
    """Sealed segments placed across a shard mesh, serving batched
    multi-stream queries through the two-level top-k merge tree.

    Build it three ways:

    * ``ShardedVDMS(dataset, config, n_shards=4)`` — bulk build (through
      :class:`VDMSInstance`, with ``device`` and ``draws`` passed on) then
      place;
    * ``ShardedVDMS.from_instance(inst, n_shards=4)`` — place an existing
      static instance (shares its arrays; nothing is rebuilt);
    * ``ShardedVDMS.from_live(live, n_shards=4)`` — snapshot a streaming
      :class:`LiveVDMS` (sealed bundle + tombstone/quarantine mask + visible
      tail) for sharded serving with the live merge semantics.

    It serves on the device its state lives on. ``dispatch="auto"`` picks
    ``direct`` at one shard, ``shard_map`` when an initialised process group
    has one rank a shard, and ``vmap`` otherwise.

    ``dispatch="shard_map"`` runs over the default ``torch.distributed``
    process group (``distributed.init_shard_group``; ``mesh`` defaults to
    ``make_shard_mesh`` over its ranks on ``device``), one shard a rank.
    Construction and every ``search`` are collective: every rank calls
    them, in the same order. Rank 0, the root, holds the state (an instance,
    a live engine or the bulk build's inputs; the other ranks pass None or
    nothing), the other ranks receive their blocks, and the root's queries
    are the ones served. Ids, scores, the timing and the search hooks'
    arguments come out the same on every rank.
    """

    def __init__(
        self,
        dataset: Optional[VectorDataset] = None,
        config: Optional[Dict[str, Any]] = None,
        *,
        n_shards: Optional[int] = None,
        mesh=None,
        dispatch: str = "auto",
        seed: int = 0,
        pipeline: Optional[str] = None,
        device=None,
        draws=None,
        _state: Optional[Dict[str, Any]] = None,
    ):
        # --- mesh + dispatch resolution --------------------------------
        if mesh is not None:
            if tuple(mesh.axis_names) != ("shard",):
                raise ValueError(f"expected a ('shard',) mesh, got {mesh.axis_names}")
            self.n_shards = int(mesh.size) if n_shards is None else int(n_shards)
            if self.n_shards != mesh.size:
                raise ValueError("n_shards must match the mesh size when both are given")
            if mesh.size > 1 and mesh.rank is None:
                raise ValueError(
                    "a mesh over several devices of one process is not served: start a "
                    "process group (distributed.init_shard_group) and use dispatch='shard_map', "
                    "or emulate the shards on one device (dispatch='vmap')"
                )
        else:
            self.n_shards = 1 if n_shards is None else int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        world = group_world_size()
        if dispatch == "auto":
            if self.n_shards == 1:
                dispatch = "direct"
            elif world == self.n_shards:
                dispatch = "shard_map"
            else:
                dispatch = "vmap"
        if dispatch not in ("direct", "vmap", "shard_map"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        if dispatch == "direct" and self.n_shards != 1:
            raise ValueError("dispatch='direct' requires n_shards=1")
        if dispatch == "shard_map":
            if world is None:
                raise ValueError(
                    "dispatch='shard_map' runs one shard a rank of a torch.distributed process "
                    "group, and none is initialised (distributed.init_shard_group)"
                )
            if world != self.n_shards:
                raise ValueError(f"dispatch='shard_map' needs one rank a shard: {self.n_shards} "
                                 f"shards on a process group of {world} ranks")
            if mesh is None:
                mesh = make_shard_mesh(self.n_shards, device=device)
            device = mesh.device
        elif mesh is not None and mesh.rank is not None and mesh.size > 1:
            raise ValueError("a mesh over a process group's ranks needs dispatch='shard_map'")
        self.dispatch = dispatch
        self.mesh = mesh

        # --- the state: built here, or received from the root ----------
        root = dispatch != "shard_map" or mesh.rank == 0
        if _state is None and root:
            if dataset is None or config is None:
                raise ValueError("ShardedVDMS needs (dataset, config) or a _state")
            inst = VDMSInstance(dataset, config, seed=seed, device=device, draws=draws)
            _state = _state_from_instance(inst)
        if dispatch == "shard_map":
            _state = _scatter_state(_state, mesh)
        self.dataset = _state.get("dataset")
        self.config = _state.get("config")
        self.kind = _state["kind"]
        self.static = dict(_state["static"])
        self.k_seg = int(_state["k_seg"])
        self.batch = int(_state["batch"])
        self.dim = int(_state["dim"])
        self.seg_size = int(_state["seg_size"])
        self.n_sealed = int(_state["n_sealed"])
        self.build_time = float(_state.get("build_time", 0.0))
        self.device = _state["device"]
        self.live = _state["alive"] is not None
        self.pipeline = pipeline  # None -> follow the engine's global mode
        if self.n_sealed <= 0:
            raise ValueError("nothing sealed to shard: the corpus has no sealed segments")

        # --- placement: contiguous blocks, dead tail padding ------------
        self.per_shard, self.n_pad, self.shard_of = segment_placement(
            self.n_sealed, self.n_shards
        )
        family = get_family(self.kind)
        self.shared_arrays = tuple(family.shared_arrays)
        alive = _state["alive"]
        if dispatch == "shard_map":
            self.arrays = _state["arrays"]  # this rank's block
            telemetry = _state["telemetry"]  # the root's, made from its host copy
        else:
            arrays = dict(_state["arrays"])
            telemetry = _telemetry(arrays, self.shared_arrays, self.n_shards, self.per_shard,
                                   self.shard_of, alive)
            if self.n_pad:
                arrays = {
                    k: (v if k in self.shared_arrays else _pad_segments(k, v, self.n_pad))
                    for k, v in arrays.items()
                }
            self.arrays = arrays
        # per-shard telemetry from one host copy of the gids, made when the
        # state was placed: the state is a snapshot, so stats() never reads
        # the device again
        self._segments, self._coverage, self._stack_bytes = telemetry
        self.growing = _state["growing"]
        self.growing_gids = _state["growing_gids"]
        if alive is None:  # static merge: a dummy operand
            alive = np.zeros(1, bool)
        self.alive = torch.from_numpy(np.ascontiguousarray(alive)).to(self.device)
        self.coverage = float(_state.get("coverage", 1.0))

        # serving instrumentation (the metrics ledger attaches here, same
        # contract as LiveVDMS.search_hooks)
        self.queries_served = 0
        self.last_latencies: np.ndarray = np.empty(0, np.float64)
        self.search_hooks: List[Callable[[int, np.ndarray, float], None]] = []
        self._warmed: set = set()
        self.compile_s = 0.0

    # ------------------------------------------------------------------
    @classmethod
    def from_instance(cls, inst: Optional[VDMSInstance], **kw) -> "ShardedVDMS":
        """Place ``inst`` (None on the ranks other than the root under
        ``shard_map``)."""
        return cls(_state=None if inst is None else _state_from_instance(inst), **kw)

    @classmethod
    def from_live(cls, live, **kw) -> "ShardedVDMS":
        """Snapshot a :class:`LiveVDMS` for sharded serving: sealed bundle,
        tombstone/quarantine-masked alive mask, and the bucketed visible
        tail — the operands ``LiveVDMS.search`` hands its merge, so a
        1-shard snapshot serves byte-identical results to ``live.search``.
        ``live`` is None on the ranks other than the root under ``shard_map``."""
        return cls(_state=None if live is None else _state_from_live(live), **kw)

    # ------------------------------------------------------------------
    def _use_hook(self) -> bool:
        mode = self.pipeline or get_search_pipeline()
        return mode == "fused"

    def _dispatch_chunk(self, q, topk: int, return_scores: bool, use_hook: bool):
        return _sharded_chunk(
            q, self.arrays, self.alive, self.growing, self.growing_gids,
            dispatch=self.dispatch, kind=self.kind, statics=self.static, k_seg=self.k_seg,
            topk=topk, n_shards=self.n_shards, use_hook=use_hook, live=self.live,
            return_scores=return_scores, mesh=self.mesh,
        )

    # ------------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int, mode: str = "analytic",
               return_scores: bool = False):
        """Search the sharded state. Returns ``(ids (Q, topk), elapsed)`` —
        or ``(ids, scores, elapsed)`` with ``return_scores=True``. Analytic
        mode charges the deterministic sharded cost model (the critical
        shard's leaf work + root merge overhead); wall mode times each
        chunk's dispatch (query upload, search, results back on the host),
        its first run of a shape kept apart in ``compile_s``.

        Under ``shard_map`` every rank calls it; the root's arguments are
        the ones served (the others may pass None for ``queries``), each
        chunk's queries are broadcast from the root, and wall mode times the
        root's chunks, the gather included."""
        group = self.dispatch == "shard_map"
        use_hook = self._use_hook()
        if group:
            if self.mesh.rank == 0:
                queries = np.asarray(queries, np.float32)
                call = (queries.shape[0], topk, mode, return_scores, use_hook)
            else:
                call = None
            nq, topk, mode, return_scores, use_hook = _broadcast_object(call, self.mesh)
            if self.mesh.rank != 0:  # a stand-in: each chunk comes from the root
                queries = np.zeros((nq, self.dim), np.float32)
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        b = min(self.batch, max(nq, 1))
        n_chunks = (nq + b - 1) // b
        out = np.empty((n_chunks * b, topk), np.int32)
        scores = np.empty((n_chunks * b, topk), np.float32) if return_scores else None
        chunk_s = np.zeros(n_chunks, np.float64)
        shape_key = (b, topk, use_hook, return_scores)
        dev = self.device

        def dispatch(chunk):
            q = torch.from_numpy(np.ascontiguousarray(chunk))
            if group:
                q = _broadcast(q, q.shape, q.dtype, self.mesh)
            r = self._dispatch_chunk(q.to(dev), topk, return_scores, use_hook)
            if return_scores:
                return r[0].cpu().numpy(), r[1].cpu().numpy()
            return r.cpu().numpy(), None

        for c in range(n_chunks):
            lo = c * b
            chunk = queries[lo : lo + b]
            if chunk.shape[0] < b:  # pad the final chunk by wrapping
                chunk = np.concatenate([chunk, queries[: b - chunk.shape[0]]], axis=0)
            if mode != "analytic" and shape_key not in self._warmed:
                t0 = time.perf_counter()
                dispatch(chunk)
                self.compile_s += time.perf_counter() - t0
                self._warmed.add(shape_key)
            t0 = time.perf_counter()
            ids, sc = dispatch(chunk)
            chunk_s[c] = time.perf_counter() - t0
            out[lo : lo + b] = ids
            if return_scores:
                scores[lo : lo + b] = sc
        if mode == "analytic":
            chunk_s[:] = self._analytic_seconds_per_chunk(b)
        elif group:  # the root's clock, on every rank
            chunk_s = _broadcast(torch.from_numpy(chunk_s), chunk_s.shape, torch.float64,
                                 self.mesh).cpu().numpy()
        counts = np.minimum(b, nq - b * np.arange(n_chunks))
        elapsed = float(chunk_s.sum())
        lat = np.repeat(chunk_s / np.maximum(counts, 1), counts)
        self.last_latencies = lat
        self.queries_served += nq
        for hook in self.search_hooks:
            hook(nq, lat, elapsed)
        if return_scores:
            return out[:nq], scores[:nq], elapsed
        return out[:nq], elapsed

    def search_streams(self, streams: Sequence[np.ndarray], topk: int,
                       mode: str = "analytic") -> Tuple[List[np.ndarray], float]:
        """Batched multi-stream dispatch: concatenate the per-stream query
        batches, run ONE sharded search over the union (amortizing dispatch
        and the merge tree across streams), split results back per stream."""
        streams = [np.asarray(s, np.float32).reshape(-1, self.dim) for s in streams]
        if not streams:
            return [], 0.0
        allq = np.concatenate(streams, axis=0)
        ids, elapsed = self.search(allq, topk, mode=mode)
        outs, lo = [], 0
        for s in streams:
            outs.append(ids[lo : lo + s.shape[0]])
            lo += s.shape[0]
        return outs, elapsed

    # --- analytic cost model ------------------------------------------
    def _analytic_seconds_per_chunk(self, batch: Optional[int] = None) -> float:
        """Deterministic per-chunk cost: shards run their leaves in
        parallel, so the leaf term charges the (padded) per-shard segment
        count — the critical shard — plus the root-merge terms that grow
        with the shard count. ``n_shards=1`` reduces exactly to the
        unsharded engine model."""
        base = analytic_chunk_seconds(
            self.kind,
            self.static,
            self.arrays,
            self.per_shard if self.n_shards > 1 else self.n_sealed,
            self.seg_size,
            int(self.growing.shape[0]),
            self.dim,
            self.batch if batch is None else batch,
        )
        if self.n_shards == 1:
            return base
        return base + self.n_shards * _SHARD_MERGE_OVERHEAD + _SHARD_DISPATCH_OVERHEAD

    def memory_gib(self) -> float:
        """The placed state's size over every shard (padding included) and
        the tail."""
        b = self._stack_bytes + self.growing.numel() * self.growing.element_size()
        return b / (1024.0**3)

    def block_bytes(self) -> int:
        """Bytes of the segment blocks this process holds (its rank's under
        ``shard_map``, the whole padded stack otherwise)."""
        return sum(v.numel() * v.element_size() for k, v in self.arrays.items()
                   if k not in self.shared_arrays)

    def measure(self, topk: Optional[int] = None, repeats: int = 3,
                mode: str = "analytic") -> Dict[str, float]:
        """Objectives at the current shard count (dataset-built instances):
        QPS / recall@K / memory, same contract as ``VDMSInstance.measure``."""
        if self.dataset is None:
            raise ValueError("measure() needs a dataset-built ShardedVDMS")
        ds = self.dataset
        topk = topk or ds.k
        t0 = time.perf_counter()
        ids, _ = self.search(ds.queries, topk, mode="analytic")
        compile_time = time.perf_counter() - t0
        recall = recall_at_k(ids[:, : ds.k], ds.ground_truth)
        nq = ds.queries.shape[0]
        if mode == "analytic":
            b = min(self.batch, nq)
            n_chunks = (nq + b - 1) // b
            elapsed = self._analytic_seconds_per_chunk(b) * n_chunks
        else:
            elapsed = min(self.search(ds.queries, topk, mode="wall")[1] for _ in range(repeats))
        return {
            "speed": float(nq / max(elapsed, 1e-9)),
            "recall": float(recall),
            "mem_gib": float(self.memory_gib()),
            "build_time": float(self.build_time),
            "compile_time": float(compile_time),
            "n_shards": float(self.n_shards),
        }

    # --- serving telemetry --------------------------------------------
    def shard_segments(self) -> np.ndarray:
        """Real (non-padding) sealed segments per shard."""
        return self._segments.copy()

    def shard_coverage(self) -> np.ndarray:
        """Alive fraction of each shard's sealed vectors (1.0 for shards of
        a static instance; padding-only shards serve an empty slice and
        report 0 coverage honestly)."""
        return self._coverage.copy()

    def stats(self) -> Dict[str, float]:
        """JSON-safe serving snapshot (the sharded metrics ledger input)."""
        cov = self._coverage
        segs = self._segments
        populated = segs > 0
        return {
            "n_shards": int(self.n_shards),
            "n_sealed": int(self.n_sealed),
            "per_shard": int(self.per_shard),
            "n_pad_segments": int(self.n_pad),
            "shard_skew": float(segs.max() / max(segs[populated].mean(), 1e-9))
            if populated.any()
            else 0.0,
            "min_shard_coverage": float(cov[populated].min()) if populated.any() else 0.0,
            "mean_shard_coverage": float(cov[populated].mean()) if populated.any() else 0.0,
            "growing_size": int(self.growing.shape[0]),
            "coverage": float(self.coverage),
            "queries_served": int(self.queries_served),
            "mem_gib": float(self.memory_gib()),
            "dispatch": self.dispatch,
        }


# ---------------------------------------------------------------------------
# state snapshots
# ---------------------------------------------------------------------------
def _telemetry(arrays, shared, n_shards: int, per: int, shard_of: np.ndarray,
               alive: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, int]:
    """From the unpadded stack: real segments per shard, each shard's alive
    coverage, and the bytes of the placed stack (``n_shards * per``
    segments of every sharded array, the shared arrays once)."""
    segments = np.bincount(shard_of, minlength=n_shards).astype(np.int64)
    gids = arrays["gids"].cpu().numpy()
    gids = np.concatenate([gids, np.full((n_shards * per - gids.shape[0],) + gids.shape[1:], -1,
                                         gids.dtype)])
    coverage = _shard_coverage(gids.reshape(n_shards, -1), alive)
    nbytes = sum(v.numel() * v.element_size() if k in shared
                 else n_shards * per * int(np.prod(v.shape[1:])) * v.element_size()
                 for k, v in arrays.items())
    return segments, coverage, int(nbytes)


def _shard_coverage(gids: np.ndarray, alive: Optional[np.ndarray]) -> np.ndarray:
    """(n_shards, per * seg) host gids -> each shard's alive fraction of its
    real sealed vectors (1.0 without an alive mask; 0.0 for a shard of
    padding only)."""
    cov = np.zeros(gids.shape[0], np.float64)
    for s, g in enumerate(gids):
        g = g[g >= 0]
        if g.size:
            cov[s] = float(alive[g].mean()) if alive is not None else 1.0
    return cov


def _pad_segments(name: str, v: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Append dead padding segments: id-like arrays pad with -1 (gids map
    them to the dead slot / -inf), everything else with zeros."""
    fill = -1 if name in ("gids", "members") else 0
    pad = torch.full((n_pad,) + tuple(v.shape[1:]), fill, dtype=v.dtype, device=v.device)
    return torch.cat([v, pad], dim=0)


def _state_from_instance(inst: VDMSInstance) -> Dict[str, Any]:
    return {
        "dataset": inst.dataset,
        "config": dict(inst.config),
        "kind": inst.bundle.kind,
        "static": dict(inst.bundle.static),
        "arrays": dict(inst.bundle.arrays),
        "growing": inst.growing,
        "growing_gids": inst.growing_gids,
        "alive": None,  # static merge semantics
        "k_seg": inst.k_seg,
        "batch": inst.batch,
        "dim": inst.dataset.dim,
        "seg_size": inst.plan.seg_size,
        "n_sealed": inst.plan.n_sealed,
        "build_time": inst.build_time,
        "device": inst.device,
    }


def _state_from_live(live) -> Dict[str, Any]:
    if live.bundle is None:
        raise ValueError("nothing sealed to shard: LiveVDMS has no sealed segments")
    vis = live._visible_tail()
    nb = _bucket(vis.size)
    growing = np.zeros((nb, live.dim), np.float32)
    growing[: vis.size] = live.store[vis]
    ggids = np.full(nb, -1, np.int32)
    ggids[: vis.size] = vis
    alive_arr = live.alive
    coverage = 1.0
    if live.quarantined:
        # the degraded-mode masking live.search applies: quarantined
        # segments drop out of the merge, coverage reports the visible share
        alive_arr = live.alive.copy()
        sealed_alive = int((live.alive[: live.capacity] & (live.gid_seg >= 0)).sum())
        lost = 0
        for z in live.quarantined:
            row = live.seg_gids[z]
            valid = row[row >= 0]
            lost += int(live.alive[valid].sum())
            alive_arr[valid] = False
        total = sealed_alive + int(vis.size)
        coverage = float((total - lost) / max(total, 1))
    dev = live.device
    return {
        "dataset": None,
        "config": dict(live.config),
        "kind": live.bundle.kind,
        "static": dict(live.bundle.static),
        "arrays": dict(live.bundle.arrays),
        "growing": torch.from_numpy(growing).to(dev),
        "growing_gids": torch.from_numpy(ggids).to(dev),
        "alive": alive_arr.copy(),
        "k_seg": live.k_seg,
        "batch": live.batch,
        "dim": live.dim,
        "seg_size": live.seg_size,
        "n_sealed": live.n_sealed,
        "build_time": live.build_time,
        "coverage": coverage,
        "device": dev,
    }
