"""Declarative index-family registry of the port: ONE spec per family
drives everything (the counterpart of the JAX package's ``vdms/registry.py``).

An :class:`IndexFamily` carries the tuning-facing knowledge about one ANNS
index family: its tunable :class:`~repro_torch.core.space.Param` specs (with
defaults), its build/search callables, the optional fused search hook, and
the analytic cost-model hooks.

* :func:`make_space` derives the holistic ``SearchSpace`` (the paper's
  non-fixed parameter space, §II-B Table I) from the registered families;
* ``indexes.build_index`` / ``indexes.search_index`` dispatch through it;
* the engine's analytic search/build cost models ask the family for its
  FLOP formulas.

Adding a family is ONE :func:`register_family` call (``ivf_pqr`` is the
worked example); :func:`unregister_family` and :func:`temporary_family`
undo it.

The seven built-in families register themselves when
``repro_torch.vdms.indexes`` imports; lookups here trigger that import
lazily so the registry is never observed half-populated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

from ..core.space import Param, SearchSpace

#: build(draws, segs, gids, params, sys[, frozen=]) -> IndexBundle
BuildFn = Callable[..., Any]
#: search(q, arrays, *, k_seg, **static) -> (ids, sims), each (n_seg, B, k_seg)
SearchFn = Callable[..., Tuple[Any, Any]]
#: chunk_cost(static, arrays, n_sealed, seg_size, dim) -> (flops, seq_steps)
ChunkCostFn = Callable[[Dict[str, Any], Dict[str, Any], int, int, int], Tuple[float, int]]
#: build_cost(config, seg_size, dim, first_build) -> flops beyond the storage pass
BuildCostFn = Callable[[Dict[str, Any], int, int, bool], float]
#: fused_search(q, arrays, growing, growing_gids, *, k_seg, topk, clamp=False,
#:              alive=None, **static) -> (B, topk) global ids
FusedSearchFn = Callable[..., Any]
#: shard_search(q, arrays, *, k_seg, **static) -> (ids, sims), each
#: (n_seg_local, B, k_seg) with GLOBAL ids and composed masking (-1/-inf)
ShardSearchFn = Callable[..., Tuple[Any, Any]]


@dataclasses.dataclass(frozen=True)
class IndexFamily:
    """One declarative index-family spec (the unit of registration).

    ``build`` takes ``(draws, segs, gids, params, sys)`` (``draws`` the
    build's source of random draws, a ``repro_torch.vdms.draws.BuildDraws``
    by default), and ``frozen=`` as well when the family
    ``supports_frozen``; it returns an
    ``IndexBundle`` whose ``kind`` equals :attr:`name`, or :attr:`builds_kind`
    when the family delegates to another family's bundle layout, like
    AUTOINDEX building IVF_FLAT bundles. ``search`` receives the bundle's
    arrays and statics as keyword arguments.

    ``shared_arrays`` names the bundle arrays that hold segment-shared
    calibration state (quantizer scales, PQ codebooks): ``frozen_state``
    extracts exactly these, incremental builds re-inject them through
    ``frozen=``, and the bundle lifecycle ops never concatenate them.
    ``supports_frozen`` says the build honours ``frozen=``;
    ``supports_incremental`` says a live instance may seal one segment at a
    time with it.

    ``chunk_cost`` / ``build_cost`` back the engine's deterministic analytic
    mode; without them analytic search cost falls back to an exhaustive-scan
    estimate and build cost charges only the storage pass.

    ``fused_search`` is the optional fused-pipeline hook (see
    ``repro_torch.vdms.fused``): one call replacing the whole per-search hot
    path. Families without one run their composed ``search`` through the
    engine's generic merge, with identical result sets.

    ``shard_search`` is the optional sharded-serving hook (see
    ``repro_torch.vdms.sharded``): the candidate stage each shard runs over
    its local segment stack (per-segment GLOBAL ids and scores, composed
    masking, full ``k_seg`` width). Families without one run their composed
    ``search`` inside each shard, with the same results.
    """

    name: str
    params: Tuple[Param, ...]
    build: BuildFn
    search: SearchFn
    shared_arrays: Tuple[str, ...] = ()
    fused_search: Optional[FusedSearchFn] = None
    shard_search: Optional[ShardSearchFn] = None
    supports_frozen: bool = False
    supports_incremental: bool = True
    builds_kind: Optional[str] = None  # bundle kind produced by build (default: name)
    chunk_cost: Optional[ChunkCostFn] = None
    build_cost: Optional[BuildCostFn] = None
    description: str = ""

    def __post_init__(self):
        if not self.name or not self.name.replace("_", "").isalnum():
            raise ValueError(f"invalid family name {self.name!r}")
        if not callable(self.build) or not callable(self.search):
            raise TypeError(f"{self.name}: build and search must be callable")
        object.__setattr__(self, "params", tuple(self.params))
        for p in self.params:
            if not isinstance(p, Param):
                raise TypeError(f"{self.name}: params must be Param specs, got {p!r}")
        object.__setattr__(self, "shared_arrays", tuple(self.shared_arrays))
        if self.supports_frozen and not self.shared_arrays:
            raise ValueError(
                f"{self.name}: supports_frozen=True requires shared_arrays naming "
                "the calibration state to freeze"
            )
        if self.fused_search is not None and not callable(self.fused_search):
            raise TypeError(f"{self.name}: fused_search must be callable or None")
        if self.shard_search is not None and not callable(self.shard_search):
            raise TypeError(f"{self.name}: shard_search must be callable or None")

    @property
    def kind(self) -> str:
        """Bundle ``kind`` this family's build produces."""
        return self.builds_kind or self.name


class IndexFamilyRegistry:
    """Ordered name -> :class:`IndexFamily` mapping with a public hook."""

    def __init__(self):
        self._families: Dict[str, IndexFamily] = {}

    def register(self, family: IndexFamily, *, replace: bool = False) -> IndexFamily:
        if not isinstance(family, IndexFamily):
            raise TypeError(f"expected an IndexFamily, got {type(family).__name__}")
        if family.name in self._families and not replace:
            raise ValueError(
                f"index family {family.name!r} is already registered "
                "(pass replace=True to override)"
            )
        if family.builds_kind is not None and family.builds_kind not in self._families:
            raise ValueError(
                f"{family.name}: builds_kind={family.builds_kind!r} is not a "
                f"registered family; registered: {sorted(self._families)}"
            )
        self._families[family.name] = family
        return family

    def unregister(self, name: str) -> IndexFamily:
        """Remove a registered family (undoes :meth:`register`)."""
        if name not in self._families:
            raise ValueError(self._unknown(name))
        return self._families.pop(name)

    @contextlib.contextmanager
    def temporary(self, family: IndexFamily) -> Iterator[IndexFamily]:
        """Register ``family`` for the duration of a ``with`` block."""
        self.register(family)
        try:
            yield family
        finally:
            self._families.pop(family.name, None)

    def _unknown(self, name: str) -> str:
        return (
            f"unknown index family {name!r}; registered families: "
            f"{sorted(self._families)}"
        )

    def get(self, name: str) -> IndexFamily:
        try:
            return self._families[name]
        except KeyError:
            raise ValueError(self._unknown(name)) from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._families)

    def families(self) -> Tuple[IndexFamily, ...]:
        return tuple(self._families.values())

    def __contains__(self, name: object) -> bool:
        return name in self._families


#: The process-wide registry every dispatch path consults.
REGISTRY = IndexFamilyRegistry()


def _ensure_builtins() -> None:
    # the built-in families register on repro_torch.vdms.indexes import; lazy
    # so `import repro_torch.vdms.registry` alone never sees a half-populated
    # registry
    from . import indexes  # noqa: F401


# ---------------------------------------------------------------------------
# public hook
# ---------------------------------------------------------------------------
def register_family(family: IndexFamily, *, replace: bool = False) -> IndexFamily:
    """THE extension point: one call makes a family tunable end to end
    (search space, engine dispatch, analytic mode)."""
    _ensure_builtins()
    return REGISTRY.register(family, replace=replace)


def unregister_family(name: str) -> IndexFamily:
    _ensure_builtins()
    return REGISTRY.unregister(name)


def temporary_family(family: IndexFamily):
    """Context manager registering ``family`` only inside a ``with`` block."""
    _ensure_builtins()
    return REGISTRY.temporary(family)


def get_family(name: str) -> IndexFamily:
    _ensure_builtins()
    return REGISTRY.get(name)


def registered_families() -> Tuple[IndexFamily, ...]:
    _ensure_builtins()
    return REGISTRY.families()


def registered_names() -> Tuple[str, ...]:
    _ensure_builtins()
    return REGISTRY.names()


# ---------------------------------------------------------------------------
# registry-derived search space
# ---------------------------------------------------------------------------
_SEGMENT_SIZES = (1024, 2048, 4096, 8192)

#: System parameters shared by every index family (paper §V-A): these are
#: engine-level knobs, so they live with the registry rather than any family.
SYSTEM_PARAMS: Tuple[Param, ...] = (
    Param("segment_max_size", "grid", choices=_SEGMENT_SIZES, default=4096),
    Param("seal_proportion", "float", 0.1, 1.0, default=0.75),
    Param("graceful_time", "float", 0.0, 0.9, default=0.2),
    Param("search_batch_size", "grid", choices=(8, 16, 32, 64, 128), default=32),
    Param("topk_merge_width", "grid", choices=(16, 32, 64, 128), default=64),
    Param("kmeans_iters", "grid", choices=(4, 8, 16, 25), default=8),
    Param("storage_bf16", "cat", choices=(False, True), default=False),
)


def make_space(include: Optional[Sequence[str]] = None) -> SearchSpace:
    """Derive the holistic search space from the registry.

    With ``include=None`` every registered family contributes its declared
    ``Param`` specs, in registration order (for the seven built-ins,
    identical to the JAX package's: same params, defaults and
    encoding-column order). ``include`` restricts the space to a subset of
    families (validated against the registry; registration order is kept
    whatever order ``include`` names them in).
    """
    _ensure_builtins()
    families = REGISTRY.families()
    if include is not None:
        wanted = tuple(include)
        unknown = sorted(set(wanted) - set(REGISTRY.names()))
        if unknown:
            raise ValueError(
                f"unknown index families {unknown}; registered families: "
                f"{sorted(REGISTRY.names())}"
            )
        families = tuple(f for f in families if f.name in wanted)
        if not families:
            raise ValueError("include= selected no families")
    return SearchSpace.from_families(families, SYSTEM_PARAMS)


# ---------------------------------------------------------------------------
# documentation
# ---------------------------------------------------------------------------
def registry_table(families: Optional[Sequence[IndexFamily]] = None) -> str:
    """Markdown table of families (name -> params -> capabilities)."""
    families = tuple(families) if families is not None else registered_families()
    rows = [
        "| Family | Index params (default) | Frozen calibration | Incremental |",
        "|---|---|---|---|",
    ]
    for f in families:
        params = ", ".join(f"`{p.name}`={p.default}" for p in f.params) or "—"
        frozen = ", ".join(f"`{a}`" for a in f.shared_arrays) if f.supports_frozen else "—"
        incr = "yes" if f.supports_incremental else "no"
        rows.append(f"| `{f.name}` | {params} | {frozen} | {incr} |")
    return "\n".join(rows)


def fused_pipeline_table(families: Optional[Sequence[IndexFamily]] = None) -> str:
    """Markdown table of per-family search pipelines (fused vs composed);
    ``Fused stages`` comes from the hook's ``stages`` attribute."""
    families = tuple(families) if families is not None else registered_families()
    rows = [
        "| Family | Search pipeline | Fused stages | Frozen calibration |",
        "|---|---|---|---|",
    ]
    for f in families:
        fused = f.fused_search is not None
        pipe = "fused (composed fallback)" if fused else "composed"
        stages = getattr(f.fused_search, "stages", "—") if fused else "—"
        frozen = ", ".join(f"`{a}`" for a in f.shared_arrays) if f.supports_frozen else "—"
        rows.append(f"| `{f.name}` | {pipe} | {stages} | {frozen} |")
    return "\n".join(rows)


def shard_pipeline_table(families: Optional[Sequence[IndexFamily]] = None) -> str:
    """Markdown table of per-family sharded candidate stages (the
    ``shard_search`` hooks; ``Stages`` from the hook's ``stages``
    attribute). Families without a hook run their composed ``search`` inside
    each shard; the merge tree above is family-independent either way."""
    families = tuple(families) if families is not None else registered_families()
    rows = [
        "| Family | Per-shard candidate stage | Stages |",
        "|---|---|---|",
    ]
    for f in families:
        hooked = f.shard_search is not None
        pipe = "fused shard hook" if hooked else "composed `search` fallback"
        stages = getattr(f.shard_search, "stages", "—") if hooked else "—"
        rows.append(f"| `{f.name}` | {pipe} | {stages} |")
    return "\n".join(rows)
