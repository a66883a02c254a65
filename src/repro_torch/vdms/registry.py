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

The seven built-in families register themselves when
``repro_torch.vdms.indexes`` imports; lookups here trigger that import
lazily so the registry is never observed half-populated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from ..core.space import Param, SearchSpace

#: build(gen, segs, gids, params, sys) -> IndexBundle
BuildFn = Callable[..., Any]
#: search(q, arrays, *, k_seg, **static) -> (ids, sims), each (n_seg, B, k_seg)
SearchFn = Callable[..., Tuple[Any, Any]]
#: chunk_cost(static, arrays, n_sealed, seg_size, dim) -> (flops, seq_steps)
ChunkCostFn = Callable[[Dict[str, Any], Dict[str, Any], int, int, int], Tuple[float, int]]
#: build_cost(config, seg_size, dim, first_build) -> flops beyond the storage pass
BuildCostFn = Callable[[Dict[str, Any], int, int, bool], float]
#: fused_search(q, arrays, growing, growing_gids, *, k_seg, topk, clamp=False,
#:              **static) -> (B, topk) global ids
FusedSearchFn = Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class IndexFamily:
    """One declarative index-family spec (the unit of registration).

    ``build`` takes ``(gen, segs, gids, params, sys)`` (``gen`` a
    ``torch.Generator`` on the segments' device) and returns an
    ``IndexBundle`` whose ``kind`` equals :attr:`name`, or :attr:`builds_kind`
    when the family delegates to another family's bundle layout, like
    AUTOINDEX building IVF_FLAT bundles. ``search`` receives the bundle's
    arrays and statics as keyword arguments.

    ``chunk_cost`` / ``build_cost`` back the engine's deterministic analytic
    mode; without them analytic search cost falls back to an exhaustive-scan
    estimate and build cost charges only the storage pass.

    ``fused_search`` is the optional fused-pipeline hook (see
    ``repro_torch.vdms.fused``): one call replacing the whole per-search hot
    path. Families without one run their composed ``search`` through the
    engine's generic merge, with identical result sets.
    """

    name: str
    params: Tuple[Param, ...]
    build: BuildFn
    search: SearchFn
    fused_search: Optional[FusedSearchFn] = None
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
        if self.fused_search is not None and not callable(self.fused_search):
            raise TypeError(f"{self.name}: fused_search must be callable or None")

    @property
    def kind(self) -> str:
        """Bundle ``kind`` this family's build produces."""
        return self.builds_kind or self.name


class IndexFamilyRegistry:
    """Ordered name -> :class:`IndexFamily` mapping."""

    def __init__(self):
        self._families: Dict[str, IndexFamily] = {}

    def register(self, family: IndexFamily) -> IndexFamily:
        if family.name in self._families:
            raise ValueError(f"index family {family.name!r} is already registered")
        if family.builds_kind is not None and family.builds_kind not in self._families:
            raise ValueError(
                f"{family.name}: builds_kind={family.builds_kind!r} is not a "
                f"registered family; registered: {sorted(self._families)}"
            )
        self._families[family.name] = family
        return family

    def unregister(self, name: str) -> IndexFamily:
        """Remove a registered family (undoes :meth:`register`)."""
        family = self.get(name)
        del self._families[name]
        return family

    def get(self, name: str) -> IndexFamily:
        try:
            return self._families[name]
        except KeyError:
            raise ValueError(
                f"unknown index family {name!r}; registered families: "
                f"{sorted(self._families)}"
            ) from None

    def families(self) -> Tuple[IndexFamily, ...]:
        return tuple(self._families.values())


#: The process-wide registry every dispatch path consults.
REGISTRY = IndexFamilyRegistry()


def _ensure_builtins() -> None:
    # the built-in families register on repro_torch.vdms.indexes import; lazy
    # so `import repro_torch.vdms.registry` alone never sees a half-populated
    # registry
    from . import indexes  # noqa: F401


def get_family(name: str) -> IndexFamily:
    _ensure_builtins()
    return REGISTRY.get(name)


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


def make_space() -> SearchSpace:
    """The holistic search space of every registered family, in
    registration order (for the seven built-ins, identical to the JAX
    package's: same params, defaults and encoding-column order)."""
    _ensure_builtins()
    return SearchSpace.from_families(REGISTRY.families(), SYSTEM_PARAMS)
