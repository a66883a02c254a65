"""Hybrid search space for VDTuner.

The space mirrors the paper's structure (§II-B, Table I): one categorical
*index type* dimension, per-index-type *index parameters* (the tunable set
changes with the index type — the "non-fixed parameter space" challenge), and
global *system parameters* shared by every index type.

Encoding for the GP surrogate: the index type is one-hot encoded (T dims) and
every numeric parameter of every index type gets exactly one unit-interval
dimension (shared/system parameters have a single copy — the paper's holistic
model, §IV-A). Parameters not owned by a configuration's index type sit at
their encoded default, so the GP input is always fully specified.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

Config = Dict[str, Any]  # {"index_type": str, <param>: value, ...}


@dataclasses.dataclass(frozen=True)
class Param:
    """One tunable parameter.

    kind:
      "float"     continuous in [low, high]
      "log_float" continuous, log-uniform in [low, high]
      "int"       integer in [low, high] (uniform)
      "grid"      one of `choices` (ordered numeric grid — encoded ordinally)
      "cat"       one of `choices` (unordered — encoded ordinally but decoded
                  by nearest bucket; small cardinalities only)
    """

    name: str
    kind: str
    low: float = 0.0
    high: float = 1.0
    choices: Tuple[Any, ...] = ()
    default: Any = None

    def __post_init__(self):
        if self.kind in ("grid", "cat") and not self.choices:
            raise ValueError(f"{self.name}: grid/cat parameter needs choices")
        if self.default is None:
            raise ValueError(f"{self.name}: default required")

    # --- unit-interval encode/decode -------------------------------------
    def encode(self, value: Any) -> float:
        if self.kind == "float":
            return float((value - self.low) / (self.high - self.low))
        if self.kind == "log_float":
            lo, hi = math.log(self.low), math.log(self.high)
            return float((math.log(value) - lo) / (hi - lo))
        if self.kind == "int":
            return float((value - self.low) / (self.high - self.low))
        if self.kind in ("grid", "cat"):
            try:
                idx = self.choices.index(value)
            except ValueError:
                # off-grid numeric observation (e.g. a hand-tuned serving
                # config re-anchored through retune): embed at the nearest
                # choice — the surrogate needs *some* cell for a measured
                # config it could never itself propose
                if not isinstance(value, (int, float)) or isinstance(value, bool):
                    raise
                numeric = [
                    (i, c)
                    for i, c in enumerate(self.choices)
                    if isinstance(c, (int, float)) and not isinstance(c, bool)
                ]
                if not numeric:
                    raise
                idx = min(numeric, key=lambda ic: abs(ic[1] - value))[0]
            return (idx + 0.5) / len(self.choices)
        raise ValueError(self.kind)

    def decode(self, u: float) -> Any:
        u = float(np.clip(u, 0.0, 1.0))
        if self.kind == "float":
            return self.low + u * (self.high - self.low)
        if self.kind == "log_float":
            lo, hi = math.log(self.low), math.log(self.high)
            return float(math.exp(lo + u * (hi - lo)))
        if self.kind == "int":
            return int(round(self.low + u * (self.high - self.low)))
        if self.kind in ("grid", "cat"):
            idx = min(int(u * len(self.choices)), len(self.choices) - 1)
            return self.choices[idx]
        raise ValueError(self.kind)


class SearchSpace:
    """Holistic VDMS search space: index type + per-type params + system params."""

    def __init__(
        self,
        index_types: Mapping[str, Sequence[Param]],
        system_params: Sequence[Param],
    ):
        self.index_types: Dict[str, Tuple[Param, ...]] = {
            t: tuple(ps) for t, ps in index_types.items()
        }
        self.type_names: Tuple[str, ...] = tuple(self.index_types)
        self.system_params: Tuple[Param, ...] = tuple(system_params)

        # Holistic layout: [type one-hot (T)] + [index params, per type, in
        # declaration order] + [system params]. Shared system params have one
        # copy; index params are namespaced "<type>.<name>" so e.g. IVF_FLAT
        # and IVF_PQ each own their `nlist` copy unless declared shared.
        self._cols: List[Tuple[str, Optional[str], Param]] = []  # (col, owner, p)
        for t, ps in self.index_types.items():
            for p in ps:
                self._cols.append((f"{t}.{p.name}", t, p))
        for p in self.system_params:
            self._cols.append((p.name, None, p))
        self.n_types = len(self.type_names)
        self.dims = self.n_types + len(self._cols)

    @classmethod
    def from_families(
        cls, families: Sequence[Any], system_params: Sequence[Param]
    ) -> "SearchSpace":
        """Registry-driven construction: each family object contributes its
        ``name`` and declared ``params`` (duck-typed, so any index-family
        registry can drive the space without this module knowing about it)."""
        return cls(
            index_types={f.name: tuple(f.params) for f in families},
            system_params=system_params,
        )

    def encoding_signature(self) -> str:
        """Stable digest of the encoded layout: type names, column order, and
        every parameter's kind/bounds/choices/default. Two spaces with equal
        signatures encode any config to bit-identical rows, so observations
        may be transferred between their tuners; fleet transfer refuses
        imports across differing signatures."""
        payload = {
            "types": list(self.type_names),
            "cols": [
                [col, owner, p.kind, p.low, p.high, [repr(c) for c in p.choices],
                 repr(p.default)]
                for col, owner, p in self._cols
            ],
        }
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def _require_type(self, index_type: str) -> str:
        if index_type not in self.index_types:
            raise ValueError(
                f"unknown index type {index_type!r}; registered families: "
                f"{sorted(self.index_types)}"
            )
        return index_type

    # ------------------------------------------------------------------
    def params_of(self, index_type: str) -> Tuple[Param, ...]:
        return self.index_types[self._require_type(index_type)] + self.system_params

    def default_config(self, index_type: str) -> Config:
        cfg: Config = {"index_type": index_type}
        for p in self.params_of(index_type):
            cfg[p.name] = p.default
        return cfg

    # --- encode / decode ---------------------------------------------------
    def encode(self, cfg: Config) -> np.ndarray:
        x = np.zeros(self.dims, dtype=np.float64)
        t = self._require_type(cfg["index_type"])
        x[self.type_names.index(t)] = 1.0
        for j, (col, owner, p) in enumerate(self._cols):
            if owner is None or owner == t:
                val = cfg.get(p.name, p.default)
            else:
                val = p.default  # non-owned index params pinned to default
            x[self.n_types + j] = p.encode(val)
        return x

    def decode(self, x: np.ndarray, index_type: Optional[str] = None) -> Config:
        x = np.asarray(x, dtype=np.float64)
        if index_type is None:
            index_type = self.type_names[int(np.argmax(x[: self.n_types]))]
        else:
            self._require_type(index_type)
        cfg: Config = {"index_type": index_type}
        for j, (col, owner, p) in enumerate(self._cols):
            if owner is None or owner == index_type:
                cfg[p.name] = p.decode(x[self.n_types + j])
        return cfg

    def free_mask(self, index_type: str) -> np.ndarray:
        """Boolean mask over dims that the acquisition may vary when polling
        `index_type` (its own index params + system params). The one-hot block
        and foreign index params stay fixed (paper §IV-C)."""
        self._require_type(index_type)
        m = np.zeros(self.dims, dtype=bool)
        for j, (col, owner, p) in enumerate(self._cols):
            if owner is None or owner == index_type:
                m[self.n_types + j] = True
        return m

    # --- bulk encoded candidates ------------------------------------------
    def owned_cols(self, index_type: str) -> List[int]:
        """Indices into ``self._cols`` of the parameters ``index_type`` owns
        (its index params, then the system params) — ``params_of()`` order."""
        self._require_type(index_type)
        own = [j for j, (col, owner, p) in enumerate(self._cols) if owner == index_type]
        sys = [j for j, (col, owner, p) in enumerate(self._cols) if owner is None]
        return own + sys

    def encoded_template(self, index_type: str) -> np.ndarray:
        """Encoded row with the type one-hot set and every parameter at its
        encoded default — the fixed part of any candidate of this type."""
        x = np.zeros(self.dims, dtype=np.float64)
        x[self.type_names.index(self._require_type(index_type))] = 1.0
        for j, (col, owner, p) in enumerate(self._cols):
            x[self.n_types + j] = p.encode(p.default)
        return x

    def sample_encoded(
        self, rng: np.random.Generator, n: int, index_type: str
    ) -> np.ndarray:
        """Bulk equivalent of ``sample(rng, n, index_type=...)`` returning raw
        encoded rows (n, dims). One C-order ``rng.random`` matrix consumes the
        generator identically to n sequential ``sample`` calls, and
        ``decode(row, index_type)`` reproduces each sampled config exactly."""
        cols = self.owned_cols(index_type)
        U = rng.random((n, len(cols)))
        X = np.tile(self.encoded_template(index_type), (n, 1))
        for k, j in enumerate(cols):
            X[:, self.n_types + j] = U[:, k]
        return X

    def snap_encoded(self, X: np.ndarray, index_type: str) -> np.ndarray:
        """Vectorized ``encode(decode(x))`` over the owned columns: the
        encoded matrix the GP sees after raw candidate rows are snapped to
        representable parameter values. Matches the scalar
        ``Param.encode``/``decode`` round-trip bit-for-bit per column."""
        X = np.array(X, dtype=np.float64, copy=True)
        for j, (col, owner, p) in enumerate(self._cols):
            if not (owner is None or owner == index_type):
                continue
            u = np.clip(X[:, self.n_types + j], 0.0, 1.0)
            if p.kind == "float":
                v = p.low + u * (p.high - p.low)
                s = (v - p.low) / (p.high - p.low)
            elif p.kind == "int":
                v = np.round(p.low + u * (p.high - p.low))
                s = (v - p.low) / (p.high - p.low)
            elif p.kind in ("grid", "cat"):
                nc = len(p.choices)
                idx = np.minimum((u * nc).astype(np.int64), nc - 1)
                s = (idx + 0.5) / nc
            else:  # log_float: math.log/exp differ from np.log/exp by ulps,
                # so round-trip through the scalar path to stay bit-exact
                s = np.array([p.encode(p.decode(float(ui))) for ui in u])
            X[:, self.n_types + j] = s
        return X

    # --- sampling ------------------------------------------------------------
    def sample(
        self, rng: np.random.Generator, n: int, index_type: Optional[str] = None
    ) -> List[Config]:
        if index_type is not None:
            self._require_type(index_type)
        out = []
        for i in range(n):
            t = index_type or self.type_names[int(rng.integers(self.n_types))]
            cfg: Config = {"index_type": t}
            for p in self.params_of(t):
                cfg[p.name] = p.decode(float(rng.random()))
            out.append(cfg)
        return out

    def lhs(self, rng: np.random.Generator, n: int) -> List[Config]:
        """Latin hypercube over the holistic space; index types cycled so every
        type appears (matches how the paper extends fixed-space baselines)."""
        d = len(self._cols)
        # stratified unit samples per column
        u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T + rng.random((n, d))) / n
        out = []
        for i in range(n):
            t = self.type_names[i % self.n_types]
            cfg: Config = {"index_type": t}
            for j, (col, owner, p) in enumerate(self._cols):
                if owner is None or owner == t:
                    cfg[p.name] = p.decode(u[i, j])
            out.append(cfg)
        return out

    def perturb(
        self, rng: np.random.Generator, cfg: Config, scale: float = 0.15
    ) -> Config:
        """Gaussian perturbation in encoded space, keeping the index type."""
        t = cfg["index_type"]
        x = self.encode(cfg)
        noise = rng.normal(0.0, scale, size=self.dims)
        x = np.clip(x + noise * self.free_mask(t), 0.0, 1.0)
        return self.decode(x, index_type=t)
