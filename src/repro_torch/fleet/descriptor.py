"""Workload descriptors of the port (the counterpart of the JAX package's
``fleet/descriptor.py``): the fleet's notion of "these two tenants look alike".

A :class:`WorkloadDescriptor` is a fixed-length vector of workload statistics
computed from a tenant's dataset or :class:`~repro_torch.vdms.workload.WorkloadTrace`
— dimensionality, corpus size, arrival mix, a drift statistic, and query-shape
moments that separate the Table-III dataset families (a keyword-style sparse
corpus and a GloVe-style dense one have very different coordinate kurtosis).

Similarity between tenants is measured in a learned low-dimensional space, the
LatentTune idea: :class:`DescriptorEmbedding` standardizes the descriptor
features (optionally concatenated with a summary of each tenant's good
configurations, encoded through the registry's uniform
:meth:`~repro_torch.core.space.SearchSpace.encode`), projects onto the top principal
components of the fitted fleet, and scores ``exp(-||ea - eb||^2 / 2s^2)`` with
an *absolute* length scale ``s`` in :data:`FEATURE_SCALES` units — a fleet of
near-identical tenants scores all-high similarities instead of being forced
into a spread. Everything is deterministic and JSON-serializable, so
embeddings ride inside fleet checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Descriptor feature names, in vector order. ``feature_table()`` renders the
#: documented schema from this single source of truth (doc-sync-tested).
FEATURES: Tuple[Tuple[str, str], ...] = (
    ("log_corpus", "log10 of total corpus size (base + inserts)"),
    ("log_dim", "log10 of vector dimensionality"),
    ("log_k", "log10 of the trace's top-k"),
    ("insert_frac", "fraction of trace operations that are inserts"),
    ("search_frac", "fraction of trace operations that are searches"),
    ("delete_frac", "fraction of trace operations that are deletes"),
    ("drift", "L2 shift of the mean query between trace halves"),
    ("dispersion", "mean distance of queries from their centroid"),
    ("centroid_align", "mean cosine of queries against the base centroid"),
    ("coord_kurtosis", "dim-scaled 4th moment of query coordinates (sparsity)"),
)

FEATURE_NAMES: Tuple[str, ...] = tuple(name for name, _ in FEATURES)

#: Characteristic scale per feature: the difference that counts as "one unit"
#: of workload dissimilarity. Fixed a priori (not fitted) so that seed-level
#: noise in a small fleet — e.g. ±0.05 arrival-mix jitter between two tenants
#: of the same family — is not amplified to the same footing as a genuine
#: family difference, the failure mode of per-feature z-scoring when the
#: fitted fleet is only a handful of tenants.
FEATURE_SCALES: Dict[str, float] = {
    "log_corpus": 1.0,  # a decade of corpus size
    "log_dim": 0.5,
    "log_k": 0.5,
    "insert_frac": 0.25,
    "search_frac": 0.25,
    "delete_frac": 0.25,
    "drift": 0.25,
    "dispersion": 0.1,
    "centroid_align": 0.25,
    "coord_kurtosis": 2.0,  # dense isotropic ~3; sparse corpora run 8+
}


def feature_table() -> str:
    """Markdown table of the descriptor schema (the JAX package's
    ``docs/FLEET.md`` embeds the same table)."""
    lines = ["| feature | meaning |", "| --- | --- |"]
    for name, desc in FEATURES:
        lines.append(f"| `{name}` | {desc} |")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class WorkloadDescriptor:
    """Fixed-length workload fingerprint for one tenant."""

    name: str
    features: Dict[str, float]

    def __post_init__(self):
        missing = [n for n in FEATURE_NAMES if n not in self.features]
        if missing:
            raise ValueError(f"descriptor {self.name!r} missing features {missing}")

    def vector(self) -> np.ndarray:
        return np.array([self.features[n] for n in FEATURE_NAMES], np.float64)

    # --- serialization (JSON-compatible) --------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "features": {k: float(v) for k, v in self.features.items()}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadDescriptor":
        return cls(name=str(d["name"]), features={k: float(v) for k, v in d["features"].items()})


def _query_moments(queries: np.ndarray, base: np.ndarray) -> Dict[str, float]:
    if queries.shape[0] == 0:
        return {"drift": 0.0, "dispersion": 0.0, "centroid_align": 0.0, "coord_kurtosis": 0.0}
    q = np.asarray(queries, np.float64)
    centroid = q.mean(axis=0)
    half = q.shape[0] // 2
    drift = float(np.linalg.norm(q[half:].mean(axis=0) - q[:half].mean(axis=0))) if half else 0.0
    dispersion = float(np.linalg.norm(q - centroid, axis=1).mean())
    if base.shape[0]:
        c = np.asarray(base, np.float64).mean(axis=0)
        c = c / (np.linalg.norm(c) + 1e-12)
        align = float((q @ c).mean())
    else:
        align = 0.0
    # vectors are L2-normalized, so E[x^4] * d^2 is ~3 + excess kurtosis for a
    # dense isotropic corpus and grows with coordinate sparsity
    kurt = float(np.mean(q**4) * q.shape[1] ** 2)
    return {
        "drift": drift,
        "dispersion": dispersion,
        "centroid_align": align,
        "coord_kurtosis": kurt,
    }


def describe_trace(trace, name: Optional[str] = None) -> WorkloadDescriptor:
    """Descriptor from a :class:`~repro_torch.vdms.workload.WorkloadTrace`."""
    from ..vdms.workload import OP_DELETE, OP_INSERT, OP_SEARCH

    n_ops = max(trace.n_ops, 1)
    features = {
        "log_corpus": float(np.log10(max(trace.capacity, 1))),
        "log_dim": float(np.log10(max(trace.dim, 1))),
        "log_k": float(np.log10(max(trace.k, 1))),
        "insert_frac": float(np.sum(trace.kinds == OP_INSERT)) / n_ops,
        "search_frac": float(np.sum(trace.kinds == OP_SEARCH)) / n_ops,
        "delete_frac": float(np.sum(trace.kinds == OP_DELETE)) / n_ops,
    }
    features.update(_query_moments(trace.queries, trace.base))
    return WorkloadDescriptor(name=name or trace.name, features=features)


def describe_dataset(dataset, name: Optional[str] = None) -> WorkloadDescriptor:
    """Descriptor from a static :class:`~repro_torch.vdms.datasets.VectorDataset`
    (pure-search arrival mix, no drift axis)."""
    features = {
        "log_corpus": float(np.log10(max(dataset.n, 1))),
        "log_dim": float(np.log10(max(dataset.dim, 1))),
        "log_k": float(np.log10(max(dataset.k, 1))),
        "insert_frac": 0.0,
        "search_frac": 1.0,
        "delete_frac": 0.0,
    }
    features.update(_query_moments(dataset.queries, dataset.data))
    return WorkloadDescriptor(name=name or dataset.name, features=features)


def describe_env(env, name: Optional[str] = None) -> WorkloadDescriptor:
    """Descriptor from a :class:`~repro_torch.vdms.tuning_env.VDMSTuningEnv`'s
    current workload view (the active phase for streaming tenants)."""
    kind, w = env.current_workload()
    if kind == "streaming":
        return describe_trace(w, name=name)
    return describe_dataset(w, name=name)


def config_summary(space, observations) -> Optional[np.ndarray]:
    """Mean encoded row of a tenant's non-dominated fresh configurations —
    the "which configs worked here" half of the LatentTune embedding input.
    Returns None when the tenant has no usable history yet."""
    from ..core.pareto import non_dominated_mask

    ok = [o for o in observations if not o.failed]
    if not ok:
        return None
    Y = np.stack([np.asarray(o.y, np.float64) for o in ok])
    nd = non_dominated_mask(Y)
    rows = [space.encode(o.config) for o, keep in zip(ok, nd) if keep]
    return np.mean(np.stack(rows), axis=0)


class DescriptorEmbedding:
    """Deterministic PCA embedding over scaled descriptor (+ optional
    config-summary) features, with a Gaussian-kernel similarity in [0, 1].

    Features are centered on the fitted fleet and divided by the fixed
    :data:`FEATURE_SCALES` (see its note on why fleet-std z-scoring is the
    wrong normalization for small fleets) before the PCA projection. Fit on
    the whole fleet's descriptors; ``similarity(a, b)`` then compares two
    tenants in the learned space. With fewer samples than components the
    rank is truncated automatically (PCA of a 2-tenant fleet is the line
    through both). State round-trips through JSON for fleet checkpoints.
    """

    def __init__(
        self, n_components: int = 4, config_weight: float = 0.5, length_scale: float = 1.0
    ):
        if n_components < 1:
            raise ValueError(f"n_components must be >= 1, got {n_components}")
        if length_scale <= 0:
            raise ValueError(f"length_scale must be > 0, got {length_scale}")
        self.n_components = int(n_components)
        self.config_weight = float(config_weight)
        self._mean: Optional[np.ndarray] = None
        self._std: Optional[np.ndarray] = None
        self._components: Optional[np.ndarray] = None  # (k, d)
        # absolute similarity length scale, in FEATURE_SCALES units: tenants
        # one characteristic unit apart score exp(-0.5) ~ 0.61; a family gap
        # of ~3 units lands near zero. Deliberately NOT fitted to the fleet —
        # a fleet of near-identical tenants should see all-high similarities,
        # not a forced spread.
        self._scale: float = float(length_scale)

    @property
    def fitted(self) -> bool:
        return self._components is not None

    def _feature_row(
        self, desc: WorkloadDescriptor, summary: Optional[np.ndarray], d_cfg: int
    ) -> np.ndarray:
        cfg = np.zeros(d_cfg, np.float64)
        if summary is not None:
            cfg[: summary.shape[0]] = self.config_weight * np.asarray(summary, np.float64)
        return np.concatenate([desc.vector(), cfg])

    def fit(
        self,
        descriptors: Sequence[WorkloadDescriptor],
        config_summaries: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> "DescriptorEmbedding":
        if not descriptors:
            raise ValueError("need at least one descriptor to fit")
        summaries: List[Optional[np.ndarray]] = (
            list(config_summaries) if config_summaries is not None else [None] * len(descriptors)
        )
        if len(summaries) != len(descriptors):
            raise ValueError("config_summaries must align with descriptors")
        d_cfg = max((s.shape[0] for s in summaries if s is not None), default=0)
        X = np.stack([self._feature_row(d, s, d_cfg) for d, s in zip(descriptors, summaries)])
        self._mean = X.mean(axis=0)
        # fixed characteristic scales for descriptor features (see
        # FEATURE_SCALES); config-summary dims are already unit-interval
        self._std = np.concatenate(
            [
                np.array([FEATURE_SCALES[n] for n in FEATURE_NAMES], np.float64),
                np.ones(d_cfg, np.float64),
            ]
        )
        Xs = (X - self._mean) / self._std
        k = min(self.n_components, Xs.shape[1], max(Xs.shape[0] - 1, 1))
        # SVD sign convention: force each component's largest-|loading|
        # coordinate positive so the embedding is unique and deterministic
        _, _, vt = np.linalg.svd(Xs, full_matrices=False)
        comps = vt[:k]
        for i in range(comps.shape[0]):
            j = int(np.argmax(np.abs(comps[i])))
            if comps[i, j] < 0:
                comps[i] = -comps[i]
        self._components = comps
        return self

    def embed(
        self, desc: WorkloadDescriptor, summary: Optional[np.ndarray] = None
    ) -> np.ndarray:
        if not self.fitted:
            raise ValueError("fit() the embedding before embedding descriptors")
        d_cfg = self._mean.shape[0] - len(FEATURE_NAMES)
        row = self._feature_row(desc, summary, d_cfg)
        return (row - self._mean) / self._std @ self._components.T

    def similarity(
        self,
        a: WorkloadDescriptor,
        b: WorkloadDescriptor,
        summary_a: Optional[np.ndarray] = None,
        summary_b: Optional[np.ndarray] = None,
    ) -> float:
        ea, eb = self.embed(a, summary_a), self.embed(b, summary_b)
        d2 = float(np.sum((ea - eb) ** 2))
        return float(np.exp(-0.5 * d2 / self._scale**2))

    # --- serialization (JSON-compatible; exact f64 round-trip) ----------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "n_components": self.n_components,
            "config_weight": self.config_weight,
            "mean": self._mean.tolist() if self._mean is not None else None,
            "std": self._std.tolist() if self._std is not None else None,
            "components": (
                [row.tolist() for row in self._components]
                if self._components is not None
                else None
            ),
            "scale": float(self._scale),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "DescriptorEmbedding":
        self.n_components = int(state["n_components"])
        self.config_weight = float(state["config_weight"])
        self._mean = np.asarray(state["mean"], np.float64) if state["mean"] is not None else None
        self._std = np.asarray(state["std"], np.float64) if state["std"] is not None else None
        self._components = (
            np.asarray(state["components"], np.float64)
            if state["components"] is not None
            else None
        )
        self._scale = float(state["scale"])
        return self
