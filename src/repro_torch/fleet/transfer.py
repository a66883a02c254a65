"""Cross-tenant prior transfer of the port (the counterpart of the JAX
package's ``fleet/transfer.py``): seed a new tenant's GP from similar tenants.

The policy (ML-Powered Index Tuning survey, §"workload similarity"): rank the
fleet's other tenants by embedding similarity to the target, take the top-K
above a floor, and import a capped selection of each source's observations —
its Pareto front first, then best knee-score fill — as §IV-F-style *bootstrap*
entries with per-source noise inflation (``noise_scale = base / similarity``,
clipped), so a near-identical tenant's measurements are trusted almost like
local ones while a marginal match merely biases the prior. Imports are gated
on :meth:`SearchSpace.encoding_signature` equality — the registry's uniform
encoding is what lets an encoded row decode to the same configuration across
tenants, and transfer refuses to run without it.

Safeguards (transfer must never end up worse than cold start):

* **No-source fallback** — when no tenant clears ``min_similarity`` the plan
  is empty and the target session is untouched: its RNG, warm-up schedule and
  every subsequent decision are *bit-identical* to a cold start.
* **Divergence guard** — after ``check_after`` fresh local evaluations, a GP
  fitted on the imported rows alone predicts the fresh measurements; when the
  median standardized error exceeds ``divergence_threshold`` the imports are
  purged from the history (:func:`purge_imports`), returning the surrogate to
  locally-measured data only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.gp import GP
from ..core.pareto import non_dominated_mask
from ..core.session import TuningSession
from ..core.tuner import Observation

from .descriptor import DescriptorEmbedding, WorkloadDescriptor


@dataclasses.dataclass(frozen=True)
class TransferPolicy:
    """Knobs for cross-tenant observation transfer."""

    k_sources: int = 2  # at most this many source tenants
    min_similarity: float = 0.25  # sources below this never transfer
    max_import_per_source: int = 12  # observation cap per source
    noise_base: float = 1.5  # inflation at similarity 1.0
    noise_ceil: float = 16.0  # inflation clip
    check_after: int = 4  # fresh evals before the divergence check
    divergence_threshold: float = 3.0  # median |err|/std_y gate

    def __post_init__(self):
        if self.k_sources < 1:
            raise ValueError(f"k_sources must be >= 1, got {self.k_sources}")
        if not 0.0 <= self.min_similarity <= 1.0:
            raise ValueError(f"min_similarity must be in [0, 1], got {self.min_similarity}")
        if self.max_import_per_source < 1:
            raise ValueError("max_import_per_source must be >= 1")
        if self.noise_base < 1.0 or self.noise_ceil < self.noise_base:
            raise ValueError("need noise_ceil >= noise_base >= 1")
        if self.check_after < 1 or self.divergence_threshold <= 0:
            raise ValueError("need check_after >= 1 and divergence_threshold > 0")

    def noise_for(self, similarity: float) -> float:
        """Per-source GP noise-variance inflation: trust decays with
        dissimilarity, clipped to [noise_base, noise_ceil]."""
        return float(np.clip(self.noise_base / max(similarity, 1e-6), self.noise_base, self.noise_ceil))


@dataclasses.dataclass
class TransferReport:
    """What a warm-start actually did (rides in the fleet ledger)."""

    target: str
    sources: List[Dict[str, Any]]  # [{"name", "similarity", "noise_scale", "n_imported"}]
    n_imported: int
    fallback: bool  # True = no source cleared the similarity floor

    def to_dict(self) -> Dict[str, Any]:
        return {
            "target": self.target,
            "sources": [dict(s) for s in self.sources],
            "n_imported": int(self.n_imported),
            "fallback": bool(self.fallback),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransferReport":
        return cls(
            target=str(d["target"]),
            sources=[dict(s) for s in d["sources"]],
            n_imported=int(d["n_imported"]),
            fallback=bool(d["fallback"]),
        )


def rank_sources(
    embedding: DescriptorEmbedding,
    target: WorkloadDescriptor,
    candidates: Sequence[Tuple[str, WorkloadDescriptor]],
    policy: TransferPolicy,
    target_summary: Optional[np.ndarray] = None,
    candidate_summaries: Optional[Dict[str, np.ndarray]] = None,
) -> List[Tuple[str, float]]:
    """Top-K candidate tenants by similarity, floor applied, deterministic
    tie-break by candidate order."""
    sims = []
    for i, (name, desc) in enumerate(candidates):
        s = embedding.similarity(
            target,
            desc,
            summary_a=target_summary,
            summary_b=(candidate_summaries or {}).get(name),
        )
        sims.append((name, float(s), i))
    sims = [t for t in sims if t[1] >= policy.min_similarity]
    sims.sort(key=lambda t: (-t[1], t[2]))
    return [(name, s) for name, s, _ in sims[: policy.k_sources]]


def _knee_order(obs: Sequence[Observation]) -> List[int]:
    """Indices of ``obs`` by descending knee score (normalized objective sum),
    the same balance heuristic the tuners' deploy pool uses."""
    Y = np.stack([np.asarray(o.y, np.float64) for o in obs])
    span = Y.max(axis=0) - Y.min(axis=0)
    span = np.where(span > 1e-12, span, 1.0)
    Yn = (Y - Y.min(axis=0)) / span
    score = Yn.sum(axis=1)
    return list(np.argsort(-score, kind="stable"))


def select_observations(history: Sequence[Observation], n: int) -> List[Observation]:
    """The rows worth exporting from a source ledger: non-dominated fresh
    observations first (by knee score), then best-knee fill — capped at ``n``,
    deterministic, failures excluded."""
    ok = [o for o in history if not o.failed and not o.bootstrap]
    if not ok:
        return []
    Y = np.stack([np.asarray(o.y, np.float64) for o in ok])
    nd = non_dominated_mask(Y)
    front = [o for o, keep in zip(ok, nd) if keep]
    rest = [o for o, keep in zip(ok, nd) if not keep]
    picked = [front[i] for i in _knee_order(front)] if front else []
    if len(picked) < n and rest:
        picked += [rest[i] for i in _knee_order(rest)]
    return picked[:n]


def apply_transfer(
    session: TuningSession,
    target: str,
    ranked: Sequence[Tuple[str, float]],
    source_histories: Dict[str, Sequence[Observation]],
    policy: TransferPolicy,
    source_signatures: Optional[Dict[str, str]] = None,
) -> TransferReport:
    """Import the ranked sources' best observations into ``session``.

    ``source_signatures`` maps source name -> its space's
    ``encoding_signature()``; mismatches raise (the cross-tenant encoding
    guard). An empty ``ranked`` produces the cold-start fallback report and
    leaves the session untouched.
    """
    if not ranked:
        return TransferReport(target=target, sources=[], n_imported=0, fallback=True)
    own_sig = session.tuner.space.encoding_signature()
    sources, total = [], 0
    for name, sim in ranked:
        sig = (source_signatures or {}).get(name, own_sig)
        if sig != own_sig:
            raise ValueError(
                f"transfer {name!r} -> {target!r} refused: encoding signature "
                f"{sig!r} != {own_sig!r}"
            )
        picked = select_observations(source_histories.get(name, []), policy.max_import_per_source)
        scale = policy.noise_for(sim)
        n_imp = session.import_observations(picked, noise_scale=scale, space_signature=sig)
        sources.append(
            {"name": name, "similarity": float(sim), "noise_scale": scale, "n_imported": n_imp}
        )
        total += n_imp
    return TransferReport(target=target, sources=sources, n_imported=total, fallback=total == 0)


def divergence_score(session: TuningSession, policy: TransferPolicy) -> Optional[float]:
    """Median standardized error of a GP fitted on the *imported* rows alone
    predicting the tenant's *fresh* measurements — None until ``check_after``
    fresh observations exist (or when there is nothing imported). The GP
    runs on the tenant tuner's device."""
    imported = [o for o in session.history if o.bootstrap and o.noise_scale != 1.0]
    fresh = [o for o in session.history if not o.bootstrap and not o.failed]
    if not imported or len(fresh) < policy.check_after:
        return None
    space = session.tuner.space
    Xi = np.stack([space.encode(o.config) for o in imported])
    Yi = np.stack([np.asarray(o.y, np.float64) for o in imported])
    Xf = np.stack([space.encode(o.config) for o in fresh])
    Yf = np.stack([np.asarray(o.y, np.float64) for o in fresh])
    gp = GP(seed=0, fit_steps=60, device=getattr(session.tuner, "device", None)).fit(Xi, Yi)
    mean, _ = gp.predict(Xf)
    std = Yi.std(axis=0) + 1e-9
    err = np.abs(mean - Yf) / std[None, :]
    return float(np.median(err.max(axis=1)))


def purge_imports(session: TuningSession) -> int:
    """Drop transfer-imported rows (bootstrap entries with inflated noise)
    from the tuner history, re-numbering iterations; returns how many went."""
    hist = session.tuner.history
    kept = [o for o in hist if not (o.bootstrap and o.noise_scale != 1.0)]
    purged = len(hist) - len(kept)
    for i, o in enumerate(kept):
        o.iteration = i
    session.tuner.history = kept
    return purged


def check_divergence(session: TuningSession, policy: TransferPolicy) -> Optional[bool]:
    """Run the divergence guard once: None = not enough evidence yet,
    False = imports consistent, True = imports purged."""
    score = divergence_score(session, policy)
    if score is None:
        return None
    if score <= policy.divergence_threshold:
        return False
    purge_imports(session)
    return True
