"""`FleetSession`: N per-tenant tuning sessions under one evaluation budget
(the counterpart of the JAX package's ``fleet/fleet.py``).

The paper tunes one collection; a production fleet tunes many at once, and
the scarce resource is *evaluation seconds* (index builds + trace replays
dwarf recommend time by >100x on the measured benches). The fleet loop is:

    while budget remains and any tenant wants observations:
        tenant  = scheduler.pick(runnable tenants)
        round   = tenant.session.run_round()        # one ask + drain
        cost    = sum of the round's evaluation cost (analytic seconds)
        budget.charge(cost); scheduler.update(tenant, hv_gain, cost)

Two scheduler policies ship: ``"round_robin"`` (the fairness baseline) and
``"gain_per_cost"`` — a decayed empirical estimate of hypervolume gain per
eval-second, optimistic for never-run tenants, which is the practical proxy
for the EHVI-per-cost allocation rule (the acquisition's own expected-gain
signal is only comparable *within* a tenant; realized HV gain per second is
comparable across tenants and needs no extra surrogate evaluations).

Evaluation cost is charged from the *analytic* cost model when the raw
result carries build/search timings (deterministic, so CI gates and resumed
runs charge identical budgets) and falls back to measured wall time.

The fleet ledger is schema-versioned JSON; ``state_dict()``/``restore()``
round-trip mid-round bit-identically — scheduler state, shared budget, every
tenant's session (pending queues included), transfer reports and the fitted
embedding all ride along. Serving integration: ``outcome_hook(name)`` returns
a callback for :class:`~repro_torch.serving.controller.ServingController` so a
promote/rollback on any tenant's serving plane lands in that tenant's fleet
ledger (and optionally its GP, via the controller's own ``canary_feedback``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.hypervolume import hv_2d
from ..core.pareto import pareto_front
from ..core.session import TuningSession
from ..core.tuner import Observation

from .descriptor import DescriptorEmbedding, WorkloadDescriptor, config_summary
from .transfer import (
    TransferPolicy,
    TransferReport,
    apply_transfer,
    check_divergence,
    rank_sources,
)

FLEET_STATE_VERSION = 1
FLEET_LEDGER_SCHEMA = 1


def analytic_eval_cost(obs: Observation) -> float:
    """Eval-seconds one observation cost the fleet.

    Prefers the *modeled* timings in the raw result (``seal_build_s`` +
    ``search_s`` — the analytic cost model's replay seconds), falling back
    to measured wall time. ``build_time`` is deliberately excluded: even in
    analytic mode it is the wall-clock time of running the simulated build,
    so including it would make budget charges differ across runs — and the
    fleet's CI gates compare charge trajectories for exact equality.
    """
    raw = obs.raw or {}
    cost = 0.0
    for key in ("seal_build_s", "search_s"):
        if key in raw:
            cost += float(raw[key])
    if cost > 0.0:
        return cost
    return float(obs.eval_time)


class FleetBudget:
    """Shared eval-second budget across every tenant in the fleet."""

    def __init__(self, total_s: float):
        if total_s <= 0:
            raise ValueError(f"total_s must be > 0, got {total_s}")
        self.total_s = float(total_s)
        self.spent_s = 0.0

    def charge(self, seconds: float) -> None:
        self.spent_s += float(seconds)

    @property
    def remaining_s(self) -> float:
        return self.total_s - self.spent_s

    @property
    def exhausted(self) -> bool:
        return self.spent_s >= self.total_s

    def state_dict(self) -> Dict[str, Any]:
        return {"total_s": self.total_s, "spent_s": self.spent_s}

    def load_state_dict(self, state: Dict[str, Any]) -> "FleetBudget":
        self.total_s = float(state["total_s"])
        self.spent_s = float(state["spent_s"])
        return self


class FleetScheduler:
    """Budget allocator over runnable tenants.

    ``round_robin`` cycles a cursor over the tenant order. ``gain_per_cost``
    keeps an exponentially-decayed estimate of hypervolume gain per
    eval-second per tenant; never-run tenants are optimistic (picked first,
    in order), then the argmax estimate wins with deterministic first-in-order
    tie-break. Fully JSON-serializable.
    """

    POLICIES = ("round_robin", "gain_per_cost")

    def __init__(self, policy: str = "round_robin", decay: float = 0.5):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, got {policy!r}")
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.policy = policy
        self.decay = float(decay)
        self._cursor = 0
        self._est: Dict[str, float] = {}  # decayed gain per eval-second
        self._n: Dict[str, int] = {}  # rounds run per tenant

    def pick(self, order: Sequence[str], runnable: Sequence[str]) -> str:
        runnable_set = set(runnable)
        if not runnable_set:
            raise ValueError("no runnable tenants")
        if self.policy == "round_robin":
            for _ in range(len(order)):
                name = order[self._cursor % len(order)]
                self._cursor += 1
                if name in runnable_set:
                    return name
            raise ValueError("runnable tenants not in fleet order")
        # gain_per_cost: optimism for the unexplored, then argmax estimate
        never = [n for n in order if n in runnable_set and self._n.get(n, 0) == 0]
        if never:
            return never[0]
        best, best_g = None, -np.inf
        for n in order:
            if n not in runnable_set:
                continue
            g = self._est.get(n, 0.0)
            if g > best_g:
                best, best_g = n, g
        return best

    def update(self, name: str, hv_gain: float, cost_s: float) -> None:
        g = float(hv_gain) / max(float(cost_s), 1e-9)
        k = self._n.get(name, 0)
        self._est[name] = g if k == 0 else self.decay * self._est[name] + (1.0 - self.decay) * g
        self._n[name] = k + 1

    def state_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "decay": self.decay,
            "cursor": int(self._cursor),
            "est": {k: float(v) for k, v in self._est.items()},
            "n": {k: int(v) for k, v in self._n.items()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "FleetScheduler":
        self.policy = str(state["policy"])
        self.decay = float(state["decay"])
        self._cursor = int(state["cursor"])
        self._est = {k: float(v) for k, v in state["est"].items()}
        self._n = {k: int(v) for k, v in state["n"].items()}
        return self


class _Tenant:
    """Per-tenant fleet bookkeeping around one TuningSession."""

    def __init__(
        self,
        name: str,
        session: TuningSession,
        descriptor: WorkloadDescriptor,
        n_iters: int,
    ):
        self.name = name
        self.session = session
        self.descriptor = descriptor
        self.n_iters = int(n_iters)
        self.rounds: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []  # serving promote/rollback etc.
        self.charged_s = 0.0
        self.last_hv = 0.0
        self.transfer: Optional[TransferReport] = None
        self.divergence_checked = False

    @property
    def wants_more(self) -> bool:
        return self.session.n_observations < self.n_iters

    def hypervolume(self) -> float:
        """HV of the fresh (locally measured) front over the fixed (0, 0)
        reference — the per-tenant progress signal the scheduler compares."""
        fresh = [o for o in self.session.history if not o.bootstrap and not o.failed]
        if not fresh:
            return 0.0
        Y = np.stack([np.asarray(o.y, np.float64) for o in fresh])
        front = pareto_front(Y)
        front = front[(front > 0).all(axis=1)]
        if front.size == 0:
            return 0.0
        return float(hv_2d(front, np.zeros(2)))


class FleetSession:
    """Orchestrates N per-tenant :class:`TuningSession`s under one budget."""

    def __init__(
        self,
        budget: FleetBudget,
        scheduler: Any = "round_robin",
        transfer_policy: Optional[TransferPolicy] = None,
        embedding: Optional[DescriptorEmbedding] = None,
        cost_fn: Callable[[Observation], float] = analytic_eval_cost,
    ):
        self.budget = budget
        self.scheduler = (
            scheduler if isinstance(scheduler, FleetScheduler) else FleetScheduler(scheduler)
        )
        self.transfer_policy = transfer_policy
        self.embedding = embedding if embedding is not None else DescriptorEmbedding()
        self.cost_fn = cost_fn
        self._tenants: Dict[str, _Tenant] = {}
        self._order: List[str] = []

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def add_tenant(
        self,
        name: str,
        session: TuningSession,
        descriptor: WorkloadDescriptor,
        n_iters: int,
    ) -> None:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already in the fleet")
        self._tenants[name] = _Tenant(name, session, descriptor, n_iters)
        self._order.append(name)

    @property
    def tenant_names(self) -> List[str]:
        return list(self._order)

    def tenant(self, name: str) -> _Tenant:
        return self._tenants[name]

    def session_of(self, name: str) -> TuningSession:
        return self._tenants[name].session

    # ------------------------------------------------------------------
    # transfer warm-start
    # ------------------------------------------------------------------
    def warm_start(self, name: str) -> TransferReport:
        """Seed ``name``'s GP from the most similar tenants' ledgers.

        Must run before the tenant's first fresh observation (importing into
        a half-tuned session would corrupt the warm-up bookkeeping). With no
        transfer policy, or no source above the similarity floor, the tenant
        is left bit-identical to cold start and the report says so.
        """
        t = self._tenants[name]
        if t.session.n_observations > 0:
            raise ValueError(f"tenant {name!r} already has fresh observations")
        if t.transfer is not None:
            raise ValueError(f"tenant {name!r} was already warm-started")
        policy = self.transfer_policy
        sources = [
            (o, self._tenants[o])
            for o in self._order
            if o != name and any(not x.bootstrap and not x.failed for x in self._tenants[o].session.history)
        ]
        if policy is None or not sources:
            t.transfer = TransferReport(target=name, sources=[], n_imported=0, fallback=True)
            return t.transfer
        descs = [t.descriptor] + [s.descriptor for _, s in sources]
        summaries = [None] + [
            config_summary(s.session.tuner.space, s.session.history) for _, s in sources
        ]
        self.embedding.fit(descs, summaries)
        cand_summaries = {
            n: s for (n, _), s in zip(sources, summaries[1:]) if s is not None
        }
        ranked = rank_sources(
            self.embedding,
            t.descriptor,
            [(n, s.descriptor) for n, s in sources],
            policy,
            target_summary=None,
            candidate_summaries=cand_summaries,
        )
        t.transfer = apply_transfer(
            t.session,
            name,
            ranked,
            {n: s.session.history for n, s in sources},
            policy,
            {n: s.session.tuner.space.encoding_signature() for n, s in sources},
        )
        return t.transfer

    # ------------------------------------------------------------------
    # the shared-budget loop
    # ------------------------------------------------------------------
    def run(self, max_rounds: Optional[int] = None) -> "FleetSession":
        """Spend the shared budget: pick a tenant, run one round, charge its
        evaluation cost, update the scheduler with realized HV gain."""
        n_rounds = 0
        while not self.budget.exhausted:
            runnable = [n for n in self._order if self._tenants[n].wants_more]
            if not runnable:
                break
            if max_rounds is not None and n_rounds >= max_rounds:
                break
            name = self.scheduler.pick(self._order, runnable)
            self.run_tenant_round(name)
            n_rounds += 1
        return self

    def run_tenant_round(self, name: str) -> List[Observation]:
        """One scheduled round for one tenant (the loop body of :meth:`run`,
        public so callers can drive custom schedules)."""
        t = self._tenants[name]
        want = max(t.n_iters - t.session.n_observations, 1)
        new_obs = t.session.run_round(want)
        cost = float(sum(self.cost_fn(o) for o in new_obs if not o.bootstrap))
        hv = t.hypervolume()
        gain = hv - t.last_hv
        self.budget.charge(cost)
        self.scheduler.update(name, gain, cost)
        t.charged_s += cost
        t.rounds.append(
            {
                "round": len(t.rounds),
                "n_evals": sum(1 for o in new_obs if not o.bootstrap),
                "cost_s": cost,
                "hv": hv,
                "hv_gain": gain,
                "budget_spent_s": self.budget.spent_s,
            }
        )
        t.last_hv = hv
        if (
            self.transfer_policy is not None
            and t.transfer is not None
            and not t.transfer.fallback
            and not t.divergence_checked
        ):
            verdict = check_divergence(t.session, self.transfer_policy)
            if verdict is not None:
                t.divergence_checked = True
                if verdict:
                    t.events.append({"event": "transfer_purged", "round": len(t.rounds) - 1})
        return new_obs

    # ------------------------------------------------------------------
    # serving integration
    # ------------------------------------------------------------------
    def outcome_hook(self, name: str) -> Callable[[str, Dict[str, Any], Dict[str, float]], None]:
        """Callback for a tenant's :class:`ServingController` — promote and
        rollback outcomes land in that tenant's fleet ledger."""
        t = self._tenants[name]

        def hook(kind: str, config: Dict[str, Any], raw: Dict[str, float]) -> None:
            t.events.append(
                {
                    "event": str(kind),
                    "config": dict(config),
                    "raw": {k: float(v) for k, v in raw.items()},
                }
            )

        return hook

    # ------------------------------------------------------------------
    # ledger + checkpointing
    # ------------------------------------------------------------------
    def ledger_dict(self) -> Dict[str, Any]:
        """Schema-versioned fleet ledger: budget, scheduler, per-tenant
        rounds/events/transfer plus each session's own ledger block."""
        return {
            "schema": FLEET_LEDGER_SCHEMA,
            "budget": self.budget.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "tenants": {
                n: {
                    "descriptor": t.descriptor.to_dict(),
                    "n_iters": t.n_iters,
                    "charged_s": t.charged_s,
                    "hv": t.last_hv,
                    "rounds": copy.deepcopy(t.rounds),
                    "events": copy.deepcopy(t.events),
                    "transfer": t.transfer.to_dict() if t.transfer is not None else None,
                    "session": t.session.ledger_dict(),
                }
                for n, t in self._tenants.items()
            },
        }

    def state_dict(self) -> Dict[str, Any]:
        """JSON-compatible checkpoint of the whole fleet (bit-identical
        resume, mid-round included — per-tenant pending queues ride in each
        session's own state)."""
        return {
            "version": FLEET_STATE_VERSION,
            "order": list(self._order),
            "budget": self.budget.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "embedding": self.embedding.state_dict(),
            "tenants": {
                n: {
                    "descriptor": t.descriptor.to_dict(),
                    "n_iters": t.n_iters,
                    "charged_s": t.charged_s,
                    "last_hv": t.last_hv,
                    "rounds": copy.deepcopy(t.rounds),
                    "events": copy.deepcopy(t.events),
                    "transfer": t.transfer.to_dict() if t.transfer is not None else None,
                    "divergence_checked": t.divergence_checked,
                    "session": t.session.state_dict(),
                }
                for n, t in self._tenants.items()
            },
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "FleetSession":
        """Restore onto a fleet whose tenants were re-added with freshly
        constructed sessions (same constructor args), mirroring
        :meth:`TuningSession.restore`."""
        version = state.get("version")
        if version != FLEET_STATE_VERSION:
            raise ValueError(f"unsupported fleet state version {version!r}")
        if list(state["order"]) != self._order:
            raise ValueError(
                f"fleet tenants {self._order} do not match checkpoint {state['order']}"
            )
        self.budget.load_state_dict(state["budget"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.embedding.load_state_dict(state["embedding"])
        for n, ts in state["tenants"].items():
            t = self._tenants[n]
            t.descriptor = WorkloadDescriptor.from_dict(ts["descriptor"])
            t.n_iters = int(ts["n_iters"])
            t.charged_s = float(ts["charged_s"])
            t.last_hv = float(ts["last_hv"])
            t.rounds = copy.deepcopy(ts["rounds"])
            t.events = copy.deepcopy(ts["events"])
            t.transfer = (
                TransferReport.from_dict(ts["transfer"]) if ts["transfer"] is not None else None
            )
            t.divergence_checked = bool(ts["divergence_checked"])
            t.session.load_state_dict(ts["session"])
        return self
