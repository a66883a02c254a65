"""Paper Fig. 8–10: ablations of the two VDTuner components, successive
abandon (against round-robin) and the NPI polling surrogate (against a
native GP on raw objectives); the twin of the JAX package's
``benchmarks/bench_ablation.py``.

All variants are plain ask/tell recommenders driven by the one
``TuningSession`` harness; the per-variant ``session`` block reports the
recommend/eval ledger (stable schema)."""
from __future__ import annotations

import time

import numpy as np

from ..core import TuningSession, VDTuner
from ..device import resolve_device
from ..vdms import make_space
from .common import N_ITERS, RECALL_FLOORS, emit, make_env


class VDTunerNoAbandon(VDTuner):
    """Round-robin polling: the abandon trigger never fires."""

    name = "vdtuner_rr"

    def __init__(self, *a, **kw):
        kw["abandon_window"] = 10**9
        super().__init__(*a, **kw)


class VDTunerNativeGP(VDTuner):
    """Native surrogate: GP trained on raw (max-normalized) objectives instead
    of the per-index-type NPI normalization."""

    name = "vdtuner_native"

    def ask(self, n: int = 1):
        import repro_torch.core.tuner as tuner_mod

        orig = tuner_mod.npi_normalize

        def raw_normalize(Y, types, mode="balanced"):
            ymax = Y.max(axis=0)
            ymax = np.where(ymax <= 0, 1.0, ymax)
            bases = {str(t): ymax for t in np.unique(types)}
            return Y / ymax[None, :], bases

        tuner_mod.npi_normalize = raw_normalize
        try:
            return super().ask(n)
        finally:
            tuner_mod.npi_normalize = orig


def run(seed: int = 0, dataset: str = "glove_like", n_iters: int = N_ITERS, device=None):
    device = resolve_device(device)
    space = make_space()
    env = make_env(dataset, seed=seed, device=device)
    out = {}
    for name, cls in (
        ("vdtuner", VDTuner),
        ("round_robin", VDTunerNoAbandon),
        ("native_gp", VDTunerNativeGP),
    ):
        t = cls(space, env, seed=seed, device=device)
        session = TuningSession(t)
        t0 = time.perf_counter()
        session.run(n_iters)
        wall = time.perf_counter() - t0
        floors = {r: t.best_speed_at_recall(r) for r in RECALL_FLOORS}
        out[name] = {
            "speed_at_floor": floors,
            "abandoned": list(getattr(t.abandon, "abandoned", [])),
            "score_log_len": len(t.abandon.score_log),
            "session": session.ledger_dict(),
        }
        emit(
            f"ablation/{dataset}/{name}", wall * 1e6 / n_iters,
            ";".join(f"r{r}={floors[r]:.0f}" if np.isfinite(floors[r]) else f"r{r}=nan"
                     for r in (0.85, 0.95, 0.99)),
        )
    return out


if __name__ == "__main__":
    print(run())
