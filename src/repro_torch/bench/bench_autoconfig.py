"""Paper Table IV + Table V: improvement of VDTuner over the Default setting,
and the chosen index/parameters per dataset (the twin of the JAX package's
``benchmarks/bench_autoconfig.py``).

The search space is registry-derived and includes the public-hook
``IVF_PQR`` family; each row records whether it reached the Pareto front.
``index_types=`` (or ``--index-types`` on ``repro_torch.bench.run``)
restricts the run to a comma-listed subset of registered families.
"""
from __future__ import annotations

import numpy as np

from ..vdms import ivf_pqr, make_space, registered_names, unregister_family
from .common import DATASETS, N_ITERS, emit, make_env, run_method


def best_without_sacrifice(tuner, default_y):
    """Paper's metric: max speed (recall) improvement without sacrificing the
    other objective relative to the default configuration."""
    Y = tuner.Y
    spd_ok = Y[Y[:, 1] >= default_y[1] - 1e-9]
    rec_ok = Y[Y[:, 0] >= default_y[0] - 1e-9]
    spd_imp = (spd_ok[:, 0].max() / default_y[0] - 1) * 100 if len(spd_ok) else float("nan")
    rec_imp = (rec_ok[:, 1].max() / default_y[1] - 1) * 100 if len(rec_ok) else float("nan")
    return spd_imp, rec_imp


def run(seed: int = 0, index_types=None, n_iters: int = N_ITERS, device=None):
    # IVF_PQR joins this suite's space only: scope the registration so later
    # suites in the same process (repro_torch.bench.run) keep the default registry
    added_pqr = ivf_pqr.FAMILY.name not in registered_names()
    if added_pqr:
        ivf_pqr.register()
    try:
        return _run(seed=seed, index_types=index_types, n_iters=n_iters, device=device)
    finally:
        if added_pqr:
            unregister_family(ivf_pqr.FAMILY.name)


def _run(seed, index_types, n_iters, device):
    space = make_space(include=index_types)
    rows = {}
    for ds in DATASETS:
        env = make_env(ds, seed=seed, device=device)
        default = env(make_space().default_config("AUTOINDEX"))
        default_y = np.array([default["speed"], default["recall"]])
        tuner, wall, _session = run_method("vdtuner", env, space, n_iters, seed=seed,
                                           device=device)
        spd_imp, rec_imp = best_without_sacrifice(tuner, default_y)
        best = max(
            (o for o in tuner.history if not o.failed),
            key=lambda o: o.y[0] * (o.y[1] >= default_y[1]),
        )
        front_types = sorted({c["index_type"] for c in tuner.pareto_configs()})
        pqr_on_front = "IVF_PQR" in front_types
        rows[ds] = dict(
            speed_improvement_pct=spd_imp, recall_improvement_pct=rec_imp,
            best_index=best.index_type,
            best_config={k: v for k, v in best.config.items()
                         if k in ("nlist", "nprobe", "m", "nbits", "M",
                                  "efConstruction", "ef", "reorder_k")},
            pareto_index_types=front_types,
            ivf_pqr_on_front=pqr_on_front,
            wall_s=wall,
        )
        emit(
            f"autoconfig/{ds}", wall * 1e6 / n_iters,
            f"speed_imp={spd_imp:.1f}%;recall_imp={rec_imp:.1f}%;"
            f"best={best.index_type};pqr_on_front={int(pqr_on_front)}",
        )
    return rows


if __name__ == "__main__":
    print(run())
