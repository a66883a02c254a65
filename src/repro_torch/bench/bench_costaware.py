"""Paper Fig. 13: cost-effectiveness optimization, QP$ = QPS / (eta * GiB)
as the speed objective, compared with plain QPS optimization; the twin of
the JAX package's ``benchmarks/bench_costaware.py``."""
from __future__ import annotations

import time

import numpy as np

from ..core import VDTuner, cost_aware_transform
from ..device import resolve_device
from ..vdms import make_space
from .common import N_ITERS, emit, make_env


def run(seed: int = 0, dataset: str = "georadius_like", n_iters: int = N_ITERS, device=None):
    device = resolve_device(device)
    space = make_space()
    env = make_env(dataset, seed=seed, device=device)
    t0 = time.perf_counter()
    qps_opt = VDTuner(space, env, seed=seed, device=device).run(n_iters)
    w0 = time.perf_counter() - t0
    t0 = time.perf_counter()
    qpd_opt = VDTuner(space, env, seed=seed, transform=cost_aware_transform(1.0),
                      device=device).run(n_iters)
    w1 = time.perf_counter() - t0

    def stats(tuner):
        mems = np.array([o.raw.get("mem_gib", np.nan) for o in tuner.history if not o.failed])
        speeds = np.array([o.raw.get("speed", np.nan) for o in tuner.history if not o.failed])
        qpd = speeds / np.maximum(mems, 1e-9)
        return {
            "mem_mean": float(np.nanmean(mems)), "mem_std": float(np.nanstd(mems)),
            "best_qps": float(np.nanmax(speeds)), "best_qpd": float(np.nanmax(qpd)),
        }

    s_qps, s_qpd = stats(qps_opt), stats(qpd_opt)
    out = {"optimize_qps": s_qps, "optimize_qpd": s_qpd}
    emit("costaware/qps", w0 * 1e6 / n_iters,
         f"best_qps={s_qps['best_qps']:.0f};mem={s_qps['mem_mean']:.4f}GiB")
    emit("costaware/qpd", w1 * 1e6 / n_iters,
         f"best_qpd={s_qpd['best_qpd']:.0f};mem={s_qpd['mem_mean']:.4f}GiB;"
         f"qpd_gain={(s_qpd['best_qpd']/s_qps['best_qpd']-1)*100:.1f}%")
    return out


if __name__ == "__main__":
    print(run())
