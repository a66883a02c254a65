"""Streaming tuning on the port: track a drifting workload with one
TuningSession (the twin of the JAX package's ``examples/tune_streaming.py``,
at its sizes).

A step-drift trace (2,048 base vectors, 900 operations; search-heavy to
insert-heavy, the vectors blending toward another distribution) is tuned in
its first phase (9 rounds, ``streaming_sustained``); the deployed incumbent
is then probed as the workload moves, and when the ``DriftDetector`` fires
the session re-enters BO for 8 rounds (stale measurements dropped, GP
hyperparameters warm, the deployed front re-anchored) and reports the
refreshed incumbent. Every replay (the live engine's search path and its
kernels), the GP and the acquisition run on the GPU unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.tune_streaming --device cpu
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

from ..core import DriftDetector, TuningSession, VDTuner, streaming_sustained
from ..device import resolve_device
from ..vdms import VDMSTuningEnv, make_space, make_trace

ROUNDS, RETUNE_ROUNDS = 9, 8


def brief(cfg):
    keys = ("index_type", "nprobe", "nlist", "segment_max_size", "graceful_time")
    return {k: (round(v, 3) if isinstance(v, float) else v) for k, v in cfg.items() if k in keys}


def run(device=None, draws=None) -> Dict[str, Any]:
    """The session; ``draws`` is the class of the build draws (default
    ``BuildDraws``). Returns the tuner, the backend, each phase's probe
    (``rel``, ``fired``), the incumbents in order and the final result."""
    device = resolve_device(device)
    trace = make_trace("glove_like", n_base=2048, n_ops=900, seed=0, drift="step",
                       mix=(0.05, 0.90, 0.05), mix_to=(0.60, 0.30, 0.10))
    env = VDMSTuningEnv(trace=trace, workload="streaming", mode="analytic", seed=0, n_phases=3,
                        device=device, draws=draws)
    spec = streaming_sustained()
    tuner = VDTuner(make_space(), env, seed=0, warm_start=True, objective_spec=spec,
                    device=device)
    session = TuningSession(tuner)
    session.run(ROUNDS)
    incumbent = tuner.best_config()
    incumbents = [incumbent]
    print(f"phase 0 incumbent: {brief(incumbent)}")

    detector = DriftDetector(metrics=("speed", "recall"), rel_threshold=0.12)
    session.probe_drift(detector, incumbent)  # phase-0 reference
    probes = []
    for phase in range(1, env.n_phases):
        env.set_phase(phase)
        fired = session.probe_drift(detector, incumbent)
        rel = detector.log[-1]["rel"]
        probes.append(dict(phase=phase, rel=rel, fired=fired))
        print(f"phase {phase}: probe drift rel={rel:.2f} fired={fired}")
        if fired:
            session.retune(RETUNE_ROUNDS, reanchor=tuner.pareto_configs(max_n=3))
            incumbent = tuner.best_config()
            incumbents.append(incumbent)
            detector.reset()
            session.probe_drift(detector, incumbent)
            print(f"  re-tuned incumbent: {brief(incumbent)}")
    raw = env(incumbent)
    print(f"final phase: sustained_qps={spec(raw)[0]:.0f} recall={raw['recall']:.3f} "
          f"(seals={raw['n_seals']:.0f}, evals={env.n_evals})")
    return dict(tuner=tuner, env=env, probes=probes, incumbents=incumbents, final=raw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
