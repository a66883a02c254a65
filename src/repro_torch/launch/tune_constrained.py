"""User-preference tuning on the port: maximize QPS subject to a recall
floor, then bootstrap a second session with a tighter floor from the first
session's data (paper §IV-F; the twin of the JAX package's
``examples/tune_constrained.py``, at its sizes).

The recall floor is a first-class objective (``core.objectives.recall_floor``):
the spec carries the constraint and VDTuner switches to constrained EI.
keyword_like data (6,144 vectors, 128 queries), analytic mode; 25 rounds at
recall >= 0.85, then 20 at recall >= 0.92 bootstrapped from them. The GP,
the acquisition and every search run on the GPU unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.tune_constrained --device cpu
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Tuple

from ..core import TuningSession, VDTuner, recall_floor
from ..device import resolve_device
from ..vdms import VDMSTuningEnv, make_dataset, make_space

ROUNDS = (25, 20)
FLOORS = (0.85, 0.92)


def run(device=None, draws=None, rounds: Tuple[int, int] = ROUNDS) -> Dict[str, Any]:
    """Both sessions, of ``rounds`` observations each; ``draws`` is the class
    of the build draws (default ``BuildDraws``). Returns the two tuners, the
    backend and the fresh samples of the second session that met its
    floor."""
    device = resolve_device(device)
    ds = make_dataset("keyword_like", n=6144, n_queries=128, k=10, seed=1, device=device)
    env = VDMSTuningEnv(ds, mode="analytic", seed=1, device=device, draws=draws)
    space = make_space()

    print(f"== phase 1: recall >= {FLOORS[0]} (constraint EI) ==")
    t1 = VDTuner(space, seed=1, objective_spec=recall_floor(FLOORS[0]), device=device)
    TuningSession(t1, backend=env).run(rounds[0])
    print(f"   best qps @ recall>={FLOORS[0]}: {t1.best_speed_at_recall(FLOORS[0]):.0f}")

    print(f"== phase 2: recall >= {FLOORS[1]}, bootstrapped from phase 1 ==")
    t2 = VDTuner(space, seed=2, objective_spec=recall_floor(FLOORS[1]),
                 bootstrap_history=t1.history, device=device)
    TuningSession(t2, backend=env).run(rounds[1])
    print(f"   best qps @ recall>={FLOORS[1]}: {t2.best_speed_at_recall(FLOORS[1]):.0f}")

    fresh = [o for o in t2.history if not o.bootstrap]
    feasible = sum(1 for o in fresh if o.y[1] >= FLOORS[1])
    print(f"   {feasible}/{len(fresh)} fresh samples were feasible — the constraint "
          f"model concentrates search inside the feasible region")
    return dict(phase1=t1, phase2=t2, env=env, feasible=feasible, fresh=len(fresh))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
