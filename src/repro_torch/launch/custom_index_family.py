"""Extending the VDMS on the port: register a custom index family through
the public hook (the twin of the JAX package's
``examples/custom_index_family.py``, at its sizes).

One ``register_family`` call is the only integration step: the registry
then derives the search space (``make_space``), routes the engine's build,
search and seal dispatch, and the tuning session optimizes the new
family's parameters next to the built-ins. The worked example is the
DiskANN-style ``IVF_PQR`` family of ``repro_torch.vdms.ivf_pqr`` (PQ
candidate scan, then exact re-rank of ``reorder_k`` candidates): registered,
tuned against IVF_PQ and SCANN for 12 rounds on glove_like (3,072 vectors,
analytic mode), then a 1,024-base streaming trace of 300 operations
replayed through it. On the card IVF_PQR's candidate scan is the fused PQ
kernel at ``k = reorder_k``. Every build and search runs on the GPU unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.custom_index_family --device cpu

Exits 1 if the replay never sealed a segment or no tuned configuration
retrieved anything.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

from ..core import TuningSession, VDTuner, pareto_front
from ..device import resolve_device
from ..vdms import (VDMSTuningEnv, ivf_pqr, make_dataset, make_space, make_trace,
                    registered_names, replay_trace)

ROUNDS = 12


def run(device=None, draws=None) -> Dict[str, Any]:
    """Register IVF_PQR (it stays registered in this process), tune, replay;
    ``draws`` is the class of the build draws (default ``BuildDraws``).
    Returns the tuner, the replay's result and ``ok``."""
    device = resolve_device(device)
    print("== registering IVF_PQR through the public hook ==")
    family = ivf_pqr.register()  # the one integration call
    print(f"   registered families: {', '.join(registered_names())}")
    print(f"   {family.name}: params={[p.name for p in family.params]} "
          f"frozen={list(family.shared_arrays)}")

    space = make_space()  # derived from the registry, IVF_PQR included
    if "IVF_PQR" not in space.type_names:
        raise RuntimeError("the registry-derived space does not expose the new family")
    print(f"   derived space: {space.dims} dims over {len(space.type_names)} families")

    print(f"== static tuning: IVF_PQR vs two built-ins ({ROUNDS} iters, analytic) ==")
    ds = make_dataset("glove_like", n=3072, n_queries=64, k=10, seed=0, device=device)
    env = VDMSTuningEnv(ds, mode="analytic", seed=0, device=device, draws=draws)
    sub = make_space(include=("IVF_PQ", "SCANN", "IVF_PQR"))
    tuner = VDTuner(sub, env, seed=0, device=device)
    TuningSession(tuner).run(ROUNDS)
    front = pareto_front(tuner.Y)
    front_types = sorted({c["index_type"] for c in tuner.pareto_configs()})
    print(f"   Pareto front ({len(front)} points) from families: {front_types}")
    for spd, rec in front:
        print(f"     qps={spd:9.0f}  recall={rec:.3f}")

    print("== streaming replay: seals + frozen PQ codebooks ==")
    trace = make_trace("glove_like", n_base=1024, n_ops=300, seed=0, mix=(0.3, 0.6, 0.1))
    cfg = dict(sub.default_config("IVF_PQR"), segment_max_size=512, seal_proportion=0.5)
    r = replay_trace(trace, cfg, seed=0, mode="analytic", device=device, draws=draws)
    print(f"   sustained replay: qps={r['speed']:.0f} recall={r['recall']:.3f} "
          f"seals={r['n_seals']:.0f} compactions={r['n_compactions']:.0f}")
    ok = True
    if r["n_seals"] < 1:
        print("   FAIL: streaming replay never sealed a segment", file=sys.stderr)
        ok = False
    elif not (tuner.Y[:, 1] > 0.2).any():
        print("   FAIL: tuned configurations never retrieved anything", file=sys.stderr)
        ok = False
    else:
        print("   custom family tuned end-to-end with zero core edits")
    return dict(tuner=tuner, env=env, replay=r, front=front, ok=ok)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
    return 0 if run(device=args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
