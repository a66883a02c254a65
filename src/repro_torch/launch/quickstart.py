"""Quickstart: auto-tune a vector data management system with VDTuner on the
port (the twin of the JAX package's ``examples/quickstart.py``).

Builds the VDMS over a synthetic angular-embedding dataset, then drives
VDTuner's polling multi-objective Bayesian optimization through the ask/tell
``TuningSession`` API to find configurations that maximize both search
speed (QPS, analytic mode) and recall@10, and shows that an interrupted
session resumes bit-identically from a JSON checkpoint. The GP, the
acquisition and every search run on the GPU unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Exits 1 if the checkpoint/resume round trip diverges.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

from ..core import StopSession, TuningFailure, TuningSession, VDTuner, pareto_front, speed_recall
from ..device import resolve_device
from ..vdms import VDMSTuningEnv, VectorDataset, make_dataset, make_space

N_ITERS = 30
INTERRUPT_AT = 12


class _FailureLog:
    """The evaluation backend, keeping each failed configuration with its
    message (the tuner itself records only that it failed)."""

    def __init__(self, env: VDMSTuningEnv):
        self.env = env
        self.failures: Dict[str, Dict[str, Any]] = {}

    def __call__(self, cfg):
        try:
            return self.env(cfg)
        except TuningFailure as e:
            self.failures[json.dumps(cfg, sort_keys=True)] = {"config": dict(cfg), "error": str(e)}
            raise


def make_tuner(space, device):
    # the tuner is a pure recommender: ask(n) -> configs, tell(cfg, result);
    # the session owns evaluation dispatch, budget, ledger, checkpoints
    return VDTuner(space, seed=0, abandon_window=8, objective_spec=speed_recall(), device=device)


def run(dataset: Optional[VectorDataset] = None, n_iters: int = N_ITERS,
        interrupt_at: int = INTERRUPT_AT, device=None) -> Dict[str, Any]:
    """The quickstart session in analytic mode (seed 0, ``speed_recall``,
    ``abandon_window=8``) on ``dataset`` (default: 6,144 glove-like vectors,
    128 queries), then the same session interrupted at ``interrupt_at``
    observations, restored from its JSON checkpoint and run again to
    ``n_iters``.

    Returns the uninterrupted ``history`` (config, (speed, recall), failed),
    its ``ledger`` (``TuningSession.ledger_dict()``), ``front``,
    ``abandoned`` types, ``failures`` (config and message of each failed
    evaluation), ``session_s``, ``checkpoint_bytes`` and ``resumed_identical``
    (the resumed history equals the uninterrupted one).
    """
    device = resolve_device(device)
    ds = dataset if dataset is not None else make_dataset(
        "glove_like", n=6144, n_queries=128, k=10, seed=0, device=device)
    backend = _FailureLog(VDMSTuningEnv(ds, mode="analytic", seed=0, device=device))
    space = make_space()

    t0 = time.perf_counter()
    tuner = make_tuner(space, device)
    session = TuningSession(tuner, backend=backend)
    session.run(n_iters)
    session_s = time.perf_counter() - t0

    def interrupt(sess, obs):
        if sess.n_observations >= interrupt_at:
            raise StopSession

    part = TuningSession(make_tuner(space, device), backend=backend, callbacks=[interrupt])
    part.run(n_iters)
    checkpoint = json.dumps(part.state_dict())  # JSON all the way, as to disk
    resumed = TuningSession.restore(json.loads(checkpoint), make_tuner(space, device),
                                    backend=backend)
    resumed.run(n_iters)

    def trajectory(t):
        return [(o.config, tuple(o.y), o.failed) for o in t.history]

    return {
        "history": trajectory(tuner),
        "ledger": session.ledger_dict(),
        "front": pareto_front(tuner.Y).tolist(),
        "abandoned": list(tuner.abandon.abandoned),
        "failures": list(backend.failures.values()),
        "session_s": session_s,
        "interrupted_at": part.n_observations,
        "checkpoint_bytes": len(checkpoint),
        "resumed_identical": trajectory(resumed.tuner) == trajectory(tuner),
    }


def rounds(out: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per evaluation of the uninterrupted session: ``recommend_s``,
    ``eval_s``, the family, (QPS, recall) and whether it failed."""
    evals = [e for r in out["ledger"]["rounds"] for e in r["evals"]]
    return [
        dict(e, index_type=cfg["index_type"], speed=y[0], recall=y[1])
        for e, (cfg, y, _failed) in zip(evals, out["history"])
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=N_ITERS)
    ap.add_argument("--interrupt-at", type=int, default=INTERRUPT_AT)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    out = run(n_iters=args.iters, interrupt_at=args.interrupt_at, device=args.device)
    totals = out["ledger"]["totals"]
    print(f"== VDTuner: {len(out['history'])} observations in {out['session_s']:.1f} s ==")
    for r in rounds(out):
        print(f"   #{r['iteration']:2d} {r['index_type']:9s} qps={r['speed']:10.0f} "
              f"recall={r['recall']:.3f} recommend={r['recommend_s']:.3f}s eval={r['eval_s']:.3f}s"
              f"{' FAILED' if r['failed'] else ''}")
    print(f"   abandoned index types: {out['abandoned']}")
    print(f"   time ledger: recommend={totals['recommend_s']:.2f}s eval={totals['eval_s']:.2f}s "
          f"over {totals['n_rounds']} rounds")
    print("   Pareto front (speed, recall):")
    for spd, rec in out["front"]:
        print(f"     qps={spd:9.0f}  recall={rec:.3f}")
    for f in out["failures"]:
        print(f"   failed: {f['config']['index_type']}: {f['error']}")
    print(f"== checkpoint/resume: interrupted at {out['interrupted_at']} observations "
          f"({out['checkpoint_bytes']} bytes of JSON), restored, rerun ==")
    if not out["resumed_identical"]:
        print("   RESUME MISMATCH: restored session diverged from the uninterrupted run",
              file=sys.stderr)
        return 1
    print(f"   resumed run is bit-identical to the uninterrupted one "
          f"({len(out['history'])} observations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
