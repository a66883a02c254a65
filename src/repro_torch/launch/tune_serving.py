"""VDTuner tunes the port's own training stack: the twin of
``examples/tune_serving.py``.

Remat strategy plays the role of the index type; the flash blocks and
sequence parallelism are the parameters; the conflicting objectives are
(steps/s at the roofline bound, HBM headroom), both from a dry-run of the
training step on the ``meta`` device (``launch/dryrun.py``; one trace an
evaluation). The default target is glm4-9b at full width with 8 of its 40
layers (``glm4-9b-d8``) at a training shape of 4 x 2,048 tokens; ``--smoke``
takes the example's reduced target (d 256, 8/4 heads, 4 layers, 8 x 512).
The tuner's GP runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.tune_serving [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from ..configs import base
from ..configs.base import ShapeConfig, get_arch, reduce
from ..core import VDTuner, pareto_front
from ..tuning.serve_tuner import ServeTuningEnv, make_serving_space
from .mesh import make_host_mesh

#: the example's VDTuner settings
TUNER = dict(abandon_window=4, n_candidates=64, mc_samples=32)


def target(arch: str = "glm4-9b", depth: int = 8, smoke: bool = False):
    """The tuned model: ``arch`` at full width and ``depth`` layers, or with
    ``smoke`` the example's reduced glm4-9b."""
    if smoke:
        return dataclasses.replace(
            reduce(get_arch("glm4-9b")), name="tune-target", d_model=256, n_heads=8,
            n_kv_heads=4, head_dim=32, d_ff=512, vocab=1024, n_layers=4,
            param_dtype="bfloat16",
        )
    return dataclasses.replace(get_arch(arch), name=f"{arch}-d{depth}", n_layers=depth)


def register_shape(seq_len: int, batch: int) -> str:
    """A training shape of ``batch`` x ``seq_len`` in the shape registry, as
    the example registers its own; returns its name."""
    name = f"train_{batch}x{seq_len}"
    base.SHAPES[name] = ShapeConfig(name, seq_len, batch, "train")
    return name


def run(arch: str = "glm4-9b", depth: int = 8, seq_len: int = 2048, batch: int = 4,
        rounds: int = 10, seed: int = 0, smoke: bool = False, device: Optional[str] = None) -> dict:
    """Tune ``rounds`` rounds; returns the tuner, the env, the Pareto front
    (steps/s proxy, headroom) and the fastest configuration that did not
    fail with its result."""
    cfg = target(arch, depth, smoke)
    if smoke:
        seq_len, batch = 512, 8
    env = ServeTuningEnv(cfg, register_shape(seq_len, batch), make_host_mesh(device))
    tuner = VDTuner(make_serving_space(), env, seed=seed, device=device, **TUNER)
    tuner.run(rounds)
    best = max((o for o in tuner.history if not o.failed), key=lambda o: o.y[0])
    return {"tuner": tuner, "env": env, "cfg": cfg, "front": pareto_front(tuner.Y),
            "best": best}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the example's reduced target")
    ap.add_argument("--device", default=None, help="the tuner's device; default: the GPU")
    args = ap.parse_args(argv)
    out = run(args.arch, args.depth, args.seq_len, args.batch, args.rounds, args.seed,
              args.smoke, args.device)
    print(f"== tuning {out['cfg'].name} (each eval = one dry-run trace) ==")
    print("   pareto (steps/s proxy, HBM headroom):")
    for s, h in out["front"]:
        print(f"     {s:10.2f}   {h:.3f}")
    best = out["best"]
    print(f"   fastest: {best.config['index_type']} "
          f"bq={best.config['flash_bq']} bk={best.config['flash_bk']} "
          f"seq_parallel={best.config['seq_parallel']} "
          f"(mem {best.raw.get('mem_gib', float('nan')):.2f} GiB/dev)")


if __name__ == "__main__":
    main()
