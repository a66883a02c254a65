"""End-to-end training example: a ~130M-parameter Mamba2 LM (the reduced
config unless ``--full-width``) for a few hundred steps on the synthetic
token pipeline, with checkpointing, auto-resume and straggler monitoring.
Stop it mid-run and start it again: it resumes. The twin of
``examples/train_lm.py``; runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from .train import TrainConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-width", action="store_true",
                    help="true mamba2-130m width (slow on CPU); default is the reduced smoke config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    tcfg = TrainConfig(
        arch="mamba2-130m",
        smoke=not args.full_width,
        steps=args.steps,
        seq_len=256 if args.full_width else 128,
        global_batch=8,
        microbatch=4,
        lr=3e-4,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=20,
    )
    out = run(tcfg, device=args.device)
    print(f"trained: first loss {out['losses'][0]:.3f} -> final {out['final_loss']:.3f} "
          f"({len(out['losses'])} steps, median {1e3*(out['median_step_s'] or 0):.0f} ms/step)")
    return out


if __name__ == "__main__":
    main()
