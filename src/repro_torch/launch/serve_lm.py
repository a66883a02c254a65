"""Batched serving example: prefill a batch of prompts on a GQA transformer
(the reduced config) and decode tokens against the KV cache. The twin of
``examples/serve_lm.py``; runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch glm4-9b --gen 48 [--device cpu]
"""
from __future__ import annotations

import argparse

from .serve import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    out = run(args.arch, smoke=True, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
              device=args.device)
    print(f"prefill: {out['prefill_s']*1e3:.0f} ms for batch={args.batch} x {args.prompt_len} tokens")
    print(f"decode : {out['decode_tokens_per_s']:.1f} tokens/s over {args.gen} steps")
    print(f"sample token ids: {out['tokens'][0][:12].tolist()}")
    return out


if __name__ == "__main__":
    main()
