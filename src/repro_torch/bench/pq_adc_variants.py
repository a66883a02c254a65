"""Design variants of the ``pq_adc`` kernel timed on the card: a measurement
tool, so that the production source carries no variant switch.

Each variant is a copy of ``kernels/csrc/pq_adc.cu`` with constants
replaced, written under ``build/pq_adc_variants/`` and built with the
production nvcc flags, one process each, all at once. Every (variant, launch
plan) runs on the same inputs (byte codes at c = 256, so no range flag),
kernel only, is held bit for bit against the plain version, and is timed
with CUDA events twice, the second pass in reverse order. Plans other than
the production one go through the C entry's ``sizes`` array. Beside them,
the time of ``zero_`` on a tensor of the output's size: the rate at which
the card writes those bytes.

    python -m repro_torch.bench.pq_adc_variants   # needs a CUDA device
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.pq_adc import SMEM_LIMIT, pq_adc_torch

# name -> (source replacements, rows a lane, [(query tile, warps), ...])
VARIANTS = {
    "production": ({}, 4, [(16, 32), (8, 32), (16, 16)]),
    "tile 32": ({"constexpr int kMaxTile = 16;": "constexpr int kMaxTile = 32;"}, 4,
                [(32, 32), (32, 16)]),
    "8 rows a lane, 512 threads": ({"constexpr int kRowsPerLane = 4;": "constexpr int kRowsPerLane = 8;",
                                    "constexpr int kMaxThreads = 1024;": "constexpr int kMaxThreads = 512;",
                                    "constexpr int kMaxTile = 16;": "constexpr int kMaxTile = 32;"},
                                   8, [(16, 16), (32, 16)]),
    "plain stores": ({"__stcs(reinterpret_cast<float4*>(o + r),\n": "__stwb(reinterpret_cast<float4*>(o + r),\n"},
                     4, [(16, 32)]),
    "4-byte table reads": ({"const bool vec_table = mc % 4 == 0": "const bool vec_table = false && mc % 4 == 0"},
                           4, [(16, 32)]),
}


def build(out_dir: Path):
    """Write and build every variant; name -> loaded entry point."""
    src = (_build.CSRC / "pq_adc.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _, _)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in pq_adc.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    entries = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r}: nvcc exited {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(so)).pq_adc
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 6, ctypes.c_int
        entries[name] = fn
    return entries


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=(1024, 131072, 5, 256),
                    metavar=("Q", "N", "M", "C"))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pq_adc_variants: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    entries = build(_build.build_dir().parent / "pq_adc_variants")
    q, n, m, c = args.shape
    g = torch.Generator(device=dev).manual_seed(0)
    lut = torch.randn(q, m, c, generator=g, device=dev)
    codes = torch.randint(0, c, (n, m), generator=g, device=dev).to(torch.uint8)
    want = pq_adc_torch(lut, codes)
    runs = []
    for name, (_, rows_per_lane, plans) in VARIANTS.items():
        for qt, warps in plans:
            qi = 1 if qt < 4 else 4
            rows = rows_per_lane * (32 // (qt // qi))
            smem = qt * m * c * 4 + warps * m * (rows + 4)
            if smem > SMEM_LIMIT:
                continue
            units = -(-q // qt) * -(-n // rows)
            sizes = (ctypes.c_int * 9)(q, n, m, c, 1, qt, warps, min(sms, units), smem)

            def call(fn=entries[name], sizes=sizes):
                out = torch.empty((q, n), dtype=torch.float32, device=dev)
                _build.check(fn(lut.data_ptr(), codes.data_ptr(), out.data_ptr(), None, sizes,
                                torch.cuda.current_stream().cuda_stream), "pq_adc variant")
                return out

            exact = torch.equal(call(), want)
            runs.append(dict(variant=name, qt=qt, warps=warps, call=call, exact=exact, ms=[]))
    buf = torch.empty((q, n), dtype=torch.float32, device=dev)
    floor = [cuda_ms(buf.zero_, args.iters)]
    for order in (runs, runs[::-1]):
        for r in order:
            r["ms"].append(cuda_ms(r["call"], args.iters))
    floor.append(cuda_ms(buf.zero_, args.iters))
    print(f"{card}; pq_adc at (q, n, m, c) {tuple(args.shape)}, byte codes, kernel only, "
          f"{args.iters} launches a time")
    for r in runs:
        print(f"  {r['variant']:28s} tile {r['qt']:2d} warps {r['warps']:2d}: {r['ms'][0]:.4f} / "
              f"{r['ms'][1]:.4f} ms, bit-equal to the plain version: {r['exact']}")
    print(f"  zero_ of the ({q}, {n}) f32 output: {floor[0]:.4f} / {floor[1]:.4f} ms")
    return 0 if all(r["exact"] for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
