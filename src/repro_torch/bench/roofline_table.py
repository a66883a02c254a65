"""Markdown tables of the port's dry-run records and of the
fused-vs-composed search-pipeline records (the twin of the JAX package's
``benchmarks/roofline_table.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.bench.roofline_table [DRYRUN_DIR] [BENCH_fused.json]

The dry-run writes ``{arch}_{shape}_1.json`` (one device, ``--mesh host``)
and ``{arch}_{shape}_256.json`` / ``_512.json`` (one rank over the
reference's production meshes, ``--mesh single|multi|both``):
``markdown_table(d, chips)`` reads one of them, :func:`multipod_table` the
512-chip records.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_s(v):
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v*1e3:.2f}ms"
    return f"{v*1e6:.1f}us"


def load(d="experiments/dryrun_torch", chips="1"):
    return [json.loads(f.read_text()) for f in sorted(Path(d).glob(f"*_{chips}.json"))]


def markdown_table(d="experiments/dryrun_torch", chips="1") -> str:
    """One row per (arch, shape) record: the roofline terms on the H100
    constants, the bound, useful FLOPs over counted FLOPs, the roofline
    fraction and the temp bytes; SKIP rows for cells without a path."""
    by_key = {(r["arch"], r["shape"]): r for r in load(d, chips)}
    lines = [
        "| arch | shape | compute | memory | collective | bound | useful (6ND/counted) | roofline frac | temp/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in sorted({k[0] for k in by_key}):
        for shape in ORDER:
            r = by_key.get((arch, shape))
            if r is None:
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | SKIP: {r['skipped'][:42]} | | | |")
                continue
            lines.append(
                f"| {arch} | {shape} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
                f"| {fmt_s(r['collective_s'])} | {r['bottleneck']} "
                f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
                f"| {r['memory_analysis']['temp_size_in_bytes']/2**30:.1f} GiB |"
            )
    return "\n".join(lines)


def multipod_table(d="experiments/dryrun_torch") -> str:
    """One row per 512-chip record: traced or skipped, the temp bytes per
    device and the sharding fallbacks (the reference's ``multipod_table``)."""
    rows = load(d, "512")
    lines = [
        "| arch | shape | compiled | temp/dev | fallbacks |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | yes "
            f"| {r['memory_analysis']['temp_size_in_bytes']/2**30:.1f} GiB "
            f"| {', '.join(r.get('fallbacks', [])) or '—'} |"
        )
    return "\n".join(lines)


def search_pipeline_table(path="BENCH_fused.json") -> str:
    """Per-family end-to-end per-chunk wall time, composed against fused, as
    a markdown table."""
    p = Path(path)
    if not p.exists():
        return f"(no pipeline records at {path} — run repro_torch.bench.bench_kernels --json)"
    records = json.loads(p.read_text())
    lines = [
        "| family | composed ms/chunk | fused ms/chunk | speedup | fused QPS | recall@10 |",
        "|---|---|---|---|---|---|",
    ]
    for fam in sorted(records):
        r = records[fam]
        tag = "" if r.get("fused_hook") else " (fallback)"
        lines.append(
            f"| {fam}{tag} | {r['composed_ms_chunk']:.2f} | {r['fused_ms_chunk']:.2f} "
            f"| {r['speedup']:.2f}x | {r['fused_qps']:.0f} | {r['recall']:.3f} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table(*sys.argv[1:2]))
    print()
    print(multipod_table(*sys.argv[1:2]))
    print()
    print(search_pipeline_table(*sys.argv[2:3]))
