"""Markdown table of the fused-vs-composed search-pipeline records that
``python -m repro_torch.bench.bench_kernels --json PATH`` writes (the twin
of ``search_pipeline_table`` in the JAX package's
``benchmarks/roofline_table.py``; its dry-run roofline tables read XLA
dry-run artifacts, which the port does not produce yet).

    PYTHONPATH=src python -m repro_torch.bench.roofline_table BENCH_fused.json
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


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
    print(search_pipeline_table(*sys.argv[1:2]))
