"""Kernel microbenchmarks and fused-vs-composed search pipelines of the port
(the twin of the JAX package's ``benchmarks/bench_kernels.py``).

Kernel section: ``distance``, ``pq_adc`` and ``flash_attention`` at the JAX
benchmark's shapes, each through three routes on the card: the CUDA kernel,
its plain PyTorch version, and one PyTorch library call that computes the
same function (``torch.matmul``; for ``pq_adc`` the product of the flattened
tables with a one-hot expansion of the codes, built once outside the timing;
``scaled_dot_product_attention`` with the kv heads expanded). Times are CUDA
events over ``--repeats`` calls after warm-up; the kernel is also held
against its plain version. With ``--device cpu`` only the plain versions
are timed, on the host clock, and the output says so.

Pipeline section: one static ``VDMSInstance`` per IVF family (IVF_FLAT,
IVF_SQ8, IVF_PQ and IVF_PQR, registered for the section and unregistered
after it) measured with the same wall-clock search under both pipeline
modes, and the two modes' result sets compared on 32 queries.
``--check-speedup`` gates fused >= 2x composed QPS on IVF_SQ8 and IVF_PQ,
and IVF_FLAT (no fused hook) invariant to the mode.

    PYTHONPATH=src python -m repro_torch.bench.bench_kernels --device cpu --quick

Without a CUDA device and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device, sync
from ..kernels import ops
from ..vdms import (
    VDMSInstance,
    VectorDataset,
    get_family,
    get_search_pipeline,
    make_dataset,
    set_search_pipeline,
)
from ..vdms.ivf_pqr import register as register_ivf_pqr
from ..vdms.registry import REGISTRY
from .common import emit


def _cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _host_ms(fn, repeats: int) -> float:
    fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3


def onehot_codes(codes: torch.Tensor, c: int) -> torch.Tensor:
    """(m * c, n) f32 one-hot expansion of codes (n, m): column n holds a 1
    at row ``j * c + codes[n, j]`` for each j, so ``lut.reshape(q, m * c)``
    times it is the ADC scan as one matrix product."""
    n, m = codes.shape
    dev = codes.device
    onehot = torch.zeros((m * c, n), dtype=torch.float32, device=dev)
    onehot[(codes.long() + torch.arange(m, device=dev) * c).T, torch.arange(n, device=dev)] = 1.0
    return onehot


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _kernel_cases(device):
    """Per kernel at the JAX benchmark's shapes, inputs drawn from seed 0 in
    its order: (name, row label, call(impl), library call, work note,
    tolerance, (bytes moved, f32 operations)). The kernel may
    differ from its plain version by at most ``tolerance * max|plain|``."""
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    q, x = t(rng.standard_normal((128, 96))), t(rng.standard_normal((8192, 96)))
    lut = t(rng.standard_normal((128, 8, 256)))
    codes = t(rng.integers(0, 256, (8192, 8)), torch.int32)
    qq = t(rng.standard_normal((1, 1024, 8, 64)))
    kk = t(rng.standard_normal((1, 1024, 4, 64)))
    vv = t(rng.standard_normal((1, 1024, 4, 64)))

    nq, m, c = lut.shape
    onehot = onehot_codes(codes, c)
    qh = qq.transpose(1, 2)
    kh, vh = (a.repeat_interleave(qq.shape[2] // a.shape[2], dim=2).transpose(1, 2)
              for a in (kk, vv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s_len, dh = qq.shape[1], qq.shape[3]
    return [
        # f32 sums of 96 products in another order
        ("distance", "kernel/distance_ip_128x8192x96",
         lambda impl: ops.batched_ip(q, x, impl=impl), lambda: torch.matmul(q, x.T),
         f"gflop={2 * 128 * 8192 * 96 / 1e9:.3f}", 1e-5,
         (_nbytes(q, x) + 128 * 8192 * 4, 2.0 * 128 * 8192 * 96)),
        # the same gathers summed in the same order m = 0 .. m-1
        ("pq_adc", "kernel/pq_adc_128x8192x8x256",
         lambda impl: ops.pq_adc(lut, codes, impl=impl),
         lambda: torch.matmul(lut.reshape(nq, m * c), onehot),
         f"lookups={128 * 8192 * 8}", 0.0,
         (_nbytes(lut, codes) + nq * codes.shape[0] * 4, float(nq) * codes.shape[0] * (m - 1))),
        # f32 online softmax: the same terms summed in other orders
        ("flash_attention", "kernel/flash_fwd_b1_s1024_h8_d64",
         lambda impl: ops.flash_attention(qq, kk, vv, causal=True, impl=impl),
         lambda: sdpa(qh, kh, vh, is_causal=True).transpose(1, 2), "causal_gqa_f32", 1e-5,
         (_nbytes(qq, kk, vv, qq), 4.0 * dh * qq.shape[2] * (s_len * (s_len + 1) // 2))),
    ]


def run(device=None, repeats: int = 20) -> Dict[str, Dict[str, Any]]:
    """Kernel section: per kernel ``cuda_ms``, ``plain_ms``, ``library_ms``,
    ``max_abs_err`` (kernel against plain version), ``tol`` and the work
    (``bytes``, f32 ``ops``) on the card; only ``plain_ms`` (host
    clock) with ``device="cpu"``. Raises AssertionError when a kernel differs
    from its plain version by more than its tolerance."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if not on_card:
        print(f"# {dev}: no card in use, timing the plain PyTorch versions only (host clock)")
    out: Dict[str, Dict[str, Any]] = {}
    for name, label, call, library, note, tol, (nbytes, nops) in _kernel_cases(dev):
        if on_card:
            got, want = call(None), call("torch")
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            limit = tol * float(want.float().abs().max())
            if not err <= limit:
                raise AssertionError(f"{name}: kernel and plain version differ by {err} > {limit}")
            rec = dict(
                cuda_ms=_cuda_ms(lambda: call(None), repeats),
                plain_ms=_cuda_ms(lambda: call("torch"), max(repeats // 4, 1)),
                library_ms=_cuda_ms(library, repeats),
                max_abs_err=err, tol=tol, bytes=nbytes, ops=nops,
            )
            for route in ("cuda", "plain", "library"):
                emit(f"{label}/{route}", rec[f"{route}_ms"] * 1e3, note)
        else:
            rec = dict(plain_ms=_host_ms(lambda: call("torch"), repeats))
            emit(f"{label}/plain", rec["plain_ms"] * 1e3, f"{note};device={dev}")
        out[name] = rec
    return out


# ---------------------------------------------------------------------------
# end-to-end search-pipeline rows (fused vs composed, per family)
# ---------------------------------------------------------------------------
#: families the >= 2x fused-QPS gate applies to (the evaluation hot path)
GATED_FAMILIES = ("IVF_SQ8", "IVF_PQ")
#: a family registered WITHOUT a fused hook: exercises the composed fallback
FALLBACK_FAMILY = "IVF_FLAT"

_FAMILY_PARAMS = {
    "IVF_FLAT": {"nlist": 64, "nprobe": 8},
    "IVF_SQ8": {"nlist": 64, "nprobe": 8},
    "IVF_PQ": {"nlist": 64, "nprobe": 8, "m": 8, "nbits": 8},
    "IVF_PQR": {"nlist": 64, "nprobe": 8, "m": 8, "nbits": 8, "reorder_k": 64},
}


def run_pipelines(dataset: Optional[VectorDataset] = None, quick: bool = False, repeats: int = 5,
                  check_speedup: bool = False, device=None) -> Dict[str, Dict[str, Any]]:
    """Per-family end-to-end search: composed vs fused wall QPS on
    ``dataset`` (default: 9,216 glove-like vectors, or 4,608 with ``quick``,
    128 queries). Builds each instance once, measures the identical query
    stream under both pipeline modes, checks that the modes return the same
    result sets, and with ``check_speedup`` applies the gate. Returns
    {family: record}."""
    dev = resolve_device(device)
    registered = "IVF_PQR" in {f.name for f in REGISTRY.families()}
    register_ivf_pqr()
    n, seg = (4608, 2048) if quick else (9216, 4096)
    ds = dataset if dataset is not None else make_dataset(
        "glove_like", n=n, n_queries=128, k=10, seed=0, device=dev)
    base = {
        "segment_max_size": seg, "seal_proportion": 0.75, "graceful_time": 0.2,
        "search_batch_size": 32, "topk_merge_width": 64, "kmeans_iters": 4,
        "storage_bf16": False,
    }
    records: Dict[str, Dict[str, Any]] = {}
    prev = get_search_pipeline()
    try:
        for fam, params in _FAMILY_PARAMS.items():
            inst = VDMSInstance(ds, dict(base, index_type=fam, **params), seed=0, device=dev)
            n_chunks = (ds.queries.shape[0] + inst.batch - 1) // inst.batch
            res = {}
            for mode in ("composed", "fused"):
                set_search_pipeline(mode)
                r = inst.measure(topk=10, repeats=repeats, mode="wall")
                ms_chunk = ds.queries.shape[0] / r["speed"] / n_chunks * 1e3
                res[mode] = dict(r, ms_chunk=ms_chunk)
                emit(f"pipeline/{fam}_{mode}", ms_chunk * 1e3,
                     f"qps={r['speed']:.0f};recall={r['recall']:.3f}")
            speedup = res["fused"]["speed"] / res["composed"]["speed"]
            fused_hook = get_family(fam).fused_search is not None
            emit(f"pipeline/{fam}_speedup", 0.0, f"x={speedup:.2f};fused_hook={int(fused_hook)}")
            records[fam] = {
                "fused_hook": fused_hook,
                "composed_qps": res["composed"]["speed"],
                "fused_qps": res["fused"]["speed"],
                "composed_ms_chunk": res["composed"]["ms_chunk"],
                "fused_ms_chunk": res["fused"]["ms_chunk"],
                "speedup": speedup,
                "recall": res["fused"]["recall"],
            }
            if fused_hook:
                # result-set identity between the two modes on this instance
                set_search_pipeline("composed")
                a = inst.search(ds.queries[:32], 10)
                set_search_pipeline("fused")
                b = inst.search(ds.queries[:32], 10)
                if not all(set(x[x >= 0]) == set(y[y >= 0]) for x, y in zip(a, b)):
                    raise AssertionError(f"{fam}: fused result set != composed")
                records[fam]["same_sets_32"] = True
            del inst
            sync(dev)
        if check_speedup:
            if get_family(FALLBACK_FAMILY).fused_search is not None:
                raise AssertionError(
                    f"{FALLBACK_FAMILY} grew a fused hook; pick another fallback family")
            fb = records[FALLBACK_FAMILY]["speedup"]
            if not 0.5 < fb < 2.0:
                raise AssertionError(
                    f"fallback family {FALLBACK_FAMILY} should be mode-invariant, got {fb:.2f}x")
            for fam in GATED_FAMILIES:
                s = records[fam]["speedup"]
                if s < 2.0:
                    raise AssertionError(f"fused pipeline gate: {fam} speedup {s:.2f}x < 2.0x")
            print("check-speedup OK: " + ", ".join(
                f"{f}={records[f]['speedup']:.2f}x" for f in GATED_FAMILIES))
    finally:
        set_search_pipeline(prev)
        if not registered:
            REGISTRY.unregister("IVF_PQR")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--quick", action="store_true", help="smaller corpus")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--json", metavar="PATH", help="write pipeline records as JSON")
    ap.add_argument("--check-speedup", action="store_true",
                    help="fail unless fused >= 2x composed QPS on the gated families")
    ap.add_argument("--ops-only", action="store_true", help="skip the pipeline section")
    args = ap.parse_args(argv)
    run(device=args.device, repeats=args.repeats)
    if args.ops_only:
        return 0
    records = run_pipelines(quick=args.quick, repeats=args.repeats,
                            check_speedup=args.check_speedup, device=args.device)
    if args.json:
        Path(args.json).write_text(json.dumps(records, indent=2, sort_keys=True))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
