#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); matmul precision pinned;
  2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once;
  3. each kernel held against its plain PyTorch version on the card, at the
     shapes its path gives it (glove-100-angular size, the defaults of FLAT,
     IVF_SQ8 and IVF_PQ; glm4-9b prefill attention at batch 4 x 2048), and
     timed with CUDA events beside the plain version, a library call where
     one exists, and its bound (bytes over 3.35 TB/s or operations over the
     peak of their type, the H100 SXM data-sheet figures);
  4. the evaluation path: ``VDMSTuningEnv(dataset, mode="wall")`` over the
     defaults of all seven index families in the session's order, with the
     kernels' launch counters reset just before and read just after;
  5. the serving path: ``repro_torch.launch.serve.run`` on glm4-9b at full
     width and depth (40 layers, random weights from seed 0), batch 4, a
     2048-token prompt, 32 generated tokens, counters reset just before and
     read just after; then prefill(t) + one decode step against prefill(t+1)
     at full width;
  6. a ``{"kernels": [...]}`` line, then the card line and the device line.

Exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth, f32 outside the tensor
# cores, bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
TOL = 1e-5  # f32 scores of unit vectors: both versions accumulate d = 100 terms in f32
GLOVE_N = 1_183_514  # glove-100-angular's base vectors
N_QUERIES = 1000  # glove-100-angular has 10,000; cut so the exact ground truth stays cheap


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, flop_per_s: float = PEAK_F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_topk(name, got, want):
    """Fused-kernel contract: per (segment, query) the same candidate set and
    scores within TOL; an id may differ only where its score ties the k-th
    score to within TOL. Returns the largest score difference."""
    import torch

    (gl, gs), (wl, ws) = got, want
    gs_sorted = torch.sort(gs, dim=-1, descending=True).values
    ws_sorted = torch.sort(ws, dim=-1, descending=True).values
    fin = torch.isfinite(ws_sorted)
    if not torch.equal(fin, torch.isfinite(gs_sorted)):
        fail(f"{name}: different numbers of live slots")
    err = float((gs_sorted[fin] - ws_sorted[fin]).abs().max()) if fin.any() else 0.0
    same = torch.equal(torch.sort(gl, -1).values, torch.sort(wl, -1).values)
    if not same:
        diff_rows = (torch.sort(gl, -1).values != torch.sort(wl, -1).values).any(-1).nonzero()
        for z, b in diff_rows.tolist():
            kth = float(ws_sorted[z, b][fin[z, b]].min())
            a = dict(zip(gl[z, b].tolist(), gs[z, b].tolist()))
            w = dict(zip(wl[z, b].tolist(), ws[z, b].tolist()))
            for lid in set(a) ^ set(w):
                s = a.get(lid, w.get(lid))
                if abs(s - kth) > TOL:
                    fail(f"{name}: id {lid} at segment {z} query {b} differs, score {s} "
                         f"vs k-th {kth}")
        print(f"  {name}: {len(diff_rows)} rows differ only by near-ties at the k-th score")
    if err > TOL:
        fail(f"{name}: max score difference {err} > {TOL}")
    return err


def kernel_checks(ds, space, device):
    """Phase 3: each kernel against its plain version at the main path's
    shapes, on the data of the seven defaults' kernel-backed families."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_scan import probe_candidates
    from repro_torch.vdms import VDMSInstance
    from repro_torch.vdms.fused import pq_lut

    rows = {}
    # distance: FLAT's per-chunk call, (32, d) queries against every segment
    inst = VDMSInstance(ds, space.default_config("FLAT"), device=device)
    q = inst._chunked_queries(ds.queries)[0]
    data = inst.bundle.arrays["data"]
    got = ops.batched_ip(q, data)
    want = ops.batched_ip(q, data, impl="torch")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > TOL:
        fail(f"distance: max abs difference {err} > {TOL}")
    for kind, x in (("l2", data), ("ip-bf16", data.to(torch.bfloat16))):
        fn = ops.l2_distance if kind == "l2" else ops.batched_ip
        e = float((fn(q, x) - fn(q, x, impl="torch")).abs().max())
        print(f"  distance {kind}: max abs difference {e:.3e}")
        if e > 10 * TOL:  # l2 adds two norms near 1 to the product
            fail(f"distance {kind}: max abs difference {e}")
    b, d = q.shape
    n_seg, s, _ = data.shape
    bms, by = bound(nbytes(q, data) + n_seg * b * s * 4, 2.0 * b * n_seg * s * d)
    rows["distance"] = dict(
        replaces="src/repro/kernels/distance.py:61",
        source="src/repro_torch/kernels/csrc/distance.cu", max_abs_err=err, ms=cuda_ms(lambda: ops.batched_ip(q, data), 20),
        plain_ms=cuda_ms(lambda: ops.batched_ip(q, data, impl="torch"), 20),
        library_ms=cuda_ms(lambda: torch.matmul(q, data.transpose(1, 2)), 20),
        bound_ms=bms, bound_by=by, shape=f"q {tuple(q.shape)} x {tuple(data.shape)} f32")
    del inst, data, got, want

    # fused SQ8 / PQ: the hooks' one call per search, every chunk flattened
    for fam, name, src, line in (
        ("IVF_SQ8", "fused_ivf_sq8_topk", "fused_scan.cu", "src/repro/kernels/fused_scan.py:178"),
        ("IVF_PQ", "fused_ivf_pq_topk", "fused_adc.cu", "src/repro/kernels/fused_adc.py:79"),
    ):
        inst = VDMSInstance(ds, space.default_config(fam), device=device)
        a, st = inst.bundle.arrays, inst.bundle.static
        qa = inst._chunked_queries(ds.queries).reshape(-1, ds.dim)
        k = min(inst.k_seg, ds.k) if inst._clamp_ok else inst.k_seg
        common = dict(nprobe=st["nprobe"], k=k, mask_dead=inst._clamp_ok)
        if fam == "IVF_SQ8":
            args = (qa, a["codes"], a["scale"], a["centroids"], a["members"], a["gids"])
            fn = ops.fused_ivf_sq8_topk
        else:
            args = (qa, pq_lut(qa, a["codebooks"]), a["codes"], a["centroids"], a["members"],
                    a["gids"])
            fn = ops.fused_ivf_pq_topk
        got = fn(*args, **common)
        want = fn(*args, **common, impl="torch")
        torch.cuda.synchronize()
        err = check_topk(name, got, want)
        live = int((probe_candidates(qa, a["centroids"], a["members"], st["nprobe"]) >= 0).sum())
        n_seg, nlist, _ = a["members"].shape
        probe_flops = 2.0 * n_seg * qa.shape[0] * nlist * ds.dim
        if fam == "IVF_SQ8":  # a multiply-add per code; the scale folded into q per segment
            score_flops = live * 2.0 * ds.dim + n_seg * qa.shape[0] * ds.dim
        else:  # m LUT adds per candidate
            score_flops = live * float(st["m"])
        bms, by = bound(nbytes(*args) + 2 * got[0].numel() * 4, probe_flops + score_flops)
        rows[name] = dict(
            replaces=line, source=f"src/repro_torch/kernels/csrc/{src}", max_abs_err=err,
            ms=cuda_ms(lambda: fn(*args, **common), 5),
            plain_ms=cuda_ms(lambda: fn(*args, **common, impl="torch"), 3, warmup=1),
            library_ms=None, bound_ms=bms, bound_by=by,
            shape=f"B={qa.shape[0]} n_seg={n_seg} nlist={nlist} nprobe={st['nprobe']} "
                  f"cap={a['members'].shape[2]} k={k} live_candidates={live}")
        del inst, a, args, got, want
    torch.cuda.empty_cache()
    for name, r in rows.items():
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max abs err {r['max_abs_err']:.3e}", flush=True)
    return rows


# glm4-9b's prefill attention at the serving phase's shape: batch 4, 2048
# tokens, 32 query heads over 2 kv heads, head dim 128, causal
FLASH_SHAPE = (4, 2048, 32, 2, 128)
# |out| < 1 (v uniform in [-1, 1)), so 7.8e-3 allows a bf16 rounding flip of
# the output; f32: the same arithmetic summed in other orders
FLASH_TOL = {"f32": 2e-5, "bf16": 7.8e-3}
SERVE = dict(batch=4, prompt_len=2048, gen=32)
CONSISTENCY_TOL = 5e-2  # relative L2 of the bf16 last-token logits


def flash_check(device):
    """Phase 3, flash attention: the kernel against its plain version at
    glm4-9b's prefill shape, in f32 and in bf16 (the serving dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    b, s, hq, hkv, dh = FLASH_SHAPE
    g = torch.Generator(device=device).manual_seed(0)
    errs, times = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q = torch.randn(b, s, hq, dh, generator=g, device=device).to(dtype)
        k = torch.randn(b, s, hkv, dh, generator=g, device=device).to(dtype)
        v = (torch.rand(b, s, hkv, dh, generator=g, device=device) * 2 - 1).to(dtype)
        got = ops.flash_attention(q, k, v)
        want = ops.flash_attention(q, k, v, impl="torch")
        torch.cuda.synchronize()
        errs[name] = float((got.float() - want.float()).abs().max())
        print(f"  flash_attention {name}: max abs difference {errs[name]:.3e}", flush=True)
        if not errs[name] <= FLASH_TOL[name]:
            fail(f"flash_attention {name}: max abs difference {errs[name]} > {FLASH_TOL[name]}")
        times[name] = cuda_ms(lambda: ops.flash_attention(q, k, v), 5)
        del got, want
    # the bf16 inputs: the plain version and the library call beside the kernel
    plain_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, impl="torch"), 3, warmup=1)
    torch.cuda.empty_cache()
    qh = q.transpose(1, 2).contiguous()  # SDPA's (b, h, s, dh), kv heads expanded to hq
    kh, vh = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous() for t in (k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 10)
    lib_err = float((F.scaled_dot_product_attention(qh, kh, vh, is_causal=True).transpose(1, 2).float()
                     - ops.flash_attention(q, k, v).float()).abs().max())
    flops = 4.0 * dh * b * hq * (s * (s + 1) // 2)  # Q.K and P.V over the visible causal half
    bms, by = bound(nbytes(q, k, v) + nbytes(q), flops, PEAK_BF16_FLOP_PER_S)
    row = dict(replaces="src/repro/kernels/flash_attention.py:88",
               source="src/repro_torch/kernels/csrc/flash_attention.cu", max_abs_err=errs["bf16"],
               ms=times["bf16"], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
               bound_by=by, shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal")
    print(f"  flash_attention f32: kernel {times['f32']:.4f} ms, max abs err {errs['f32']:.3e}; "
          f"f32 CUDA-core bound {flops / PEAK_F32_FLOP_PER_S * 1e3:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP); SDPA (kv heads expanded) vs kernel max abs diff "
          f"{lib_err:.3e}", flush=True)
    print(f"  flash_attention: {row['shape']}: kernel {row['ms']:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return row


def serve_phase(device):
    """Phase 5: the serving entry point on glm4-9b at full width and depth,
    then the prefill/decode consistency check at the same width."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run
    from repro_torch.models import build_model, transformer as tr

    cfg = get_arch("glm4-9b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run("glm4-9b", smoke=False, **SERVE, seed=0)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    run_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    toks = out["tokens"]
    print(f"  glm4-9b x{cfg.n_layers}: prefill {out['prefill_s']:.4f} s for "
          f"{SERVE['batch']} x {SERVE['prompt_len']} tokens, decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s ({SERVE['gen']} steps in {out['decode_s']:.4f} s), "
          f"peak device memory {peak_gib:.2f} GiB, launches {launches}, run() {run_s:.1f} s",
          flush=True)
    if not out["logits_finite"]:
        fail("serve: non-finite logits")
    if toks.shape != (SERVE["batch"], SERVE["gen"] + 1) or toks.min() < 0 or toks.max() >= cfg.vocab_padded:
        fail(f"serve: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}]")
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"serve: {launches['flash_attention']} flash_attention launches, expected one per "
             f"layer ({cfg.n_layers}) at prefill and none at decode")

    # prefill(t) + decode(token t) against prefill(t + 1), full width (twin of
    # tests/test_models.py::test_dense_decode_matches_full_forward)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    b, t = SERVE["batch"], SERVE["prompt_len"] - 1
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (b, t + 1)), device=device)
    _, cache = tr.prefill(params, {"tokens": tokens[:, :-1]}, cfg, cache_len=t + 1)
    dec, _ = tr.decode_step(params, cache, tokens[:, -1], t, cfg)
    del cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = tr.prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t0
    dec, full = dec.float(), full.float()
    rel = float((dec - full).norm() / full.norm())
    same = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    print(f"  {n_params / 1e9:.3f} B parameters; prefill({t}) + decode vs prefill({t + 1}): "
          f"relative L2 of the last-token logits {rel:.3e}, same argmax in {same:.2f} of rows; "
          f"warm prefill (the third in this phase) of {b} x {t + 1} tokens {prefill2_s:.4f} s", flush=True)
    if not rel <= CONSISTENCY_TOL:
        fail(f"serve: prefill/decode logits differ by {rel} (relative L2) > {CONSISTENCY_TOL}")
    del params, dec, full
    torch.cuda.empty_cache()
    return dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                decode_tokens_per_s=out["decode_tokens_per_s"], peak_gib=peak_gib,
                launches=launches, consistency_rel_l2=rel, warm_prefill_s=prefill2_s,
                n_params=n_params)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import pin_matmul_precision
    from repro_torch.kernels import _build, ops
    from repro_torch.vdms import VDMSTuningEnv, make_dataset, make_space
    from repro_torch.core import TuningFailure

    t_all = time.perf_counter()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(f"[1] card: {card}", flush=True)
    pin_matmul_precision()
    device = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2] built {', '.join(_build.KERNEL_SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.KERNEL_SOURCES:
        log = (_build.build_dir() / f"{name}.ptxas.txt").read_text()
        for line in log.splitlines():
            if "registers" in line:
                print(f"  {name}: {line.split(':', 1)[1].strip()}")

    # the data: glove-100-angular's shape, generated from the seed
    t0 = time.perf_counter()
    ds = make_dataset("glove_like", n=GLOVE_N, n_queries=N_QUERIES, k=10, seed=0, dim=100,
                      device=device)
    print(f"[data] glove_like n={ds.n} d={ds.dim} queries={ds.queries.shape[0]} k={ds.k} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    space = make_space()

    # 3. kernels against their plain versions
    print("[3] kernels against plain versions", flush=True)
    rows = kernel_checks(ds, space, device)
    rows["flash_attention"] = flash_check(device)

    # 4. the evaluation path
    print("[4] VDMSTuningEnv(mode='wall') over the seven defaults", flush=True)
    env = VDMSTuningEnv(ds, mode="wall", seed=0)
    results = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in space.type_names:
        t1 = time.perf_counter()
        try:
            r = env(space.default_config(t))
        except TuningFailure as e:
            fail(f"{t}: TuningFailure: {e}")
        results[t] = r
        print(f"  {t:9s} qps={r['speed']:.1f} recall={r['recall']:.4f} "
              f"build_time={r['build_time']:.3f}s first_search={r['compile_time']:.3f}s "
              f"mem={r['mem_gib']:.4f}GiB ({time.perf_counter() - t1:.1f} s)", flush=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  sweep {time.perf_counter() - t0:.1f} s, launches {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for t, r in results.items():
        if not (0.0 <= r["recall"] <= 1.0 and r["speed"] > 0 and r["mem_gib"] > 0):
            fail(f"{t}: implausible result {r}")
    if results["FLAT"]["recall"] < 0.99:
        fail(f"FLAT recall {results['FLAT']['recall']} < 0.99")
    for name in ("distance", "fused_ivf_sq8_topk", "fused_ivf_pq_topk"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the evaluation path")
    del env, ds
    gc.collect()

    # 5. the serving path
    print("[5] serve glm4-9b (40 layers) batch 4 x 2048 + 32", flush=True)
    serve = serve_phase(device)
    launches["flash_attention"] = serve["launches"]["flash_attention"]

    # 6. results
    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"])
        for name, r in rows.items()
    ]
    print(json.dumps({"seven_defaults": results, "serve": serve, "card": card,
                      "total_s": time.perf_counter() - t_all}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
