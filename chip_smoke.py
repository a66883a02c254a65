#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); matmul precision pinned;
  2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once, with each kernel's registers and
     spills; when the parent commit's kernel sources are unpacked under
     ``build/parent``, its ``distance`` and ``flash_attention`` beside them;
  3. each kernel held against its plain PyTorch version on the card, at the
     shapes its path gives it (glove-100-angular size, the defaults of FLAT,
     IVF_SQ8 and IVF_PQ; ``pq_adc`` at 1,024 queries x 32 IVF_PQ segments of
     codes; glm4-9b prefill attention at batch 4 x 2048), and timed with
     CUDA events beside the plain version, a library call where one exists,
     and its bound (bytes over 3.35 TB/s or operations over the peak of
     their type, the H100 SXM data-sheet figures); the parent's two kernels,
     when built, held against the same plain versions and timed in turns
     with the new ones (new, old, old, new);
  4. the evaluation path: ``VDMSTuningEnv(dataset, mode="wall")`` over the
     defaults of all seven index families in the session's order, with the
     kernels' launch counters reset just before and read just after;
  5. the kernel benchmark (``repro_torch.bench.bench_kernels``): its kernel
     section (each kernel held against its plain version within its
     tolerance; ``pq_adc``'s row of the kernels line), then its pipeline
     section on the glove-100-angular data with the fused-speedup gate and
     composed/fused set identity (IVF_PQR included), counters reset just
     before and read just after;
  6. the tuning loop: ``repro_torch.launch.quickstart.run`` on the same
     data in analytic mode for 20 observations (the seven defaults, then
     GP-driven rounds), interrupted at 12, restored from its JSON checkpoint
     and run again to 20; the resumed history must equal the uninterrupted
     one, and no evaluation may fail except by a build timeout or device
     memory; counters reset just before and read just after; then the
     kernel of each GP-driven FLAT / IVF_SQ8 / IVF_PQ configuration held
     against its plain version at that configuration's shapes;
  7. the serving path: ``repro_torch.launch.serve.run`` on glm4-9b at full
     width and depth (40 layers, random weights from seed 0), batch 4, a
     2048-token prompt, 32 generated tokens, counters reset just before and
     read just after; then prefill(t) + one decode step against prefill(t+1)
     at full width;
  8. a ``{"kernels": [...]}`` line, then the card line and the device line.

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


def ptxas_report(log: str):
    """(kernel, registers, spills) for each function in an ``nvcc -Xptxas -v``
    log, the kernel named by its template instance."""
    import re

    rows, fn, spills = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split(" for ", 1)[1].strip()
            m = re.search(r"_cu_[0-9a-f]{8}\d+(.*?)EEv", fn)
            fn = m.group(1) if m else fn
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and fn:
            rows.append((fn, line.split("Used", 1)[1].split(",")[0].strip(), spills))
            fn = None
    return rows


def config_case(ds, cfg, device):
    """The kernel that ``cfg``'s search launches (FLAT: distance, one call
    per query chunk; IVF_SQ8 / IVF_PQ: their fused kernels, one call over
    every chunk), at the shapes that configuration gives it, on an instance
    built from ``ds``. Returns None for a family that launches no kernel,
    else a dict with ``call(impl)``, ``check(got, want)`` (the largest
    difference, fatal beyond the tolerance), the work (bytes, operations),
    a shape note and the instance's arrays for further checks."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_scan import probe_candidates
    from repro_torch.vdms import VDMSInstance
    from repro_torch.vdms.fused import pq_lut

    fam = cfg["index_type"]
    if fam not in ("FLAT", "IVF_SQ8", "IVF_PQ"):
        return None
    inst = VDMSInstance(ds, cfg, seed=0, device=device)
    a, st = inst.bundle.arrays, inst.bundle.static
    if fam == "FLAT":  # (B, d) queries of one chunk against every segment
        q, data = inst._chunked_queries(ds.queries)[0], a["data"]
        b, d = q.shape
        n_seg, s, _ = data.shape

        def check(got, want):
            err = float((got.float() - want.float()).abs().max())
            if err > TOL:
                fail(f"distance at {shape}: max abs difference {err} > {TOL}")
            return err

        shape = f"q {tuple(q.shape)} x {tuple(data.shape)} {str(data.dtype).split('.')[-1]}"
        return dict(name="distance", replaces="src/repro/kernels/distance.py:61",
                    source="src/repro_torch/kernels/csrc/distance.cu",
                    call=lambda impl: ops.batched_ip(q, data, impl=impl), check=check,
                    library=lambda: torch.matmul(q, data.transpose(1, 2)),
                    work=(nbytes(q, data) + n_seg * b * s * 4, 2.0 * b * n_seg * s * d),
                    shape=shape, q=q, data=data)
    qa = inst._chunked_queries(ds.queries).reshape(-1, ds.dim)
    k = min(inst.k_seg, ds.k) if inst._clamp_ok else inst.k_seg
    common = dict(nprobe=st["nprobe"], k=k, mask_dead=inst._clamp_ok)
    if fam == "IVF_SQ8":
        name, src, line = "fused_ivf_sq8_topk", "fused_scan.cu", "src/repro/kernels/fused_scan.py:178"
        args = (qa, a["codes"], a["scale"], a["centroids"], a["members"], a["gids"])
        fn = ops.fused_ivf_sq8_topk
    else:
        name, src, line = "fused_ivf_pq_topk", "fused_adc.cu", "src/repro/kernels/fused_adc.py:79"
        args = (qa, pq_lut(qa, a["codebooks"]), a["codes"], a["centroids"], a["members"],
                a["gids"])
        fn = ops.fused_ivf_pq_topk
    live = int((probe_candidates(qa, a["centroids"], a["members"], st["nprobe"]) >= 0).sum())
    n_seg, nlist, cap = a["members"].shape
    probe_flops = 2.0 * n_seg * qa.shape[0] * nlist * ds.dim
    if fam == "IVF_SQ8":  # a multiply-add per code; the scale folded into q per segment
        score_flops = live * 2.0 * ds.dim + n_seg * qa.shape[0] * ds.dim
    else:  # m LUT adds per candidate
        score_flops = live * float(st["m"])
    shape = (f"B={qa.shape[0]} n_seg={n_seg} nlist={nlist} nprobe={st['nprobe']} cap={cap} "
             f"k={k} live_candidates={live}" + (f" m={st['m']}" if fam == "IVF_PQ" else ""))
    return dict(name=name, replaces=line, source=f"src/repro_torch/kernels/csrc/{src}",
                call=lambda impl: fn(*args, **common, impl=impl),
                check=lambda got, want: check_topk(f"{name} at {shape}", got, want),
                library=None,
                work=(nbytes(*args) + 2 * n_seg * qa.shape[0] * k * 4, probe_flops + score_flops),
                shape=shape, args=args, m=st.get("m"))


def kernel_checks(ds, space, device, parent=None):
    """Phase 3: each kernel against its plain version at the main path's
    shapes, on the data of the seven defaults' kernel-backed families; with
    the parent's kernels, FLAT's distance timed beside the parent's."""
    import torch

    from repro_torch.kernels import ops

    rows = {}
    for fam in ("FLAT", "IVF_SQ8", "IVF_PQ"):
        case = config_case(ds, space.default_config(fam), device)
        got, want = case["call"](None), case["call"]("torch")
        torch.cuda.synchronize()
        err = case["check"](got, want)
        old = None
        if fam == "FLAT" and parent:
            q, data = case["q"], case["data"]
            old = old_against_new("distance", lambda: ops.batched_ip(q, data),
                                  lambda: parent_distance(parent["distance"], q, data), want, TOL,
                                  20)
        del got, want
        if fam == "FLAT":  # the other epilogue and the bf16 storage
            q, data = case["q"], case["data"]
            for kind, x in (("l2", data), ("ip-bf16", data.to(torch.bfloat16))):
                fn = ops.l2_distance if kind == "l2" else ops.batched_ip
                e = float((fn(q, x) - fn(q, x, impl="torch")).abs().max())
                print(f"  distance {kind}: max abs difference {e:.3e}")
                if e > 10 * TOL:  # l2 adds two norms near 1 to the product
                    fail(f"distance {kind}: max abs difference {e}")
        n_ms, n_plain, plain_warmup = (20, 20, 2) if fam == "FLAT" else (5, 3, 1)
        bms, by = bound(*case["work"])
        call = case["call"]
        rows[case["name"]] = dict(
            replaces=case["replaces"], source=case["source"], max_abs_err=err,
            ms=cuda_ms(lambda: call(None), n_ms),
            plain_ms=cuda_ms(lambda: call("torch"), n_plain, warmup=plain_warmup),
            library_ms=cuda_ms(case["library"], 20) if case["library"] else None,
            bound_ms=bms, bound_by=by, shape=case["shape"], old_against_new=old)
        if fam == "IVF_PQ":  # pq_adc at the evaluation path's scale: these queries'
            # tables against the codes of the first 32 segments
            lut, codes = case["args"][1], case["args"][2]
            pq_adc_check(lut, codes[:32].reshape(-1, case["m"]).int())
        del case, call
    torch.cuda.empty_cache()
    for name, r in rows.items():
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max abs err {r['max_abs_err']:.3e}", flush=True)
    return rows


def pq_adc_check(lut, codes):
    """``pq_adc`` against its plain version at the evaluation path's scale
    (the same summing order, so the difference must be 0), timed beside the
    plain version and the one-hot ``torch.matmul`` (the one-hot built once,
    outside the timing), with int32 and with byte codes. Its kernels-line
    row comes from the kernel benchmark, pq_adc's own path."""
    import torch

    from repro_torch.bench.bench_kernels import onehot_codes
    from repro_torch.kernels import ops

    before = ops.launch_counts()["pq_adc"]
    got = ops.pq_adc(lut, codes)
    want = ops.pq_adc(lut, codes, impl="torch")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err != 0.0:
        fail(f"pq_adc: max abs difference {err} != 0 at lut {tuple(lut.shape)}")
    q, m, c = lut.shape
    onehot = onehot_codes(codes, c)
    flat = lut.reshape(q, m * c)
    lib_err = float((torch.matmul(flat, onehot) - got).abs().max())
    bms, by = bound(nbytes(lut, codes, got), float(q) * codes.shape[0] * (m - 1))
    ms = cuda_ms(lambda: ops.pq_adc(lut, codes), 20)
    plain_ms = cuda_ms(lambda: ops.pq_adc(lut, codes, impl="torch"), 5)
    library_ms = cuda_ms(lambda: torch.matmul(flat, onehot), 10)
    # the same call with the codes stored as bytes (what an index keeps): no
    # range check (no host synchronisation) and no conversion in the wrapper
    codes8 = codes.to(torch.uint8)
    if not torch.equal(ops.pq_adc(lut, codes8), got):
        fail("pq_adc: uint8 codes give another result than int32 codes")
    u8_ms = cuda_ms(lambda: ops.pq_adc(lut, codes8), 20)
    print(f"  pq_adc: lut {tuple(lut.shape)} codes {tuple(codes.shape)}: max abs err {err:.3e} "
          f"(one-hot matmul {lib_err:.3e}), kernel {ms:.4f} ms (uint8 codes {u8_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, one-hot matmul {library_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}), launches in this check {ops.launch_counts()['pq_adc'] - before}", flush=True)
    del onehot, got, want


# The parent commit's versions of the kernels this slice redesigned, built
# from its sources when they are unpacked under the git-ignored build/parent
# (``git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent``),
# so that old and new are timed on one card in one call.
PARENT_SRC = ROOT / "build" / "parent" / "src" / "repro_torch" / "kernels" / "csrc"
PARENT_KERNELS = ("distance", "flash_attention")


def start_parent_build():
    """Start one nvcc per parent kernel (beside phase 2's builds); None when
    the parent's sources are not unpacked."""
    from repro_torch.kernels import _build

    if not all((PARENT_SRC / f"{n}.cu").exists() for n in PARENT_KERNELS):
        print("  parent kernels: build/parent not unpacked; old-against-new timing skipped")
        return None
    out = ROOT / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    return {n: (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(PARENT_SRC), "-o",
                                  str(out / f"{n}.so"), str(PARENT_SRC / f"{n}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out / f"{n}.so")
            for n in PARENT_KERNELS}


def finish_parent_build(procs):
    """Wait for the parent builds; returns name -> loaded library, or None."""
    import ctypes

    from repro_torch.kernels import distance as dmod, flash_attention as fmod

    if procs is None:
        return None
    libs = {}
    for n, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"parent {n}: nvcc exited {proc.returncode}\n{log}")
        libs[n] = ctypes.CDLL(str(so))
    for fn, sig in ((libs["distance"].distance_f32, dmod._SIG),
                    (libs["flash_attention"].flash_attention_bf16, fmod._SIG)):
        fn.argtypes, fn.restype = sig, ctypes.c_int
    return libs


def parent_distance(lib, q, x):
    """The parent's distance kernel, inner product, f32 database."""
    import torch

    from repro_torch.kernels import _build

    out = torch.empty((x.shape[0], q.shape[0], x.shape[1]), dtype=torch.float32, device=q.device)
    _build.check(lib.distance_f32(q.data_ptr(), x.data_ptr(), out.data_ptr(), q.shape[0],
                                  x.shape[0], x.shape[1], x.shape[2], 0,
                                  torch.cuda.current_stream().cuda_stream), "parent distance")
    return out


def parent_flash(lib, q, k, v):
    """The parent's flash kernel, bf16, causal."""
    import torch

    from repro_torch.kernels import _build

    out = torch.empty_like(q)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    _build.check(lib.flash_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                          b, sq, sk, hq, hkv, dh, *q.stride()[:3], *k.stride()[:3],
                                          *v.stride()[:3], 1, 0,
                                          torch.cuda.current_stream().cuda_stream),
                 "parent flash_attention")
    return out


def old_against_new(name, new, old, want, tol, n):
    """The parent's kernel held against the plain version like the new one,
    then both timed in turns (new, old, old, new). Returns the times."""
    import torch

    err = float((old().float() - want.float()).abs().max())
    torch.cuda.synchronize()
    if not err <= tol:
        fail(f"parent {name}: max abs difference {err} > {tol}")
    t = [cuda_ms(f, n) for f in (new, old, old, new)]
    print(f"  {name}: new {t[0]:.4f} / {t[3]:.4f} ms, parent {t[1]:.4f} / {t[2]:.4f} ms "
          f"(parent max abs err {err:.3e})", flush=True)
    return dict(new_ms=[t[0], t[3]], parent_ms=[t[1], t[2]], parent_max_abs_err=err)


# glm4-9b's prefill attention at the serving phase's shape: batch 4, 2048
# tokens, 32 query heads over 2 kv heads, head dim 128, causal
FLASH_SHAPE = (4, 2048, 32, 2, 128)
# |out| < 1 (v uniform in [-1, 1)), so 7.8e-3 allows a bf16 rounding flip of
# the output; f32: the same arithmetic summed in other orders
FLASH_TOL = {"f32": 2e-5, "bf16": 7.8e-3}
SERVE = dict(batch=4, prompt_len=2048, gen=32)
CONSISTENCY_TOL = 5e-2  # relative L2 of the bf16 last-token logits


def flash_check(device, parent=None):
    """Phase 3, flash attention: the kernel against its plain version at
    glm4-9b's prefill shape, in f32 and in bf16 (the serving dtype); with the
    parent's kernels, the bf16 kernel timed beside the parent's."""
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
        del got
    old = None
    if parent:  # q, k, v and want are the bf16 ones
        old = old_against_new("flash_attention", lambda: ops.flash_attention(q, k, v),
                              lambda: parent_flash(parent["flash_attention"], q, k, v), want,
                              FLASH_TOL["bf16"], 10)
    del want
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
               bound_by=by, shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
               old_against_new=old)
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


# the tuning-loop phase: the quickstart session at full size
SESSION = dict(n_iters=20, interrupt_at=12)
FAILURES_ALLOWED = ("index build exceeded", "out of memory")  # build timeout, device memory


def bench_phase(ds, device):
    """Phase 5: the kernel benchmark's two sections through its run
    functions, the pipeline section on ``ds`` with the speedup gate."""
    import torch

    from repro_torch.bench import bench_kernels
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:  # holds each kernel against its plain version within its tolerance
        kern = bench_kernels.run(device=device, repeats=20)
    except AssertionError as e:
        fail(f"bench kernels: {e}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  kernel section {time.perf_counter() - t0:.1f} s, launches {launches}")
    for name, r in kern.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])  # all f32 work
        print(f"  {name}: cuda {r['cuda_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max abs "
              f"err {r['max_abs_err']:.3e} (tolerance {r['tol']:g} x max |plain|)", flush=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        pipes = bench_kernels.run_pipelines(dataset=ds, repeats=3, check_speedup=True,
                                            device=device)
    except AssertionError as e:
        fail(f"bench pipelines: {e}")
    torch.cuda.synchronize()
    pipe_launches = ops.launch_counts()
    print(f"  pipeline section {time.perf_counter() - t0:.1f} s, launches {pipe_launches}")
    for fam, r in pipes.items():
        print(f"  {fam:8s} composed {r['composed_qps']:.1f} QPS, fused {r['fused_qps']:.1f} QPS "
              f"({r['speedup']:.2f}x), recall {r['recall']:.4f}, same sets on 32 queries "
              f"{r.get('same_sets_32', 'n/a (no fused hook)')}", flush=True)
    if not pipes["IVF_PQR"].get("same_sets_32"):
        fail("bench pipelines: IVF_PQR set identity was not checked")
    return dict(kernels=kern, kernel_launches=launches, pipelines=pipes,
                pipeline_launches=pipe_launches)


def session_phase(ds, device):
    """Phase 6: the quickstart's tuning session at full size, with its
    checkpoint/resume check."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart
    from repro_torch.vdms import make_space

    families = make_space().type_names
    if len(families) != 7:
        fail(f"session: the space has families {families}, expected the seven built-ins")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = quickstart.run(dataset=ds, device=device, **SESSION)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    total_s = time.perf_counter() - t0
    for r in quickstart.rounds(out):
        print(f"  #{r['iteration']:2d} {r['index_type']:9s} recommend_s={r['recommend_s']:.4f} "
              f"eval_s={r['eval_s']:.4f} qps={r['speed']:.1f} recall={r['recall']:.4f}"
              f"{' FAILED' if r['failed'] else ''}", flush=True)
    totals = out["ledger"]["totals"]
    print(f"  session {out['session_s']:.1f} s (recommend {totals['recommend_s']:.2f} s, eval "
          f"{totals['eval_s']:.2f} s); with the interrupted and resumed runs {total_s:.1f} s; "
          f"abandoned {out['abandoned']}; launches {launches}")
    print("  Pareto front (qps, recall): " + ", ".join(f"({s:.1f}, {r:.4f})"
                                                       for s, r in out["front"]))
    for f in out["failures"]:
        print(f"  failed evaluation: {f['config']}: {f['error']}")
    bad = [f for f in out["failures"] if not any(a in f["error"] for a in FAILURES_ALLOWED)]
    if bad:
        fail(f"session: {len(bad)} evaluations failed for other reasons: {bad}")
    if len(out["history"]) != SESSION["n_iters"]:
        fail(f"session: {len(out['history'])} observations, expected {SESSION['n_iters']}")
    if not out["resumed_identical"]:
        fail("session: the run restored from its JSON checkpoint diverged from the "
             "uninterrupted one")
    print(f"  resumed from {out['interrupted_at']} observations ({out['checkpoint_bytes']} bytes "
          f"of JSON): identical to the uninterrupted run", flush=True)
    # the GP-driven configurations (the defaults were held in phase 3): each
    # kernel at the shapes such a configuration gave it, against its plain version
    held = []
    for cfg, _y, failed in out["history"][len(make_space().type_names):]:
        case = None if failed else config_case(ds, cfg, device)
        if case is None:
            continue
        got, want = case["call"](None), case["call"]("torch")
        torch.cuda.synchronize()
        err = case["check"](got, want)
        held.append(dict(kernel=case["name"], shape=case["shape"], max_abs_err=err))
        print(f"  held {case['name']} at {case['shape']}: max abs err {err:.3e}", flush=True)
        del case, got, want
    torch.cuda.empty_cache()
    if not held:
        fail("session: no GP-driven configuration ran a kernel to hold against its plain version")
    return dict(rounds=quickstart.rounds(out), front=out["front"], failures=out["failures"],
                totals=totals, session_s=out["session_s"], total_s=total_s, launches=launches,
                held=held)


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

    # 2. build (the parent's redesigned kernels beside, when unpacked)
    t0 = time.perf_counter()
    parent_procs = start_parent_build()
    _build.build_all()
    parent = finish_parent_build(parent_procs)
    print(f"[2] built {', '.join(_build.KERNEL_SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.KERNEL_SOURCES:
        for fn, regs, spills in ptxas_report((_build.build_dir() / f"{name}.ptxas.txt").read_text()):
            print(f"  {name}: {fn}: {regs}; {spills}")
    print(f"  dynamic shared memory per block: flash bf16 (dh 128) "
          f"{_build.load('flash_attention').flash_attention_bf16_smem(128)} B; distance at "
          f"B = 32, f32: {_build.load('distance').distance_smem(32)} B", flush=True)

    # the data: glove-100-angular's shape, generated from the seed
    t0 = time.perf_counter()
    ds = make_dataset("glove_like", n=GLOVE_N, n_queries=N_QUERIES, k=10, seed=0, dim=100,
                      device=device)
    print(f"[data] glove_like n={ds.n} d={ds.dim} queries={ds.queries.shape[0]} k={ds.k} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    space = make_space()

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    print("[3] kernels against plain versions", flush=True)
    rows = kernel_checks(ds, space, device, parent)
    rows["flash_attention"] = flash_check(device, parent)
    print(f"  phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

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
    del env
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. the kernel benchmark
    t0 = time.perf_counter()
    print("[5] kernel benchmark: kernel section, pipeline section at full size", flush=True)
    bench = bench_phase(ds, device)
    launches["pq_adc"] = bench["kernel_launches"]["pq_adc"]
    if launches["pq_adc"] == 0:
        fail("kernel pq_adc was not launched by the kernel benchmark")
    r = bench["kernels"]["pq_adc"]  # pq_adc's own path: the benchmark's row
    rows["pq_adc"] = dict(replaces="src/repro/kernels/pq_adc.py:60",
                          source="src/repro_torch/kernels/csrc/pq_adc.cu",
                          max_abs_err=r["max_abs_err"], ms=r["cuda_ms"], plain_ms=r["plain_ms"],
                          library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. the tuning loop
    t0 = time.perf_counter()
    print(f"[6] VDTuner session (quickstart) on the same data, {SESSION['n_iters']} "
          f"observations, interrupted at {SESSION['interrupt_at']}", flush=True)
    session = session_phase(ds, device)
    for name in ("distance", "fused_ivf_sq8_topk", "fused_ivf_pq_topk"):
        if session["launches"][name] == 0:  # the seven defaults are the first rounds
            fail(f"session: kernel {name} was not launched")
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. the serving path
    t0 = time.perf_counter()
    print("[7] serve glm4-9b (40 layers) batch 4 x 2048 + 32", flush=True)
    serve = serve_phase(device)
    launches["flash_attention"] = serve["launches"]["flash_attention"]
    print(f"  phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    # 8. results
    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"])
        for name, r in rows.items()
    ]
    print(json.dumps({"seven_defaults": results, "bench": bench, "session": session,
                      "serve": serve, "card": card, "total_s": time.perf_counter() - t_all}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
