"""Unfused PQ ADC scan, ``csrc/pq_adc.cu``:
``out[q, n] = sum_m lut[q, m, codes[n, m]]``.

Replaces ``repro/kernels/pq_adc.py::pq_adc_pallas`` (the TPU kernel
``_adc_kernel``). The JAX package calls it only from ``ops.pq_adc``, which
its kernel benchmark times; the port's twin of that benchmark is
:mod:`repro_torch.bench.bench_kernels`.

Contract (as the JAX package's ``ops.pq_adc``): lut (q, m, c) f32; codes
(n, m) integer with every code in [0, c) -> (q, n) f32. Both versions sum
the m terms in order m = 0 .. m-1, so they agree bit for bit.

Bound on the H100: bytes. The result is q * n f32 written once: at 1,024
queries against 131,072 codes it is 537 MB, 0.16 ms at 3.35 TB/s, while the
q * n * m table lookups and adds are a few hundred million operations, read
from shared memory. Design (``csrc/pq_adc.cu``): a block stages the tables of
a tile of up to 16 queries interleaved by query, so one 128-bit load gives a
lane four queries' terms and the four lanes that share a row group read 64
contiguous bytes; a lane owns 4 code rows and writes each query's 4 results
as one 16-byte streaming store; a persistent grid walks equal
ranges of (query tile, row chunk) work. The kernel reads int32 or byte codes
as they lie and checks them on the card: one 4-byte flag, read once by the
host, only when a code can be out of range (int32 codes, or c < 256).
:func:`launch_plan` picks the tile, the warps and the grid.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Iterator, Tuple

import torch

from . import _build
from .ref import pq_adc as pq_adc_torch  # the plain version

__all__ = ["launch_plan", "plan_chunks", "pq_adc_cuda", "pq_adc_torch"]

SMEM_LIMIT = 232448  # opt-in shared memory of one H100 block
H100_SMS = 132
ROWS_PER_LANE = 4  # code rows a lane owns (csrc/pq_adc.cu kRowsPerLane)
MAX_WARPS = 32  # a block of 1,024 threads holds one SM at 64 registers a thread
#: query tiles, widest first; 16 is the widest because a tile of 32 (no bank
#: conflict) measured slower on an H100 80GB HBM3 at 1,024 x 131,072: 0.2638
#: against 0.2259 ms (``python -m repro_torch.bench.pq_adc_variants``; the grid
#: then writes twice as many output rows at once)
QUERY_TILES = (16, 8, 4, 1)
#: the table bytes a plan stages at most, as a share of the output bytes it
#: writes, wherever a tile meets it (else the plan that stages the fewest)
STAGE_SHARE = 0.5
_SIG = [ctypes.c_void_p] * 6  # lut, codes, out, flag, sizes (9 ints), stream
_CODE_BYTES = {torch.int32: 4, torch.uint8: 1}


@functools.lru_cache(maxsize=1)
def _entry():
    """The C entry point ``pq_adc``, built and typed on first use."""
    fn = _build.load("pq_adc").pq_adc
    fn.argtypes, fn.restype = _SIG, ctypes.c_int
    return fn


def tile_shape(qt: int) -> Tuple[int, int, int]:
    """(QI, lanes, rows) at a query tile of ``qt``: the queries a lane loads
    at once, the lanes that share a row group, the code rows of a warp's
    chunk (the kernel's arithmetic)."""
    qi = 1 if qt < 4 else 4
    lanes = qt // qi
    return qi, lanes, ROWS_PER_LANE * (32 // lanes)


def smem_bytes(m: int, c: int, qt: int, warps: int) -> int:
    """Shared memory of a block: the tile's tables and each warp's staged
    code chunk (``csrc/pq_adc.cu::pq_adc_smem``)."""
    rows = tile_shape(qt)[2]
    return qt * m * c * 4 + warps * m * (rows + 4)


def _block_units(units: int, grid: int, b: int) -> Tuple[int, int]:
    return units * b // grid, units * (b + 1) // grid


def _stagings(units: int, grid: int, nc: int) -> int:
    """Tables a grid stages: one per (block, query tile) its range touches."""
    n = 0
    for b in range(grid):
        u0, u1 = _block_units(units, grid, b)
        if u1 > u0:
            n += (u1 - 1) // nc - u0 // nc + 1
    return n


@functools.lru_cache(maxsize=256)
def launch_plan(q: int, n: int, m: int, c: int, sms: int = H100_SMS) -> Dict[str, int]:
    """The kernel's launch at these sizes: the query tile ``qt`` (1, 4, 8 or
    16, no wider than q needs), ``warps`` a block (fewer only where
    the code chunks would not fit beside the tables), at most one block an SM
    (``grid``) and the shared memory (``smem``).

    The tables a plan stages stay at most ``STAGE_SHARE`` of the output
    bytes wherever that can be: the widest tile that meets it with a block
    on every SM (or one a work unit); else the largest grid that meets it,
    at any tile; else (fewer code rows than about twice a table's entries,
    where even one staging a query is too many) blocks that take whole
    tiles, at the tile that stages the fewest bytes. Raises
    :class:`KernelContractError` where not even one query's table fits."""
    out_bytes = 4 * q * n
    limit = STAGE_SHARE * out_bytes
    tiles_fit = []
    for qt in QUERY_TILES:
        if qt > 1 and q <= QUERY_TILES[QUERY_TILES.index(qt) + 1]:  # a narrower tile holds q
            continue
        warps = MAX_WARPS
        while warps and smem_bytes(m, c, qt, warps) > SMEM_LIMIT:
            warps //= 2
        if warps:
            tiles_fit.append((qt, warps))
    if not tiles_fit:
        raise _build.KernelContractError(
            f"pq_adc: one query's table (m={m}, c={c}) does not fit a block's shared memory")

    def plan(qt, warps, grid=None):
        qi, lanes, rows = tile_shape(qt)
        nc = -(-n // rows)
        tiles = -(-q // qt)
        units = tiles * nc
        grid = max(1, min(sms, units) if grid is None else grid)
        return dict(qt=qt, qi=qi, lanes=lanes, rows=rows, warps=warps, grid=grid,
                    smem=smem_bytes(m, c, qt, warps), chunks=nc, tiles=tiles, units=units,
                    staged_bytes=_stagings(units, grid, nc) * qt * m * c * 4,
                    out_bytes=out_bytes)

    full = [plan(qt, w) for qt, w in tiles_fit]
    for p in full:  # widest first
        if p["staged_bytes"] <= limit:
            return p
    best = None
    for p in full:  # each block stages at least one table: grid <= limit / table
        grid = min(p["grid"], int(limit // (p["qt"] * m * c * 4)))
        while grid >= 1:
            cand = plan(p["qt"], p["warps"], grid)
            if cand["staged_bytes"] <= limit:
                if best is None or grid > best["grid"]:
                    best = cand
                break
            grid -= 1
    if best is not None:
        return best
    whole = [plan(qt, w, min(sms, -(-q // qt))) for qt, w in tiles_fit]
    return min(whole, key=lambda p: p["staged_bytes"])


def plan_chunks(plan: Dict[str, int]) -> Iterator[Tuple[int, int, int, int]]:
    """(block, warp, query tile, chunk) for every chunk the kernel runs
    under ``plan``, in the kernel's order: a block's equal share of the
    (tile, chunk) units, the warps of a block taking its chunks of a tile in
    turn. Chunk ``ch`` of tile ``t`` is queries [t * qt, (t + 1) * qt) x rows
    [ch * rows, (ch + 1) * rows), both cut at q and n."""
    units, grid, nc, warps = plan["units"], plan["grid"], plan["chunks"], plan["warps"]
    for b in range(grid):
        u0, u1 = _block_units(units, grid, b)
        u = u0
        while u < u1:
            tile = u // nc
            end = min(u1, (tile + 1) * nc)
            for w in range(warps):
                for ch in range(u - tile * nc + w, end - tile * nc, warps):
                    yield b, w, tile, ch
            u = end


@functools.lru_cache(maxsize=256)
def _launch_sizes(q: int, n: int, m: int, c: int, code_bytes: int, index: int):
    """The C entry point's ``sizes`` array (the sizes and the plan) on
    device ``index``."""
    plan = launch_plan(max(q, 1), max(n, 1), m, c,
                       torch.cuda.get_device_properties(index).multi_processor_count)
    return (ctypes.c_int * 9)(q, n, m, c, code_bytes, plan["qt"], plan["warps"], plan["grid"],
                              plan["smem"])


_HOST = threading.local()


def _host_flag(index: int) -> torch.Tensor:
    """This thread's range flag for device ``index``: one int32 of pinned
    host memory, which the kernel writes through unified addressing. A call
    synchronises its stream before it reads the flag, so a thread reuses it."""
    flags = getattr(_HOST, "flags", None)
    if flags is None:
        flags = _HOST.flags = {}
    flag = flags.get(index)
    if flag is None:
        flag = flags[index] = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    return flag


def pq_adc_cuda(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: same contract as :func:`pq_adc_torch`. Takes int32 or
    uint8 codes (c <= 256) as they lie. Where a code can lie outside [0, c)
    (int32 codes, or c < 256), the kernel flags it in pinned host memory and
    this synchronises the stream once and raises; uint8 codes at c = 256 are
    in range by their type and the call does not synchronise."""
    if lut.dim() != 3 or codes.dim() != 2 or codes.shape[1] != lut.shape[1]:
        raise _build.KernelContractError(
            f"pq_adc: lut (q, m, c) and codes (n, m); got {tuple(lut.shape)}, {tuple(codes.shape)}")
    q, m, c = lut.shape
    n = codes.shape[0]
    dev = lut.device
    if dev.type != "cuda" or codes.device != dev:
        raise _build.KernelContractError("pq_adc_cuda needs lut and codes on one CUDA device")
    if lut.dtype != torch.float32 or not lut.is_contiguous():
        raise _build.KernelContractError(f"pq_adc: lut must be contiguous f32, got {lut.dtype}")
    code_bytes = _CODE_BYTES.get(codes.dtype)
    if code_bytes is None:
        raise _build.KernelContractError(f"pq_adc: codes must be int32 or uint8, got {codes.dtype}")
    if not 1 <= c <= 256 or m < 1:
        raise _build.KernelContractError(
            f"pq_adc: one byte per code addresses 1 to 256 codewords (and m >= 1); got m={m}, c={c}")
    sizes = _launch_sizes(q, n, m, c, code_bytes, dev.index)
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if not out.numel():
        return out
    if not codes.is_contiguous():
        codes = codes.contiguous()
    flag = _host_flag(dev.index) if code_bytes == 4 or c < 256 else None
    err = _entry()(lut.data_ptr(), codes.data_ptr(), out.data_ptr(),
                   None if flag is None else flag.data_ptr(), sizes,
                   torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "pq_adc")
    pq_adc_cuda.launches += 1
    if flag is not None:
        torch.cuda.current_stream(dev).synchronize()  # the call's one synchronisation
        if flag.item():
            flag.zero_()
            raise _build.KernelContractError(f"pq_adc: codes outside [0, {c})")
    return out


pq_adc_cuda.launches = 0
