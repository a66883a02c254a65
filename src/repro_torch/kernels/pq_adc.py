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
q * n * m table lookups and adds are a few hundred million operations.
Design: the TPU had no gather and multiplied one-hot expansions of the
codes on its matrix unit; here a block stages the tables of up to eight
queries in shared memory (8 * m * c * 4 bytes, 40 KB at m = 5, c = 256) and
keeps them for many tiles of 256 code rows; a thread owns one code row,
reads its m codes once and gathers m table entries per staged query into
register sums, and each warp writes 128 contiguous bytes per query row.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import pq_adc as pq_adc_torch  # the plain version

__all__ = ["pq_adc_cuda", "pq_adc_torch"]

_SMEM_LIMIT = 232448  # opt-in shared memory of one H100 block
_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("pq_adc")
    lib.pq_adc.argtypes = _SIG
    lib.pq_adc.restype = ctypes.c_int
    return lib


def pq_adc_cuda(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: same contract as :func:`pq_adc_torch`. Takes int32 or
    uint8 codes (c <= 256, so each code fits a byte), checks that every code
    is in [0, c) (not needed for uint8 codes at c = 256), and hands the
    kernel one byte per code."""
    if lut.dim() != 3 or codes.dim() != 2 or codes.shape[1] != lut.shape[1]:
        raise _build.KernelContractError(
            f"pq_adc: lut (q, m, c) and codes (n, m); got {tuple(lut.shape)}, {tuple(codes.shape)}")
    q, m, c = lut.shape
    n = codes.shape[0]
    if lut.device.type != "cuda" or codes.device != lut.device:
        raise _build.KernelContractError("pq_adc_cuda needs lut and codes on one CUDA device")
    if lut.dtype != torch.float32 or not lut.is_contiguous():
        raise _build.KernelContractError(f"pq_adc: lut must be contiguous f32, got {lut.dtype}")
    if codes.dtype not in (torch.int32, torch.uint8):
        raise _build.KernelContractError(f"pq_adc: codes must be int32 or uint8, got {codes.dtype}")
    if not 1 <= c <= 256 or m < 1:
        raise _build.KernelContractError(
            f"pq_adc: one byte per code addresses 1 to 256 codewords (and m >= 1); got m={m}, c={c}")
    if 4 * m * c + 256 * m > _SMEM_LIMIT:
        raise _build.KernelContractError(
            f"pq_adc: one query's table (m={m}, c={c}) does not fit a block's shared memory")
    out = torch.empty((q, n), dtype=torch.float32, device=lut.device)
    if not out.numel():
        return out
    # the range check reads the codes on the host's behalf (one synchronisation
    # per call); uint8 codes at c = 256 are in range by their type
    if codes.dtype != torch.uint8 or c < 256:
        wide = codes.int()  # 256 does not fit a uint8 comparison
        if bool(((wide < 0) | (wide >= c)).any()):
            raise _build.KernelContractError(f"pq_adc: codes outside [0, {c})")
    codes8 = codes.to(torch.uint8).contiguous()
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    err = _lib().pq_adc(lut.data_ptr(), codes8.data_ptr(), out.data_ptr(), q, n, m, c, stream)
    _build.check(err, "pq_adc")
    pq_adc_cuda.launches += 1
    return out


pq_adc_cuda.launches = 0
