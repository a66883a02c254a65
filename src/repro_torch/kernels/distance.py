"""Distance kernel: inner product or squared L2 of a query block against
stacked segments (``csrc/distance.cu``).

Replaces ``repro/kernels/distance.py::distance_pallas`` (the TPU kernel
``_dist_kernel``). FLAT search calls it through ``ops.batched_ip`` once per
query chunk, over every sealed segment at once: the segment axis is the
grid's z axis, so a chunk is one launch and not one per segment.

Bound on the H100: bytes. A chunk of 32 queries against 289 segments of 4096
x 100 f32 moves 473 MB of database and writes 151 MB of scores, while its
7.6 GFLOP need a tenth of a millisecond at the 67 TFLOP/s f32 rate; the
arithmetic intensity (about 12 FLOP per byte) is far under the card's ridge.
Design: persistent blocks walk (segment, column tile) work, each tile cut
along d into chunks that stream, with the queries' chunk, through a
two-stage ``cp.async`` ring, so loads run under the FMAs; each thread holds
an 8 x 8 register tile fed by float4 shared loads. f32 FMAs (no TF32) keep
the JAX package's f32 contraction; bf16 storage is staged as bf16 and
widened as it is read, which halves the bytes that bound the kernel. Any d
and any number of queries are taken (rows need not be 16-byte aligned). The
L2 norms are summed from the same registers as the product, so the epilogue
costs no second pass.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def distance_torch(queries: torch.Tensor, database: torch.Tensor, kind: str = "ip") -> torch.Tensor:
    """Plain version. queries (q, d) f32; database (n, d) or (n_seg, S, d),
    f32 or bf16 -> (q, n) or (n_seg, q, S) f32."""
    if kind not in ("ip", "l2"):
        raise ValueError(f"kind must be 'ip' or 'l2', got {kind!r}")
    x = database.float()
    ip = torch.matmul(queries, x.transpose(-1, -2))
    if kind == "ip":
        return ip
    qn = (queries.float() ** 2).sum(-1)
    xn = (x**2).sum(-1)
    return qn[:, None] - 2.0 * ip + xn[..., None, :]


_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("distance")
    for fn in (lib.distance_f32, lib.distance_bf16):
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return lib


def distance_cuda(queries: torch.Tensor, database: torch.Tensor, kind: str = "ip") -> torch.Tensor:
    """CUDA kernel: same contract as :func:`distance_torch`."""
    if kind not in ("ip", "l2"):
        raise ValueError(f"kind must be 'ip' or 'l2', got {kind!r}")
    flat = database.dim() == 2
    x = database.unsqueeze(0) if flat else database
    if queries.device.type != "cuda" or x.device != queries.device:
        raise _build.KernelContractError(
            "distance_cuda needs queries and database on one CUDA device")
    if queries.dtype != torch.float32 or x.dtype not in (torch.float32, torch.bfloat16):
        raise _build.KernelContractError(
            f"dtypes: queries f32, database f32/bf16; got {queries.dtype}, {x.dtype}")
    if queries.dim() != 2 or x.dim() != 3 or x.shape[2] != queries.shape[1]:
        raise _build.KernelContractError(
            f"shapes: queries (q, d), database (n_seg, S, d); got "
            f"{tuple(queries.shape)}, {tuple(database.shape)}")
    if not (queries.is_contiguous() and x.is_contiguous()):
        raise _build.KernelContractError("distance_cuda needs contiguous inputs")
    b, d = queries.shape
    n_seg, s, _ = x.shape
    out = torch.empty((n_seg, b, s), dtype=torch.float32, device=queries.device)
    if out.numel():
        lib = _lib()
        fn = lib.distance_f32 if x.dtype == torch.float32 else lib.distance_bf16
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(queries.data_ptr(), x.data_ptr(), out.data_ptr(), b, n_seg, s, d,
                 int(kind == "l2"), stream)
        _build.check(err, "distance")
        distance_cuda.launches += 1
    return out[0] if flat else out


distance_cuda.launches = 0
