// Segment-batched distance GEMM with the IP / squared-L2 epilogue fused,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/distance.py::distance_pallas.
// out[z, i, j] = q_i . x[z, j]   (ip)
//             = |q_i|^2 - 2 q_i . x[z, j] + |x[z, j]|^2   (l2)
// q (B, d) f32; x (n_seg, S, d) f32 or bf16; out (n_seg, B, S) f32, f32
// accumulation. A BM x 64 output tile per block of 256 threads (BM = 32
// for a chunk of at most 32 queries, else 64), BM/16 x 4 outputs per
// thread, the contraction streamed through shared memory in steps of 16.
// The norms for the L2 epilogue are summed from the same shared tiles, so
// no second pass over q or x is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64, BK = 16, TN = 4, NT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool L2, int BM>
__global__ void __launch_bounds__(NT)
dist_kernel(const float* __restrict__ q, const T* __restrict__ x, float* __restrict__ out,
            int B, int S, int d) {
  constexpr int TM = BM / 16;
  const int z = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const T* xz = x + (size_t)z * S * d;
  float* oz = out + (size_t)z * B * S;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);

  float acc[TM][TN] = {};
  float qn[TM] = {}, xn[TN] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK, gk = k0 + kk, gr = row0 + r;
      As[kk][r] = (gr < B && gk < d) ? q[(size_t)gr * d + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < BN * BK; i += NT) {
      const int r = i / BK, kk = i % BK, gk = k0 + kk, gc = col0 + r;
      Bs[kk][r] = (gc < S && gk < d) ? to_f32(xz[(size_t)gc * d + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      if (L2) {
#pragma unroll
        for (int i = 0; i < TM; ++i) qn[i] = fmaf(a[i], a[i], qn[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) xn[j] = fmaf(bv[j], bv[j], xn[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cidx = col0 + tx * TN + j;
      if (cidx < S) oz[(size_t)r * S + cidx] = L2 ? qn[i] - 2.f * acc[i][j] + xn[j] : acc[i][j];
    }
  }
}

template <typename T, int BM>
int launch_bm(const float* q, const T* x, float* out, int B, int n_seg, int S, int d, int l2,
              cudaStream_t stream) {
  dim3 grid((S + BN - 1) / BN, (B + BM - 1) / BM, n_seg);
  if (l2)
    dist_kernel<T, true, BM><<<grid, NT, 0, stream>>>(q, x, out, B, S, d);
  else
    dist_kernel<T, false, BM><<<grid, NT, 0, stream>>>(q, x, out, B, S, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* q, const T* x, float* out, int B, int n_seg, int S, int d, int l2,
           void* stream) {
  if (B <= 32) return launch_bm<T, 32>(q, x, out, B, n_seg, S, d, l2, (cudaStream_t)stream);
  return launch_bm<T, 64>(q, x, out, B, n_seg, S, d, l2, (cudaStream_t)stream);
}

}  // namespace

extern "C" int distance_f32(const float* q, const float* x, float* out, int B, int n_seg, int S,
                            int d, int l2, void* stream) {
  return launch<float>(q, x, out, B, n_seg, S, d, l2, stream);
}

extern "C" int distance_bf16(const float* q, const __nv_bfloat16* x, float* out, int B,
                             int n_seg, int S, int d, int l2, void* stream) {
  return launch<__nv_bfloat16>(q, x, out, B, n_seg, S, d, l2, stream);
}
