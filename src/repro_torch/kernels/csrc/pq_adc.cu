// Unfused PQ asymmetric-distance (ADC) scan, for sm_90a:
//   out[q, n] = sum_j lut[q, j, codes[n, j]],  j = 0 .. m-1 in order.
//
// Replaces the TPU kernel repro/kernels/pq_adc.py::pq_adc_pallas, which had
// no gather and expanded every code into a one-hot row for m matrix
// products. Here a block stages the tables of up to kMaxQ queries in shared
// memory and walks tiles of kTile code rows; each thread owns one code row
// of the tile, reads its m codes once (from a transposed shared copy of the
// tile) and keeps one running sum per staged query in registers, so every
// table lookup is one shared-memory gather. Writing the (q, n) f32 result is
// what bounds the kernel on the H100; each warp writes 128 contiguous bytes
// of a row per query.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // code rows per tile = threads per block
constexpr int kMaxQ = 8;    // queries staged per block
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one H100 block

__global__ void __launch_bounds__(kTile) pq_adc_kernel(const float* __restrict__ lut,
                                                       const uint8_t* __restrict__ codes,
                                                       float* __restrict__ out, int Q, int N,
                                                       int m, int c, int bq, int tiles_per_block) {
  extern __shared__ float smem[];
  const int mc = m * c;
  float* lt = smem;                              // bq * m * c
  uint8_t* cs = (uint8_t*)(lt + (size_t)bq * mc);  // m * kTile, transposed: cs[j * kTile + row]
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, Q - q0);
  const int t = threadIdx.x;
  for (int i = t; i < nq * mc; i += kTile) lt[i] = lut[(size_t)q0 * mc + i];

  const int n_tiles = (N + kTile - 1) / kTile;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_tiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int n0 = tile * kTile;
    const int rows = min(kTile, N - n0);
    __syncthreads();  // the previous tile's codes are consumed (and the tables are staged)
    for (int i = t; i < rows * m; i += kTile) {
      const int r = i / m;
      cs[(i - r * m) * kTile + r] = codes[(size_t)n0 * m + i];
    }
    __syncthreads();
    if (t >= rows) continue;
    float acc[kMaxQ];
    {
      const int code = cs[t];
#pragma unroll
      for (int qi = 0; qi < kMaxQ; ++qi)
        if (qi < nq) acc[qi] = lt[qi * mc + code];
    }
    for (int j = 1; j < m; ++j) {
      const int off = j * c + cs[j * kTile + t];
#pragma unroll
      for (int qi = 0; qi < kMaxQ; ++qi)
        if (qi < nq) acc[qi] = acc[qi] + lt[qi * mc + off];
    }
#pragma unroll
    for (int qi = 0; qi < kMaxQ; ++qi)
      if (qi < nq) out[(size_t)(q0 + qi) * N + n0 + t] = acc[qi];
  }
}

}  // namespace

// Shared memory one block of `bq` staged queries needs.
static size_t pq_adc_smem(int bq, int m, int c) {
  return sizeof(float) * (size_t)bq * m * c + (size_t)m * kTile;
}

extern "C" int pq_adc(const float* lut, const uint8_t* codes, float* out, int Q, int N, int m,
                      int c, void* stream) {
  int bq = kMaxQ < Q ? kMaxQ : Q;
  while (bq > 0 && pq_adc_smem(bq, m, c) > (size_t)kSmemLimit) --bq;
  if (bq == 0) return (int)cudaErrorInvalidValue;  // one query's table exceeds shared memory
  const size_t smem = pq_adc_smem(bq, m, c);
  cudaError_t err =
      cudaFuncSetAttribute(pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_blocks = (Q + bq - 1) / bq;
  const int n_tiles = (N + kTile - 1) / kTile;
  // about a thousand blocks in all: enough to fill 132 SMs, few enough that
  // each block re-reads its staged tables over many tiles
  long long per = ((long long)n_tiles * q_blocks + 1023) / 1024;
  const int tiles_per_block = per < 1 ? 1 : (int)per;
  dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, q_blocks);
  pq_adc_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(lut, codes, out, Q, N, m, c, bq,
                                                             tiles_per_block);
  return (int)cudaGetLastError();
}
