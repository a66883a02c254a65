// Segment-batched distance GEMM with the IP / squared-L2 epilogue fused,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/distance.py::distance_pallas.
// out[z, i, j] = q_i . x[z, j]   (ip)
//             = |q_i|^2 - 2 q_i . x[z, j] + |x[z, j]|^2   (l2)
// q (B, d) f32; x (n_seg, S, d) f32 or bf16; out (n_seg, B, S) f32, exact f32
// FMAs (no TF32).
//
// Bound on the H100: bytes (the database is read once per query chunk; about
// 12 FLOP per byte at the FLAT chunk, under the f32 ridge of 20). Design:
// * persistent blocks (one per SM) walk (segment, column tile) work; a
//   column tile is BN = 512 (B <= 32) or 256 (B <= 64; more queries are
//   split over grid.y) database rows, cut along d into chunks of KC = 52
//   values. Every (tile, chunk) is one stage of a two-stage cp.async ring
//   that also carries the queries' chunk (from L2 after the first tile), so
//   the next stage's loads run under this stage's FMAs and stores, and d is
//   not limited by shared memory;
// * each of 256 threads holds an 8 x 8 register tile (8 query rows x 8
//   database rows tx + NX c): 16 float4 shared loads (the queries' as
//   warp-wide broadcasts) feed 256 FMAs. A stage row is 13 16-byte groups,
//   an odd number, so the 8 lanes of a shared-memory phase read 8
//   consecutive rows in 8 distinct bank groups;
// * any d: f32 rows with d % 4 == 0 are copied in 16-byte granules, other f32
//   rows and bf16 rows of even d (200 bytes at d = 100, not 16-byte
//   aligned) in 4-byte granules; bf16 rows of odd d by plain 2-byte loads
//   and stores. bf16 stays bf16 in the stage (half the bytes) and is widened
//   as it is read. Past d and past S the stage holds zeros;
// * the L2 norms are summed from the same registers as the product; the
//   scores are written by lanes on consecutive columns, 128 bytes per warp
//   store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256, KC = 52, STAGES = 2;
// how a stage is copied: 16-byte or 4-byte cp.async granules, or plain
// 2-byte loads and stores (bf16 rows of odd d, which are only 2-byte aligned)
enum CopyMode { VEC16 = 0, VEC4 = 1, SYNC = 2 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive stage values as f32 (a bf16 is the high half of an f32)
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

template <typename T, int MODE, bool L2, int BM>
__global__ void __launch_bounds__(NT, 1)
dist_kernel(const float* __restrict__ q, const T* __restrict__ x, float* __restrict__ out, int B,
            int S, int d, int n_kc, int tiles_per_seg, int n_tiles) {
  constexpr int NY = BM / 8, NX = NT / NY, BN = NX * 8;  // 8 x 8 outputs per thread
  // values per copy
  constexpr int G = MODE == VEC16 ? 16 / sizeof(T) : MODE == VEC4 ? 4 / sizeof(T) : 1;
  static_assert(KC % G == 0 && KC % 4 == 0, "a chunk is whole copies and whole float4 reads");
  extern __shared__ __align__(16) unsigned char smem[];
  // a stage: the queries' chunk (BM x KC f32), then the database's (BN x KC, as stored)
  constexpr int STAGE_BYTES = BM * KC * 4 + BN * KC * (int)sizeof(T);
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  const int row0 = blockIdx.y * BM, rows = min(BM, B - row0);  // more than 64 queries: grid.y
  const int my_tiles =
      n_tiles > (int)blockIdx.x ? (n_tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int n_stages = my_tiles * n_kc;  // (tile, d-chunk) steps of this block

  // stage u: columns [kc KC, kc KC + KC) of the queries and of rows
  // [j0, j0 + BN) of segment z; d is a multiple of G, so a copy is all
  // inside d or all past it. The queries' chunk comes from L2 after the
  // first tile, in 4-byte granules (f32 rows of any d).
  auto issue = [&](int u) {
    const int tile = blockIdx.x + (u / n_kc) * gridDim.x, k0 = (u % n_kc) * KC;
    const int z = tile / tiles_per_seg, j0 = (tile % tiles_per_seg) * BN;
    float* qdst = reinterpret_cast<float*>(smem + (u % STAGES) * STAGE_BYTES);
    T* dst = reinterpret_cast<T*>(qdst + BM * KC);
    for (int i = threadIdx.x; i < BM * KC; i += NT) {
      const int r = i / KC, k = i % KC;
      const bool ok = r < rows && k0 + k < d;
      cp_async4(qdst + i, ok ? q + (size_t)(row0 + r) * d + k0 + k : q, ok ? 4 : 0);
    }
    const T* src = x + ((size_t)z * S + j0) * d + k0;
#pragma unroll 2
    for (int i = threadIdx.x; i < BN * (KC / G); i += NT) {
      const int r = i / (KC / G), k = G * (i % (KC / G));
      const bool ok = j0 + r < S && k0 + k < d;
      const T* from = ok ? src + (size_t)r * d + k : x;
      if constexpr (MODE == VEC16) {
        cp_async16(dst + r * KC + k, from, ok ? 16 : 0);
      } else if constexpr (MODE == VEC4) {
        cp_async4(dst + r * KC + k, from, ok ? 4 : 0);
      } else {
        dst[r * KC + k] = ok ? *from : T();
      }
    }
  };

#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < n_stages) issue(u);
    cp_async_commit();
  }

  float acc[8][8], xn[8], qn[8] = {};
  for (int u = 0; u < n_stages; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage u is in; stage u - 1's slot is free
    if (u + STAGES - 1 < n_stages) issue(u + STAGES - 1);
    cp_async_commit();

    const int kc = u % n_kc;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) xn[c] = 0.f;
    }
    const float* qst = reinterpret_cast<const float*>(smem + (u % STAGES) * STAGE_BYTES);
    const T* xst = reinterpret_cast<const T*>(qst + BM * KC);
    const float* qk = qst + ty * 8 * KC;
#pragma unroll
    for (int k4 = 0; k4 < KC / 4; ++k4) {
      float4 a[8], b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = ld4(qk + r * KC + 4 * k4);
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = ld4(xst + (tx + NX * c) * KC + 4 * k4);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
          acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
          acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
          acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
        }
      if (L2 && u < n_kc) {  // the queries' norms, once, over the block's first tile
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          qn[r] = fmaf(a[r].x, a[r].x, qn[r]);
          qn[r] = fmaf(a[r].y, a[r].y, qn[r]);
          qn[r] = fmaf(a[r].z, a[r].z, qn[r]);
          qn[r] = fmaf(a[r].w, a[r].w, qn[r]);
        }
      }
      if (L2) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          xn[c] = fmaf(b[c].x, b[c].x, xn[c]);
          xn[c] = fmaf(b[c].y, b[c].y, xn[c]);
          xn[c] = fmaf(b[c].z, b[c].z, xn[c]);
          xn[c] = fmaf(b[c].w, b[c].w, xn[c]);
        }
      }
    }

    if (kc == n_kc - 1) {  // the tile is done: write its scores
      const int tile = blockIdx.x + (u / n_kc) * gridDim.x;
      const int z = tile / tiles_per_seg, j0 = (tile % tiles_per_seg) * BN;
      float* oz = out + ((size_t)z * B + row0) * S;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty * 8 + r;
        if (i >= rows) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = j0 + tx + NX * c;
          if (j < S) oz[(size_t)i * S + j] = L2 ? qn[r] - 2.f * acc[r][c] + xn[c] : acc[r][c];
        }
      }
    }
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int MODE, bool L2, int BM>
int launch_bm(const float* q, const T* x, float* out, int B, int n_seg, int S, int d,
              cudaStream_t stream) {
  constexpr int BN = (NT / (BM / 8)) * 8;
  const int n_kc = (d + KC - 1) / KC, tiles_per_seg = (S + BN - 1) / BN;
  const int n_tiles = n_seg * tiles_per_seg;
  const int smem = STAGES * (BM * KC * 4 + BN * KC * (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(dist_kernel<T, MODE, L2, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles < sm_count() ? n_tiles : sm_count(), (B + BM - 1) / BM);
  dist_kernel<T, MODE, L2, BM><<<grid, NT, smem, stream>>>(q, x, out, B, S, d, n_kc,
                                                            tiles_per_seg, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_mode(const float* q, const T* x, float* out, int B, int n_seg, int S, int d, int l2,
                cudaStream_t st) {
  if (B <= 32)
    return l2 ? launch_bm<T, MODE, true, 32>(q, x, out, B, n_seg, S, d, st)
              : launch_bm<T, MODE, false, 32>(q, x, out, B, n_seg, S, d, st);
  return l2 ? launch_bm<T, MODE, true, 64>(q, x, out, B, n_seg, S, d, st)
            : launch_bm<T, MODE, false, 64>(q, x, out, B, n_seg, S, d, st);
}

}  // namespace

extern "C" int distance_f32(const float* q, const float* x, float* out, int B, int n_seg, int S,
                            int d, int l2, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (d % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0)
    return launch_mode<float, VEC16>(q, x, out, B, n_seg, S, d, l2, st);
  return launch_mode<float, VEC4>(q, x, out, B, n_seg, S, d, l2, st);
}

extern "C" int distance_bf16(const float* q, const __nv_bfloat16* x, float* out, int B,
                             int n_seg, int S, int d, int l2, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (d % 2 == 0 && reinterpret_cast<size_t>(x) % 4 == 0)
    return launch_mode<__nv_bfloat16, VEC4>(q, x, out, B, n_seg, S, d, l2, st);
  return launch_mode<__nv_bfloat16, SYNC>(q, x, out, B, n_seg, S, d, l2, st);
}

// dynamic shared memory of one block for a chunk of B queries (for reports;
// the same for any d)
extern "C" int distance_smem(int B) {
  const int bm = B <= 32 ? 32 : 64, bn = (NT / (bm / 8)) * 8;
  return STAGES * (bm * KC * 4 + bn * KC * 4);  // f32 storage
}
