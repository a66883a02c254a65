// Flash attention backward (causal or bidirectional, GQA, optional sliding
// window) for sm_90a.
//
// Replaces repro/kernels/flash_xla.py::_bwd, the custom VJP of the JAX
// package's block-scanned flash attention and its only attention gradient.
// From q, k, v, the forward's log-sum-exp lse and delta = rowsum(dO * O)
// (both (b, sq, hq) f32) it recomputes P = exp(S * scale - lse) tile by
// tile, never storing the (sq, sk) matrix, and computes
//   dV = P^T . dO,   dP = dO . V^T,   dS = P * (dP - delta),
//   dQ = dS . K * scale,   dK = dS^T . Q * scale,
// with dK and dV summed over the hq / hkv query heads that share a kv head.
// q, dout, dq are (b, sq, hq, dh) and k, v, dk, dv (b, sk, hkv, dh), all
// contiguous, f32 or bf16; every product and sum is f32 (dS stays f32 up to
// its products) and the gradients are written in the input type. Masks are
// the forward's: query i sits at position i + sk - sq, causal keeps keys at
// or before it, a window keeps keys after qpos - window; tiles that no pair
// of theirs can see are never visited.
//
// Bound on the H100 at glm4-9b's training shape (b 4, s 2048, 32 query heads
// over 2 kv heads, dh 128, causal): operations, five products over the
// visible half, 344 GFLOP, 0.35 ms at the bf16 tensor-core peak and 5.1 ms
// at the f32 CUDA-core peak. This first kernel runs on the f32 CUDA cores
// for both types (bf16 tiles are widened to f32 as they are staged), with
// no atomics, so a result is the same on every run. Two kernels:
//
// * dK/dV: one block per (batch, kv head, 64-key tile). K and V stay in
//   shared memory; the block walks the group's query heads and the query
//   tiles that can see its keys, stages Q, dO, lse and delta, recomputes S
//   and dP, and accumulates dV += P^T.dO and dK += dS^T.Q in registers, so
//   the GQA sum is done inside the block and written once.
// * dQ: one block per (batch, query head, 64-query tile). Q and dO stay;
//   the block walks the visible key tiles and accumulates dQ += dS.K.
//
// 256 threads; thread (ty, tx) holds the tile's rows 4ty..4ty+3 and columns
// tx + 16j of the 64 x 64 score tile, and output columns spread over tx.
// Tiles are staged as f32 rows padded to dh + 4 floats, so the float4 reads
// of 16 lanes hit distinct banks, as in the forward's f32 kernel. wgmma,
// TMA and a fused dK/dV-dQ pass are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr int LDP = BK + 4;  // row stride of the P and dS tiles in shared memory

struct Params {
  int b, sq, sk, hq, hkv, causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.sk && (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

// four consecutive elements as f32
__device__ __forceinline__ float4 load4(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// Rows [row0, row0 + 64) of one head (row stride in elements) into shared
// memory as f32 with row stride DH + 4; rows at or past n are zero.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int row0,
                                      int n) {
  constexpr int PER_ROW = DH / 4, LD = DH + 4;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = load4(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

// lse and delta of 64 query rows of head h; rows at or past sq get 0
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s, const float* lse,
                                           const float* delta, const Params& p, int bi, int h,
                                           int q0) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    const long long at = ((long long)bi * p.sq + qi) * p.hq + h;
    lse_s[threadIdx.x] = qi < p.sq ? lse[at] : 0.f;
    delta_s[threadIdx.x] = qi < p.sq ? delta[at] : 0.f;
  }
}

// s[i][j] = A[4ty + i] . B[tx + 16j] over the head dim (rows of stride DH + 4)
template <int DH>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float (&s)[4][4]) {
  constexpr int LD = DH + 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// P and dS of the (query tile q0, key tile k0) pair into shared memory
// (row = query, column = key); P only when Ps is not null. Pairs that the
// masks hide, and query rows past sq, get 0.
template <int DH>
__device__ __forceinline__ void probs_and_grads(const Params& p, const float* Qs, const float* Ks,
                                                const float* Vs, const float* dOs,
                                                const float* lse_s, const float* delta_s, int q0,
                                                int k0, float* Ps, float* dSs) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
  dot_tile<DH>(Qs, Ks, s);
  dot_tile<DH>(dOs, Vs, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r, qpos = qi + p.sk - p.sq;
    const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = qi < p.sq && visible(p, qpos, k0 + c);
      const float pv = ok ? expf(s[i][j] * p.scale - lse) : 0.f;
      if (Ps != nullptr) Ps[r * LDP + c] = pv;
      dSs[r * LDP + c] = pv * (dp[i][j] - delta);
    }
  }
}

// V consecutive floats from shared memory
template <int V>
__device__ __forceinline__ void lds(const float* p, float* d) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x;
    d[1] = t.y;
  } else {
    d[0] = *p;
  }
}

// output columns of thread tx: ch * 16 * VEC + tx * VEC + e
template <int DH>
struct Cols {
  static constexpr int VEC = DH >= 64 ? 4 : DH / 16;
  static constexpr int NCH = DH / (16 * VEC);
};

template <int DH>
constexpr int smem_floats(bool dkdv) {
  return 4 * 64 * (DH + 4) + (dkdv ? 2 : 1) * 64 * LDP + 2 * 64;
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (batch x kv head, key tile)
// ---------------------------------------------------------------------------
template <int DH, typename T>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            const Params p) {
  constexpr int LD = DH + 4, VEC = Cols<DH>::VEC, NCH = Cols<DH>::NCH;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int bi = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv, group = p.hq / p.hkv;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most queries: they start first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long kv_row = (long long)p.hkv * DH;
  stage<DH>(Ks, k + ((long long)bi * p.sk * p.hkv + hk) * DH, kv_row, k0, p.sk);
  stage<DH>(Vs, v + ((long long)bi * p.sk * p.hkv + hk) * DH, kv_row, k0, p.sk);

  // the query rows that can see a key of this tile
  const int off = p.sk - p.sq, kmax = min(k0 + BK, p.sk) - 1;
  const int i_lo = p.causal ? max(0, k0 - off) : 0;
  const int i_hi = p.window > 0 ? min(p.sq, kmax + p.window - off) : p.sq;

  float adk[4][DH / 16], adv[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) adk[i][c] = adv[i][c] = 0.f;

  const long long q_row = (long long)p.hq * DH;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qh = q + ((long long)bi * p.sq * p.hq + h) * DH;
    const T* doh = dout + ((long long)bi * p.sq * p.hq + h) * DH;
    for (int q0 = i_lo / BQ * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // K, V staged; the previous pair's tiles no longer read
      stage<DH>(Qs, qh, q_row, q0, p.sq);
      stage<DH>(dOs, doh, q_row, q0, p.sq);
      stage_rows(lse_s, delta_s, lse, delta, p, bi, h, q0);
      __syncthreads();
      probs_and_grads<DH>(p, Qs, Ks, Vs, dOs, lse_s, delta_s, q0, k0, Ps, dSs);
      __syncthreads();
      // keys 4ty..4ty+3 are the columns 4ty.. of P and dS
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(Ps + r * LDP + 4 * ty);
        const float4 dd = *reinterpret_cast<const float4*>(dSs + r * LDP + 4 * ty);
        const float pk[4] = {pp.x, pp.y, pp.z, pp.w}, dk4[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float ov[VEC], qv[VEC];
          lds<VEC>(dOs + r * LD + ch * 16 * VEC + tx * VEC, ov);
          lds<VEC>(Qs + r * LD + ch * 16 * VEC + tx * VEC, qv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              adv[i][ch * VEC + e] = fmaf(pk[i], ov[e], adv[i][ch * VEC + e]);
              adk[i][ch * VEC + e] = fmaf(dk4[i], qv[e], adk[i][ch * VEC + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.sk) continue;
    const long long at = (((long long)bi * p.sk + key) * p.hkv + hk) * DH;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = ch * 16 * VEC + tx * VEC + e;
        store(dk + at + c, adk[i][ch * VEC + e] * p.scale);
        store(dv + at + c, adv[i][ch * VEC + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch x query head, query tile)
// ---------------------------------------------------------------------------
template <int DH, typename T>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, const Params p) {
  constexpr int LD = DH + 4, VEC = Cols<DH>::VEC, NCH = Cols<DH>::NCH;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int n_qt = (p.sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;  // the longest causal rows start first
  const int bi = blockIdx.x / p.hq, h = blockIdx.x % p.hq, hk = h / (p.hq / p.hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q_row = (long long)p.hq * DH, kv_row = (long long)p.hkv * DH;
  stage<DH>(Qs, q + ((long long)bi * p.sq * p.hq + h) * DH, q_row, q0, p.sq);
  stage<DH>(dOs, dout + ((long long)bi * p.sq * p.hq + h) * DH, q_row, q0, p.sq);
  stage_rows(lse_s, delta_s, lse, delta, p, bi, h, q0);

  // the keys that any row of the tile can see
  const int first = p.sk - p.sq + q0, last = p.sk - p.sq + min(q0 + BQ, p.sq) - 1;
  const int hi = p.causal ? min(p.sk, last + 1) : p.sk;
  const int lo = p.window > 0 ? max(0, first - p.window + 1) : 0;
  const T* kh = k + ((long long)bi * p.sk * p.hkv + hk) * DH;
  const T* vh = v + ((long long)bi * p.sk * p.hkv + hk) * DH;

  float acc[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;

  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's K no longer read
    stage<DH>(Ks, kh, kv_row, k0, p.sk);
    stage<DH>(Vs, vh, kv_row, k0, p.sk);
    __syncthreads();
    probs_and_grads<DH>(p, Qs, Ks, Vs, dOs, lse_s, delta_s, q0, k0, nullptr, dSs);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(dSs + (ty * 4 + i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* krow = Ks + (c + cc) * LD + tx * VEC;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float kv[VEC];
          lds<VEC>(krow + ch * 16 * VEC, kv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][ch * VEC + e] = fmaf(ds, kv[e], acc[i][ch * VEC + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.sq) continue;
    T* row = dq + (((long long)bi * p.sq + qi) * p.hq + h) * DH;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(row + ch * 16 * VEC + tx * VEC + e, acc[i][ch * VEC + e] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int DH, typename T>
int launch_dh(const T* q, const T* k, const T* v, const T* dout, const float* lse,
              const float* delta, T* dq, T* dk, T* dv, const Params& p, cudaStream_t stream) {
  const int smem_kv = (int)sizeof(float) * smem_floats<DH>(true);
  const int smem_q = (int)sizeof(float) * smem_floats<DH>(false);
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dkdv<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_bwd_dq<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv(p.b * p.hkv, (p.sk + BK - 1) / BK);
  fa_bwd_dkdv<DH, T><<<grid_kv, NT, smem_kv, stream>>>(q, k, v, dout, lse, delta, dk, dv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(p.b * p.hq, (p.sq + BQ - 1) / BQ);
  fa_bwd_dq<DH, T><<<grid_q, NT, smem_q, stream>>>(q, k, v, dout, lse, delta, dq, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* dout, const float* lse,
           const float* delta, T* dq, T* dk, T* dv, int b, int sq, int sk, int hq, int hkv, int dh,
           int causal, int window, void* stream) {
  const Params p{b, sq, sk, hq, hkv, causal, window, (float)(1.0 / sqrt((double)dh))};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_dh<16>(q, k, v, dout, lse, delta, dq, dk, dv, p, st);
    case 32: return launch_dh<32>(q, k, v, dout, lse, delta, dq, dk, dv, p, st);
    case 64: return launch_dh<64>(q, k, v, dout, lse, delta, dq, dk, dv, p, st);
    case 128: return launch_dh<128>(q, k, v, dout, lse, delta, dq, dk, dv, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse, const float* delta,
                                       float* dq, float* dk, float* dv, int b, int sq, int sk,
                                       int hq, int hkv, int dh, int causal, int window,
                                       void* stream) {
  return launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, hq, hkv, dh, causal,
                       window, stream);
}

// bf16 storage; lse and delta f32
extern "C" int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                        const float* lse, const float* delta, __nv_bfloat16* dq,
                                        __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int sq,
                                        int sk, int hq, int hkv, int dh, int causal, int window,
                                        void* stream) {
  return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, hq, hkv, dh,
                               causal, window, stream);
}

// dynamic shared memory of one dK/dV block and one dQ block at head dim dh
extern "C" int flash_attention_bwd_smem(int dh, int dkdv) {
  const bool kv = dkdv != 0;
  switch (dh) {
    case 16: return (int)sizeof(float) * smem_floats<16>(kv);
    case 32: return (int)sizeof(float) * smem_floats<32>(kv);
    case 64: return (int)sizeof(float) * smem_floats<64>(kv);
    case 128: return (int)sizeof(float) * smem_floats<128>(kv);
    default: return -1;
  }
}
