// Flash attention backward (causal or bidirectional, GQA, optional sliding
// window) for sm_90a.
//
// Replaces repro/kernels/flash_xla.py::_bwd, the custom VJP of the JAX
// package's block-scanned flash attention and its only attention gradient.
// From q, k, v, the forward's output O and log-sum-exp lse ((b, sq, hq) f32)
// and dO it recomputes P = exp(S * scale - lse) tile by tile, never storing
// the (sq, sk) matrix, and computes
//   delta = rowsum(dO * O),   dV = P^T . dO,   dP = dO . V^T,
//   dS = P * (dP - delta),    dQ = dS . K * scale,   dK = dS^T . Q * scale,
// with dK and dV summed over the hq / hkv query heads that share a kv head.
// q, dout, dq are (b, sq, hq, dh) and k, v, dk, dv (b, sk, hkv, dh). Masks
// are the forward's: query i sits at position i + sk - sq, causal keeps keys
// at or before it, a window keeps keys after qpos - window; tiles that no
// pair of theirs can see are never visited. No atomics anywhere: every sum
// has a fixed order, so a result is the same bits on every run.
//
// Bound on the H100 at glm4-9b's training shape (b 4, s 2048, 32 query heads
// over 2 kv heads, dh 128, causal): operations, five products over the
// visible half, 344 GFLOP, 0.35 ms at the bf16 tensor-core peak and 5.1 ms
// at the f32 CUDA-core peak. The bf16 path's dQ pass recomputes S and dP,
// so it runs seven products (481 GFLOP): one pass for all three gradients
// would have to sum dQ over the key blocks, which takes atomics (an order
// that varies) or a fixed-order hand-off between blocks. Two paths, by the
// storage type:
//
// * bf16 (the training dtype): the tensor cores, in four launches.
//   1. prep: delta from O and dO (read once through their strides), and
//      lse * log2(e), both into (b, hq, sq_pad) f32 rows of a workspace; a
//      row that sees no key (lse = -inf) and the padding get +inf, so their
//      P is 0 and their dq 0, never NaN.
//   2. dK/dV: a block owns 128 keys of one kv head (64 per consumer
//      warpgroup); TMA loads its K and V once. A producer warpgroup streams
//      64-row tiles of Q, dO and their lse/delta rows through a four-stage
//      ring over the block's query heads and every query tile that can see
//      its keys. The consumers compute S^T = K.Q^T and dP^T = V.dO^T by
//      wgmma from shared memory, P^T and dS^T in registers (lse and delta
//      indexed by column), then dV += P^T.dO and dK += dS^T.Q with P^T and
//      dS^T rounded once to bf16 as register A operands and dO, Q read as
//      they lie (transposed B). dK and dV stay in f32 registers over the
//      block's heads. To balance the causal wave, whose first key tiles see
//      the most queries, a group's query heads are split over nsplit blocks
//      (kernels/flash_attention.py::bwd_plan) that write f32 partials;
//   3. a short pass sums them in split order (with nsplit 1 the dK/dV
//      block writes bf16 itself).
//   4. dQ: the forward's block shape (128 query rows: G heads that share a
//      kv head times 128 / G positions, the longest causal rows first); K
//      and V tiles through a four-stage TMA ring; S = Q.K^T and dP = dO.V^T
//      by wgmma, dS = P * (dP - delta) rounded once to bf16, dQ += dS.K with
//      K read as it lies. The two consumer warpgroups take turns to issue S
//      and dP, so one's exponentials overlap the other's products.
//   Each tile's products are committed as separate groups, so that P's
//   exponentials run under the dP product. Masks are applied only on tiles
//   at the causal diagonal, the window's edge or a ragged end, in a branch
//   of their own: folded into the exponential loop they cost a fifth of the
//   kernel time. Every sum is f32; P and dS are rounded to bf16 only as
//   operands of their products, as FlashAttention-2 and -3 do, and each
//   gradient once. Head dims below 64 are zero-padded to 64 by the loads,
//   and 80 to 128 (TMA fills the second box's columns past dh with zeros).
//   q, k, v, dout and out are read through their strides (16-byte
//   multiples; the wrapper copies anything else).
// * f32: the f32 CUDA cores (TF32 would break the f32 parity), all inputs
//   contiguous, delta from the wrapper. Two kernels: dK/dV per (batch, kv
//   head, 64-key tile) walking the group's query heads with the GQA sum in
//   registers, and dQ per (batch, query head, 64-query tile). 256 threads;
//   thread (ty, tx) holds the tile's rows 4ty..4ty+3 and columns tx + 16j
//   of the 64 x 64 score tile, and output columns spread over tx. Tiles are
//   staged as f32 rows padded to dh + 4 floats, so the float4 reads of 16
//   lanes hit distinct banks, as in the forward's f32 kernel.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr int LDP = BK + 4;  // row stride of the P and dS tiles in shared memory

struct Params {
  int b, sq, sk, hq, hkv, causal, window;  // window <= 0: none
  float scale;
  int sq_pad, nsplit;  // bf16 only: lse/delta rows padded to sq_pad; blocks per key tile's group
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.sk && (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

// four consecutive elements as f32
__device__ __forceinline__ float4 load4(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

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
  static constexpr int VEC = (DH / 16) % 4 == 0 ? 4 : (DH / 16) % 2 == 0 ? 2 : 1;  // 1 at DH 80
  static constexpr int NCH = DH / (16 * VEC);
};

template <int DH>
constexpr int smem_floats(bool dkdv) {
  return 4 * 64 * (DH + 4) + (dkdv ? 2 : 1) * 64 * LDP + 2 * 64;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. dK, dV: one block per (batch x kv head, key tile)
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
// f32: dQ, one block per (batch x query head, query tile)
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
    case 80: return launch_dh<80>(q, k, v, dout, lse, delta, dq, dk, dv, p, st);
    case 128: return launch_dh<128>(q, k, v, dout, lse, delta, dq, dk, dv, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on tiles that TMA brings in
// ---------------------------------------------------------------------------

// the two consumer warpgroups' turns (barriers 1 and 2 over their 256
// threads; 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// 2^x on the MUFU unit without exp2f's range handling (denormal results
// flush to 0; -inf gives 0). dQ's consumers use it; in dK/dV it cost time.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (lo in the low half) by one cvt.rn.bf16x2
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WB_THREADS = 384;  // warpgroups 0-1 consume (wgmma), warpgroup 2 produces (TMA)
constexpr int WB_CONSUMER_WARPS = 8;
constexpr int DQ_ROWS = 128, DQ_STAGES = 4;  // query rows of a dQ block; K/V tiles in flight
constexpr int KV_KEYS = 128, KV_STAGES = 4;  // keys of a dK/dV block; Q/dO tiles in flight
// registers per thread after the split (setmaxnreg): 128 x 40 + 256 x 232 and
// 128 x 24 + 256 x 240 fit the SM's 65,536. The dK/dV consumers hold dK and
// dV (64 + 64 at dh 128) besides S^T and dP^T (32 + 32).
constexpr int DQ_PRODUCER_REGS = 40, DQ_CONSUMER_REGS = 232;
constexpr int KV_PRODUCER_REGS = 24, KV_CONSUMER_REGS = 240;

__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

// lanes of a prep row: DH / 8 of 16 bytes each, rounded up to a power of
// two so that a row's lanes reduce by xor shuffles within a warp (16 at DH
// 80, the last six idle)
__host__ __device__ constexpr int prep_lanes(int dh) {
  return dh <= 16 ? 2 : dh <= 32 ? 4 : dh <= 64 ? 8 : 16;
}

// Pass 1: delta = rowsum(dO * O) and lse * log2(e) of every (batch, head,
// query) row into (b, hq, sq_pad) f32; prep_lanes(DH) lanes a row.
// Rows that see no key and rows past sq get lse2 = +inf and delta = 0.
template <int DH>
__global__ void __launch_bounds__(256)
fa_bwd_prep(const unsigned short* __restrict__ o, const unsigned short* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
            const Params p, long long osb, long long oss, long long osh, long long dsb, long long dss,
            long long dsh) {
  constexpr int L = prep_lanes(DH);
  const long long n_rows = (long long)p.b * p.hq * p.sq_pad;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  const bool live = row < n_rows;
  const int i = live ? (int)(row % p.sq_pad) : 0;
  const int h = live ? (int)(row / p.sq_pad % p.hq) : 0;
  const int bi = live ? (int)(row / ((long long)p.sq_pad * p.hq)) : 0;
  float acc = 0.f;
  if (live && i < p.sq && 8 * lane < DH) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + bi * osb + i * oss + h * osh + 8 * lane));
    const uint4 d = __ldg(reinterpret_cast<const uint4*>(dout + bi * dsb + i * dss + h * dsh + 8 * lane));
    const unsigned av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc = fmaf(bf16_lo(av[c]), bf16_lo(dv[c]), acc);
      acc = fmaf(bf16_hi(av[c]), bf16_hi(dv[c]), acc);
    }
  }
#pragma unroll
  for (int w = L / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (live && lane == 0) {
    float l2 = INFINITY, dl = 0.f;
    if (i < p.sq) {
      const float l = lse[((long long)bi * p.sq + i) * p.hq + h];
      l2 = l == -INFINITY ? INFINITY : l * LOG2E;
      dl = acc;
    }
    lse2[row] = l2;
    delta[row] = dl;
  }
}

// Pass 3: the nsplit f32 partials of dK and dV (part: [2][nsplit][n]) summed
// in split order and rounded once to bf16; four elements a thread.
__global__ void __launch_bounds__(256)
fa_bwd_sum(const float* __restrict__ part, unsigned short* __restrict__ dk,
           unsigned short* __restrict__ dv, long long n, int nsplit) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* src = part + which * nsplit * n + e;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int sp = 1; sp < nsplit; ++sp) {
      const float4 t = *reinterpret_cast<const float4*>(src + sp * n);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *reinterpret_cast<uint2*>((which ? dv : dk) + e) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
  }
}

// Shared memory of a dQ block, each piece 1024-byte aligned for the 128-byte
// swizzle: Q and dO (NB column blocks of 128 rows x 64 each), DQ_STAGES
// stages of K and V (NB column blocks of 64 keys x 64 each), the barriers.
template <int NB>
struct DqLayout {
  static constexpr int Q_BYTES = NB * DQ_ROWS * 128;
  static constexpr int KV_BYTES = NB * BK * 128;  // one of K or V, one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = 2 * Q_BYTES + DQ_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * DQ_STAGES + 1) + 1024;  // + alignment slack
};

// Shared memory of a dK/dV block: K and V (NB column blocks of 128 keys x 64
// each), then KV_STAGES stages of Q and dO (NB column blocks of 64 rows x 64
// each) with the rows' lse2 and delta (2 x 256 bytes, the stage padded to a
// multiple of 1024), the barriers.
template <int NB>
struct KvLayout {
  static constexpr int KV_BYTES = NB * KV_KEYS * 128;
  static constexpr int QT_BYTES = NB * BQ * 128;  // one of Q or dO, one stage
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + 1024;
  static constexpr int STAGE_TX = 2 * QT_BYTES + 2 * BQ * 4;  // bytes a stage's loads bring
  static constexpr int BAR_OFF = 2 * KV_BYTES + KV_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * KV_STAGES + 1) + 1024;
};

// Pass 4: dQ of 128 query rows, G = g query heads of one kv head times 128 /
// g positions (block row r is position q0 + r / g of head h0 + r % g), over
// the key tiles that any of them can see.
template <int DH>
__global__ void __launch_bounds__(WB_THREADS, 1)
fa_bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               unsigned short* __restrict__ dq, const Params p, const int g) {
  constexpr int NB = DH > 64 ? 2 : 1;  // 64-column blocks of the head dim (DH < 64 zero-padded)
  using L = DqLayout<NB>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned q_s = base, do_s = base + L::Q_BYTES, kv_s = base + 2 * L::Q_BYTES;
  // barriers: full[s] at bars + 8s, empty[s] at bars + 8 (STAGES + s), Q's and dO's at the end
  const unsigned bars = base + L::BAR_OFF, q_bar = bars + 16 * DQ_STAGES;

  const int rows = DQ_ROWS / g, group = p.hq / p.hkv, n_hg = group / g;
  const int n_qt = (p.sq + rows - 1) / rows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * rows;  // the longest causal rows start first
  const int bi = blockIdx.x / (p.hkv * n_hg), rest = blockIdx.x % (p.hkv * n_hg);
  const int hk = rest / n_hg, h0 = hk * group + (rest % n_hg) * g;
  const int off = p.sk - p.sq;  // queries sit at the tail of the key axis
  const int pmin = off + q0, pmax = off + min(q0 + rows, p.sq) - 1;
  const int lo = p.window > 0 ? max(0, pmin - p.window + 1) : 0;
  const int hi = p.causal ? min(p.sk, pmax + 1) : p.sk;
  const int kt0 = lo / BK * BK;
  const int n_tiles = hi > kt0 ? (hi - kt0 + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                                     // the producer's expect_tx
      mbar_init(bars + 8 * (DQ_STAGES + s), WB_CONSUMER_WARPS);  // one arrive per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WB_CONSUMER_WARPS) {  // producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DQ_PRODUCER_REGS));
    if (warp == WB_CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(q_bar, 2 * L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(q_s + nb * DQ_ROWS * 128, &qmap, q_bar, 64 * nb, h0, q0, bi);
        tma_load_4d(do_s + nb * DQ_ROWS * 128, &domap, q_bar, 64 * nb, h0, q0, bi);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % DQ_STAGES;
        const unsigned full = bars + 8 * s, empty = bars + 8 * (DQ_STAGES + s);
        mbar_wait(empty, ((it / DQ_STAGES) & 1) ^ 1);  // the stage's previous tile released
        mbar_expect_tx(full, L::STAGE_BYTES);
        const unsigned ks = kv_s + s * L::STAGE_BYTES, vs = ks + L::KV_BYTES;
        const int k0 = kt0 + it * BK;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(ks + nb * BK * 128, &kmap, full, 64 * nb, hk, k0, bi);
          tma_load_4d(vs + nb * BK * 128, &vmap, full, 64 * nb, hk, k0, bi);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DQ_CONSUMER_REGS));
  // consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63; this warp
  // rows 16 wq + gq and + 8 of them, as in the mma fragments
  const int wg = warp / 4, wq = warp % 4, gq = lane / 4, t = lane % 4;
  int qpos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * wg + 16 * wq + gq + 8 * i;
    qpos[i] = off + q0 + r / g;
    const long long at = ((long long)bi * p.hq + h0 + r % g) * p.sq_pad + q0 + r / g;
    l2[i] = lse2[at];
    dl[i] = delta[at];
  }
  const float scale2 = p.scale * LOG2E;  // scores in the log2 domain: exp2f
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  const unsigned q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;
  mbar_wait(q_bar, 0);
  // Per tile three groups of wgmma: S, dP, then dQ += dS.K. P's exponentials
  // run under dP. The two warpgroups take turns to issue S and dP (ping-pong),
  // so one's exponentials and dS overlap the other's products.
  if (wg == 1 && n_tiles > 0) named_arrive(1);  // warpgroup 0 issues first
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % DQ_STAGES, k0 = kt0 + it * BK;
    const unsigned ks = kv_s + s * L::STAGE_BYTES, vs = ks + L::KV_BYTES;
    mbar_wait(bars + 8 * s, (it / DQ_STAGES) & 1);
    float sc[32], dp[32];
    named_sync(1 + wg);  // this warpgroup's turn
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const unsigned o16 = (kk / 4) * DQ_ROWS * 128 + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_wg + o16), sw128_desc(ks + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const unsigned o16 = (kk / 4) * DQ_ROWS * 128 + (kk % 4) * 32;
      wgmma_ss_n64(dp, sw128_desc(do_wg + o16), sw128_desc(vs + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    if (wg == 0 || it + 1 < n_tiles) named_arrive(2 - wg);  // the other's turn
    wgmma_wait<1>();  // S
    fence_regs(sc);
    // sc[4j + 2i + e]: row i (gq, gq + 8), key k0 + 8j + 2t + e. Only tiles
    // on the causal diagonal, at the window's edge or past sk are masked,
    // in a branch of their own.
    const bool edge = k0 + BK > p.sk || (p.causal && k0 + BK - 1 > pmin) ||
                      (p.window > 0 && k0 < pmax - p.window + 1);
    float pf[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          pf[x] = fast_exp2(fmaf(sc[x], scale2, -l2[i]));
        }
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!visible(p, qpos[i], k0 + 8 * j + 2 * t + e)) pf[4 * j + 2 * i + e] = 0.f;
    }
    wgmma_wait<0>();  // dP
    fence_regs(dp);
    // dQ += dS.K: dS = P * (dP - delta) in the accumulator fragments is the A
    // operand, rounded once to bf16; K's tile is read as it lies (MN-major)
    unsigned da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int x = 8 * kk + 2 * f, i = f % 2;
        da[kk][f] = pack2(pf[x] * (dp[x] - dl[i]), pf[x + 1] * (dp[x + 1] - dl[i]));
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) wgmma_rs_n64_tb(acc[nb], da[kk], sw128_desc(ks + nb * BK * 128 + kk * 2048));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (DQ_STAGES + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * wg + 16 * wq + gq + 8 * i, qr = q0 + r / g;
    if (qr >= p.sq) continue;
    unsigned short* row = dq + (((long long)bi * p.sq + qr) * p.hq + h0 + r % g) * DH;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * nb + 8 * j + 2 * t;
        if (c < DH)
          *reinterpret_cast<unsigned*>(row + c) =
              pack2(acc[nb][4 * j + 2 * i] * p.scale, acc[nb][4 * j + 2 * i + 1] * p.scale);
      }
  }
}

// Pass 2: dK and dV of 128 keys of one kv head over the block's share of the
// group's query heads (heads h_first .. h_first + group / nsplit - 1) and
// every 64-row query tile that can see one of the keys.
template <int DH>
__global__ void __launch_bounds__(WB_THREADS, 1)
fa_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 unsigned short* __restrict__ dk, unsigned short* __restrict__ dv,
                 float* __restrict__ part, const Params p) {
  constexpr int NB = DH > 64 ? 2 : 1;
  using L = KvLayout<NB>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const unsigned k_s = base, v_s = base + L::KV_BYTES, st_s = base + 2 * L::KV_BYTES;
  const unsigned bars = base + L::BAR_OFF, kv_bar = bars + 16 * KV_STAGES;

  const int group = p.hq / p.hkv, hps = group / p.nsplit;
  const int k0 = blockIdx.y * KV_KEYS;  // the first key tiles see the most causal queries: they start first
  const int bi = blockIdx.x / (p.hkv * p.nsplit), rest = blockIdx.x % (p.hkv * p.nsplit);
  const int hk = rest / p.nsplit, split = rest % p.nsplit, h_first = hk * group + split * hps;
  // the query rows that can see a key of this block, in tiles of 64
  const int off = p.sk - p.sq, kmax = min(k0 + KV_KEYS, p.sk) - 1;
  const int i_lo = p.causal ? max(0, k0 - off) : 0;
  const int i_hi = p.window > 0 ? min(p.sq, kmax + p.window - off) : p.sq;
  const int t_lo = i_lo / BQ, n_qt = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - t_lo : 0;
  const int n_iter = hps * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (KV_STAGES + s), WB_CONSUMER_WARPS);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WB_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(KV_PRODUCER_REGS));
    if (warp == WB_CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * L::KV_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(k_s + nb * KV_KEYS * 128, &kmap, kv_bar, 64 * nb, hk, k0, bi);
        tma_load_4d(v_s + nb * KV_KEYS * 128, &vmap, kv_bar, 64 * nb, hk, k0, bi);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % KV_STAGES;
        const unsigned full = bars + 8 * s, empty = bars + 8 * (KV_STAGES + s);
        mbar_wait(empty, ((it / KV_STAGES) & 1) ^ 1);
        mbar_expect_tx(full, L::STAGE_TX);
        const int h = h_first + it / n_qt, q0 = (t_lo + it % n_qt) * BQ;
        const unsigned sb = st_s + s * L::STAGE_BYTES;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sb + nb * BQ * 128, &qmap, full, 64 * nb, h, q0, bi);
          tma_load_4d(sb + L::QT_BYTES + nb * BQ * 128, &domap, full, 64 * nb, h, q0, bi);
        }
        const long long at = ((long long)bi * p.hq + h) * p.sq_pad + q0;
        bulk_load(sb + 2 * L::QT_BYTES, lse2 + at, BQ * 4, full);
        bulk_load(sb + 2 * L::QT_BYTES + BQ * 4, delta + at, BQ * 4, full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(KV_CONSUMER_REGS));
  // consumers: warpgroup wg owns keys kw0 .. kw0 + 63; this warp keys
  // 16 wq + gq and + 8 of them (accumulator rows); columns are query rows
  const int wg = warp / 4, wq = warp % 4, gq = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = kw0 + 16 * wq + gq + 8 * i;
  const float scale2 = p.scale * LOG2E;
  float adk[NB][32], adv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) adk[nb][e] = adv[nb][e] = 0.f;

  const unsigned k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;
  mbar_wait(kv_bar, 0);
  // Per tile four groups of wgmma: S^T, dP^T, dV += P^T.dO, dK += dS^T.Q.
  // P^T's exponentials run under dP^T, dS^T under dV's product. (Taking
  // turns between the warpgroups, as dQ does, cost time here.)
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % KV_STAGES, q0 = (t_lo + it % n_qt) * BQ;
    const unsigned sb = st_s + s * L::STAGE_BYTES, dob = sb + L::QT_BYTES;
    mbar_wait(bars + 8 * s, (it / KV_STAGES) & 1);
    // S^T = K.Q^T and dP^T = V.dO^T (64 keys x 64 query rows)
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const unsigned o16 = (kk % 4) * 32;
      wgmma_ss_n64(st, sw128_desc(k_wg + (kk / 4) * KV_KEYS * 128 + o16),
                   sw128_desc(sb + (kk / 4) * BQ * 128 + o16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const unsigned o16 = (kk % 4) * 32;
      wgmma_ss_n64(dpt, sw128_desc(v_wg + (kk / 4) * KV_KEYS * 128 + o16),
                   sw128_desc(dob + (kk / 4) * BQ * 128 + o16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_regs(st);
    // st[4j + 2i + e]: key i (gq, gq + 8), query row q0 + 8j + 2t + e, whose
    // lse2 and delta the producer staged beside the tile
    const float* rows = reinterpret_cast<const float*>(smem_raw + (sb - raw) + 2 * L::QT_BYTES);
    const bool edge = kw0 + 64 > p.sk || (p.causal && kw0 + 63 > q0 + off) ||
                      (p.window > 0 && kw0 <= q0 + BQ - 1 + off - p.window);
    float pf[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lj = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          pf[x] = exp2f(fmaf(st[x], scale2, -(e ? lj.y : lj.x)));
        }
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!visible(p, q0 + off + 8 * j + 2 * t + e, key[i])) pf[4 * j + 2 * i + e] = 0.f;
    }
    // dV += P^T.dO, 16 query rows a wgmma: P^T's accumulator fragments are
    // the A fragments (kk = j / 2, register (j % 2) * 2 + i), rounded to
    // bf16; dO is read as it lies (MN-major)
    unsigned pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) pa[kk][f] = pack2(pf[8 * kk + 2 * f], pf[8 * kk + 2 * f + 1]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(adv[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) wgmma_rs_n64_tb(adv[nb], pa[kk], sw128_desc(dob + nb * BQ * 128 + kk * 2048));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T; dV's product may still read pa
    fence_regs(dpt);
    // dK += dS^T.Q, dS^T = P^T * (dP^T - delta) rounded once to bf16
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dj = *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        da[j / 2][(j % 2) * 2 + i] = pack2(pf[4 * j + 2 * i] * (dpt[4 * j + 2 * i] - dj.x),
                                               pf[4 * j + 2 * i + 1] * (dpt[4 * j + 2 * i + 1] - dj.y));
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(adk[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) wgmma_rs_n64_tb(adk[nb], da[kk], sw128_desc(sb + nb * BQ * 128 + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(adk[nb]);
      fence_regs(adv[nb]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // kept live until their products are done
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (KV_STAGES + s));
  }

  // dK (scaled) and dV: bf16 into dk, dv when one block holds the whole
  // group, else f32 partials of this split for pass 3
  const long long n = (long long)p.b * p.sk * p.hkv * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.sk) continue;
    const long long at = (((long long)bi * p.sk + key[i]) * p.hkv + hk) * DH;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * nb + 8 * j + 2 * t;
        if (c >= DH) continue;
        const float k0v = adk[nb][4 * j + 2 * i] * p.scale, k1v = adk[nb][4 * j + 2 * i + 1] * p.scale;
        const float v0v = adv[nb][4 * j + 2 * i], v1v = adv[nb][4 * j + 2 * i + 1];
        if (p.nsplit == 1) {
          *reinterpret_cast<unsigned*>(dk + at + c) = pack2(k0v, k1v);
          *reinterpret_cast<unsigned*>(dv + at + c) = pack2(v0v, v1v);
        } else {
          *reinterpret_cast<float2*>(part + split * n + at + c) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(part + (p.nsplit + split) * n + at + c) = make_float2(v0v, v1v);
        }
      }
  }
}

template <int DH>
int launch_bf16(const unsigned short* q, const unsigned short* k, const unsigned short* v,
                const unsigned short* o, const unsigned short* dout, const float* lse, float* ws,
                unsigned short* dq, unsigned short* dk, unsigned short* dv, const Params& p,
                const long long* st, cudaStream_t stream) {
  constexpr int NB = DH > 64 ? 2 : 1;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const long long rows = (long long)p.b * p.hq * p.sq_pad;
  float* lse2 = ws;
  float* delta = ws + rows;
  float* part = ws + 2 * rows;
  // st: q, k, v, out, dout strides (batch, sequence, head) in elements
  const long long *qs = st, *ks = st + 3, *vs = st + 6, *os = st + 9, *ds = st + 12;

  // 1. delta and lse2
  const long long threads = rows * prep_lanes(DH);
  fa_bwd_prep<DH><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      o, dout, lse, lse2, delta, p, os[0], os[1], os[2], ds[0], ds[1], ds[2]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // 2. dK/dV (3. their sum when the group is split)
  CUtensorMap qmap, domap, kmap, vmap;
  int err = bf16_map(&qmap, enc, q, DH, p.hq, p.sq, p.b, qs[2], qs[1], qs[0], 1, BQ);
  if (!err) err = bf16_map(&domap, enc, dout, DH, p.hq, p.sq, p.b, ds[2], ds[1], ds[0], 1, BQ);
  if (!err) err = bf16_map(&kmap, enc, k, DH, p.hkv, p.sk, p.b, ks[2], ks[1], ks[0], 1, KV_KEYS);
  if (!err) err = bf16_map(&vmap, enc, v, DH, p.hkv, p.sk, p.b, vs[2], vs[1], vs[0], 1, KV_KEYS);
  if (err) return err;
  int smem = KvLayout<NB>::BYTES;
  e = cudaFuncSetAttribute(fa_bwd_dkdv_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv(p.b * p.hkv * p.nsplit, (p.sk + KV_KEYS - 1) / KV_KEYS);
  fa_bwd_dkdv_bf16<DH><<<grid_kv, WB_THREADS, smem, stream>>>(qmap, domap, kmap, vmap, lse2, delta, dk,
                                                              dv, part, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (p.nsplit > 1) {
    const long long n = (long long)p.b * p.sk * p.hkv * DH;
    fa_bwd_sum<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(part, dk, dv, n, p.nsplit);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  // 4. dQ
  const int group = p.hq / p.hkv;
  const int g = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;  // query heads sharing a block's K/V
  const int rows_q = DQ_ROWS / g;                             // query rows per head
  err = bf16_map(&qmap, enc, q, DH, p.hq, p.sq, p.b, qs[2], qs[1], qs[0], g, rows_q);
  if (!err) err = bf16_map(&domap, enc, dout, DH, p.hq, p.sq, p.b, ds[2], ds[1], ds[0], g, rows_q);
  if (!err) err = bf16_map(&kmap, enc, k, DH, p.hkv, p.sk, p.b, ks[2], ks[1], ks[0], 1, BK);
  if (!err) err = bf16_map(&vmap, enc, v, DH, p.hkv, p.sk, p.b, vs[2], vs[1], vs[0], 1, BK);
  if (err) return err;
  smem = DqLayout<NB>::BYTES;
  e = cudaFuncSetAttribute(fa_bwd_dq_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q(p.b * p.hkv * (group / g), (p.sq + rows_q - 1) / rows_q);
  fa_bwd_dq_bf16<DH><<<grid_q, WB_THREADS, smem, stream>>>(qmap, domap, kmap, vmap, lse2, delta, dq, p, g);
  return (int)cudaGetLastError();
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

// bf16 storage, passed as its 16-bit patterns; lse f32. dims: b, sq, sk, hq,
// hkv, dh, causal, window (0: none), nsplit, sq_pad, then the (batch,
// sequence, head) strides in elements of q, k, v, out and dout. ws: f32
// workspace of 2 b hq sq_pad floats, plus 2 nsplit b sk hkv dh when nsplit > 1
// (kernels/flash_attention.py::bwd_plan).
extern "C" int flash_attention_bwd_bf16(const unsigned short* q, const unsigned short* k,
                                        const unsigned short* v, const unsigned short* out,
                                        const unsigned short* dout, const float* lse, float* ws,
                                        unsigned short* dq, unsigned short* dk, unsigned short* dv,
                                        const long long* dims, void* stream) {
  const int dh = (int)dims[5];
  Params p{(int)dims[0], (int)dims[1], (int)dims[2], (int)dims[3], (int)dims[4], (int)dims[6],
           (int)dims[7], (float)(1.0 / sqrt((double)dh)), (int)dims[9], (int)dims[8]};
  const int group = p.hkv > 0 ? p.hq / p.hkv : 0;
  if (p.nsplit < 1 || group % p.nsplit || p.sq_pad % 128 || p.sq_pad < p.sq) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_bf16<16>(q, k, v, out, dout, lse, ws, dq, dk, dv, p, dims + 10, st);
    case 32: return launch_bf16<32>(q, k, v, out, dout, lse, ws, dq, dk, dv, p, dims + 10, st);
    case 64: return launch_bf16<64>(q, k, v, out, dout, lse, ws, dq, dk, dv, p, dims + 10, st);
    case 80: return launch_bf16<80>(q, k, v, out, dout, lse, ws, dq, dk, dv, p, dims + 10, st);
    case 128: return launch_bf16<128>(q, k, v, out, dout, lse, ws, dq, dk, dv, p, dims + 10, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one f32 dK/dV block and one f32 dQ block at head dim dh
extern "C" int flash_attention_bwd_smem(int dh, int dkdv) {
  const bool kv = dkdv != 0;
  switch (dh) {
    case 16: return (int)sizeof(float) * smem_floats<16>(kv);
    case 32: return (int)sizeof(float) * smem_floats<32>(kv);
    case 64: return (int)sizeof(float) * smem_floats<64>(kv);
    case 80: return (int)sizeof(float) * smem_floats<80>(kv);
    case 128: return (int)sizeof(float) * smem_floats<128>(kv);
    default: return -1;
  }
}

// dynamic shared memory of one bf16 dK/dV block and one bf16 dQ block at head dim dh
extern "C" int flash_attention_bwd_bf16_smem(int dh, int dkdv) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 80 && dh != 128) return -1;
  if (dh > 64) return dkdv ? KvLayout<2>::BYTES : DqLayout<2>::BYTES;
  return dkdv ? KvLayout<1>::BYTES : DqLayout<1>::BYTES;
}
