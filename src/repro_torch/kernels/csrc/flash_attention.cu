// Flash attention forward (causal or bidirectional, GQA, optional sliding
// window) for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas.
// q (b, sq, hq, dh); k, v (b, sk, hkv, dh), read through their strides (the
// head dim contiguous); out (b, sq, hq, dh) contiguous, in q's type. One
// block per (batch x query head, 64-query tile); online softmax over the
// visible 64-key tiles with a running max m, normaliser l and accumulator per
// row, all f32. Key tiles that no query of the tile can see (above the causal
// diagonal, before the window) are never loaded. A row that sees no key
// gives 0. Two kernels, chosen by the storage type:
//
// * bf16 (the serving dtype): tensor cores, mma.sync m16n8k16 with f32
//   accumulation. Four warps own 16 query rows each, holding Q as A
//   fragments in registers. Q.K^T is exact bf16 products summed in f32. P is
//   split into bf16 hi + lo parts and multiplied into V twice, so it keeps
//   about 16 bits (the TPU kernel keeps P in f32); the error is far below
//   the bf16 rounding of the output. K is staged as it lies and V transposed,
//   so that every B fragment is one conflict-free 32-bit shared load.
// * f32: CUDA cores. 256 threads; thread (ty, tx) holds query rows
//   4ty..4ty+3, scores for keys tx + 16j and outputs for head-dim columns
//   spread over tx. Tiles are staged as f32 rows padded to dh + 4 floats, so
//   the float4 reads of 16 lanes hit distinct banks; a row's 64 scores live
//   on the 16 lanes of one half-warp, reduced with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BK = 64;

struct Params {
  int b, sq, sk, hq, hkv, causal, window;  // window <= 0: none
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;  // strides in elements
  float scale;
};

// The tile's place: batch, query head, kv head, first query row, and the
// keys [lo, hi) that any of its rows can see.
struct Tile {
  int bi, h, hk, q0, first, lo, hi;
};

__device__ __forceinline__ Tile locate(const Params& p) {
  Tile t;
  const int n_qt = (p.sq + BQ - 1) / BQ;
  t.q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;  // the longest causal rows start first
  t.bi = blockIdx.x / p.hq;
  t.h = blockIdx.x % p.hq;
  t.hk = t.h / (p.hq / p.hkv);
  t.first = p.sk - p.sq + t.q0;  // queries sit at the tail of the key axis
  const int last = p.sk - p.sq + min(t.q0 + BQ, p.sq) - 1;
  t.lo = 0;
  t.hi = p.sk;
  if (p.causal) t.hi = min(t.hi, last + 1);
  if (p.window > 0) t.lo = max(t.lo, t.first - p.window + 1);
  return t;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.sk && (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

// One online-softmax update of a row whose scores are spread over the lanes
// xor-reachable through `width` (every lane runs every shuffle): masks and
// scales s, turns it into exp(s - m_new), and returns the factor by which
// the row's earlier sum and accumulator shrink.
template <int N, int WIDTH>
__device__ __forceinline__ float softmax_update(float (&s)[N], const bool (&ok)[N], float scale,
                                                float& m, float& l) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = ok[j] ? s[j] * scale : -INFINITY;
    mx = fmaxf(mx, s[j]);
  }
#pragma unroll
  for (int w = WIDTH / 2; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  const float mnew = fmaxf(m, mx);
  const float alpha = mnew == -INFINITY ? 1.f : expf(m - mnew);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = s[j] == -INFINITY ? 0.f : expf(s[j] - mnew);
    sum += s[j];
  }
#pragma unroll
  for (int w = WIDTH / 2; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  l = l * alpha + sum;
  m = mnew;
  return alpha;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;  // four warps of 16 query rows

// d += a (16 x 16, row major) . b (16 x 8, column major); bf16 in, f32
// accumulate. Lane (g = lane / 4, t = lane % 4) holds two bf16 per 32-bit
// register, the lower column in the low half: a[0] row g, columns 2t..2t+1;
// a[1] row g + 8; a[2] row g, columns 2t+8..; a[3] row g + 8, columns
// 2t+8..; b0 rows 2t..2t+1 of column g, b1 rows 2t+8..; d[0..1] row g,
// columns 2t..2t+1; d[2..3] row g + 8.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// (x0, x1) as packed bf16 pairs hi + lo with hi + lo = x to about 16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = (unsigned)__bfloat16_as_ushort(h0) | ((unsigned)__bfloat16_as_ushort(h1) << 16);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

__device__ __forceinline__ unsigned lds32(const unsigned short* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int DH>
__global__ void __launch_bounds__(MMA_NT)
fa_fwd_bf16(const unsigned short* __restrict__ q, const unsigned short* __restrict__ k,
            const unsigned short* __restrict__ v, unsigned short* __restrict__ o, const Params p) {
  constexpr int LDK = DH + 8;  // row stride (bf16) of the K tile, [key][dh]
  constexpr int LDV = BK + 8;  // row stride (bf16) of the transposed V tile, [dh][key]
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  __shared__ __align__(16) unsigned short Ks[BK * LDK];
  __shared__ __align__(16) unsigned short Vt[DH * LDV];

  const Tile tl = locate(p);
  const unsigned short* qb = q + tl.bi * p.qsb + tl.h * p.qsh;
  const unsigned short* kb = k + tl.bi * p.ksb + tl.hk * p.ksh;
  const unsigned short* vb = v + tl.bi * p.vsb + tl.hk * p.vsh;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;

  // the warp's query rows g and g + 8 as A fragments, one per 16 head-dim columns
  const int r0 = tl.q0 + warp * 16 + g, r1 = r0 + 8;
  unsigned qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < p.sq ? __ldg(reinterpret_cast<const unsigned*>(qb + r0 * p.qss + c)) : 0u;
    qa[kk][1] = r1 < p.sq ? __ldg(reinterpret_cast<const unsigned*>(qb + r1 * p.qss + c)) : 0u;
    qa[kk][2] = r0 < p.sq ? __ldg(reinterpret_cast<const unsigned*>(qb + r0 * p.qss + c + 8)) : 0u;
    qa[kk][3] = r1 < p.sq ? __ldg(reinterpret_cast<const unsigned*>(qb + r1 * p.qss + c + 8)) : 0u;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = tl.lo / BK * BK; k0 < tl.hi; k0 += BK) {
    __syncthreads();  // the previous tile no longer read
    for (int i = threadIdx.x; i < BK * CH; i += MMA_NT) {  // K as it lies
      const int c = i / CH, d = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + c < p.sk) val = __ldg(reinterpret_cast<const uint4*>(kb + (k0 + c) * p.kss + d));
      *reinterpret_cast<uint4*>(Ks + c * LDK + d) = val;
    }
    for (int i = threadIdx.x; i < BK * CH; i += MMA_NT) {  // V transposed; a warp's lanes take consecutive keys
      const int c = i % BK, d = (i / BK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + c < p.sk) val = __ldg(reinterpret_cast<const uint4*>(vb + (k0 + c) * p.vss + d));
      const unsigned w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Vt[(d + 2 * e) * LDV + c] = (unsigned short)(w[e] & 0xffffu);
        Vt[(d + 2 * e + 1) * LDV + c] = (unsigned short)(w[e] >> 16);
      }
    }
    __syncthreads();

    // S = Q.K^T: the warp's 16 rows by the tile's keys, 8 keys per fragment
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const unsigned short* kr = Ks + (8 * j + g) * LDK + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // online softmax of rows g (i = 0) and g + 8 (i = 1); a row's scores live
    // on the four lanes of its quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = tl.first + warp * 16 + g + 8 * i;
      float row[BK / 4];
      bool ok[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          row[2 * j + e] = s[j][2 * i + e];
          ok[2 * j + e] = visible(p, qpos, k0 + 8 * j + 2 * t + e);
        }
      const float alpha = softmax_update<BK / 4, 4>(row, ok, p.scale, m[i], l[i]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * i] = row[2 * j];
        s[j][2 * i + 1] = row[2 * j + 1];
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }

    // O += P.V, 16 keys at a time: P's accumulator fragments are its A
    // fragments, split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const unsigned short* vr = Vt + (8 * n + g) * LDV + kk * 16 + 2 * t;
        const unsigned b0 = lds32(vr), b1 = lds32(vr + 8);
        mma_bf16(acc[n], ph, b0, b1);
        mma_bf16(acc[n], pl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tl.q0 + warp * 16 + g + 8 * i;
    if (r >= p.sq) continue;
    unsigned short* orow = o + (((long long)tl.bi * p.sq + r) * p.hq + tl.h) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const float a0 = l[i] > 0.f ? acc[n][2 * i] / l[i] : 0.f;
      const float a1 = l[i] > 0.f ? acc[n][2 * i + 1] / l[i] : 0.f;
      *reinterpret_cast<unsigned*>(orow + 8 * n + 2 * t) = pack_bf16(a0, a1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int NT = 256;
constexpr int LDP = BK + 4;  // row stride of the P tile in shared memory

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

// Rows [row0, row0 + 64) of one head into shared memory with row stride
// DH + 4; rows at or past n are zero.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, long long row_stride, int row0,
                                      int n) {
  constexpr int PER_ROW = DH / 4, LD = DH + 4;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c));
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

template <int DH>
__global__ void __launch_bounds__(NT, 2)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, const Params p) {
  constexpr int LD = DH + 4;
  constexpr int VEC = DH >= 64 ? 4 : DH / 16;  // output columns per shared-memory read
  constexpr int NCH = DH / (16 * VEC);         // such reads per row and key
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const Tile tl = locate(p);
  const float* kb = k + tl.bi * p.ksb + tl.hk * p.ksh;
  const float* vb = v + tl.bi * p.vsb + tl.hk * p.vsh;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<DH>(Qs, q + tl.bi * p.qsb + tl.h * p.qsh, p.qss, tl.q0, p.sq);
  float m[4], l[4], acc[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = tl.lo / BK * BK; k0 < tl.hi; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's V no longer read
    stage<DH>(KVs, kb, p.kss, k0, p.sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LD + d);
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = tl.first + ty * 4 + i;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[j] = visible(p, qpos, k0 + tx + 16 * j);
      const float alpha = softmax_update<4, 16>(s[i], ok, p.scale, m[i], l[i]);
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // K no longer read; P written
    stage<DH>(KVs, vb, p.vss, k0, p.sk);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = KVs + (c + cc) * LD + tx * VEC;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float vv[VEC];
          lds<VEC>(vrow + ch * 16 * VEC, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][ch * VEC + e] = fmaf(pv, vv[e], acc[i][ch * VEC + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tl.q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    float* orow = o + (((long long)tl.bi * p.sq + r) * p.hq + tl.h) * DH;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[ch * 16 * VEC + tx * VEC + e] = l[i] > 0.f ? acc[i][ch * VEC + e] / l[i] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int DH>
int launch_dh(const float* q, const float* k, const float* v, float* o, const Params& p,
              cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (BQ * (DH + 4) + BK * (DH + 4) + BQ * LDP);
  cudaError_t err =
      cudaFuncSetAttribute(fa_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.b * p.hq, (p.sq + BQ - 1) / BQ);
  fa_fwd_f32<DH><<<grid, NT, smem, stream>>>(q, k, v, o, p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const unsigned short* q, const unsigned short* k, const unsigned short* v,
              unsigned short* o, const Params& p, cudaStream_t stream) {
  const dim3 grid(p.b * p.hq, (p.sq + BQ - 1) / BQ);
  fa_fwd_bf16<DH><<<grid, MMA_NT, 0, stream>>>(q, k, v, o, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int b, int sq, int sk, int hq, int hkv,
           int dh, long long qsb, long long qss, long long qsh, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh, int causal, int window,
           void* stream) {
  const Params p{b,   sq,  sk,  hq,  hkv, causal, window, qsb, qss, qsh, ksb, kss,
                 ksh, vsb, vss, vsh, (float)(1.0 / sqrt((double)dh))};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_dh<16>(q, k, v, o, p, st);
    case 32: return launch_dh<32>(q, k, v, o, p, st);
    case 64: return launch_dh<64>(q, k, v, o, p, st);
    case 128: return launch_dh<128>(q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                   int b, int sq, int sk, int hq, int hkv, int dh, long long qsb,
                                   long long qss, long long qsh, long long ksb, long long kss,
                                   long long ksh, long long vsb, long long vss, long long vsh,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, b, sq, sk, hq, hkv, dh, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                       vsh, causal, window, stream);
}

// bf16 storage, passed as its 16-bit patterns
extern "C" int flash_attention_bf16(const unsigned short* q, const unsigned short* k,
                                    const unsigned short* v, unsigned short* o, int b, int sq,
                                    int sk, int hq, int hkv, int dh, long long qsb, long long qss,
                                    long long qsh, long long ksb, long long kss, long long ksh,
                                    long long vsb, long long vss, long long vsh, int causal,
                                    int window, void* stream) {
  return launch<unsigned short>(q, k, v, o, b, sq, sk, hq, hkv, dh, qsb, qss, qsh, ksb, kss, ksh,
                                vsb, vss, vsh, causal, window, stream);
}
