// Flash attention forward (causal or bidirectional, GQA, optional sliding
// window) for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas.
// q (b, sq, hq, dh); k, v (b, sk, hkv, dh), read through their strides (the
// head dim contiguous); out (b, sq, hq, dh) contiguous, in q's type. Online
// softmax over the visible 64-key tiles with a running max m, normaliser l
// and accumulator per row, all f32. Key tiles that no query of the block can
// see (above the causal diagonal, before the window) are never loaded. A row
// that sees no key gives 0. Two kernels, chosen by the storage type:
//
// * bf16 (the serving dtype): bound by the tensor cores. A block holds 128
//   query rows: G = 4 (or 2, 1) query heads that share one kv head times
//   128 / G positions, so each K/V tile is loaded once for G heads. Three
//   warpgroups split their registers with setmaxnreg. Warpgroup 2 produces:
//   one lane issues TMA loads of Q once and of K and V tiles into a ring of
//   four stages (mbarriers count the bytes in and the consumer warps out).
//   Warpgroups 0 and 1 consume, 64 rows each: S = Q.K^T by wgmma with both
//   operands in shared memory (the 128-byte swizzle that TMA writes); the
//   next tile's S is issued before this tile's online softmax, so the two
//   overlap; masks only on tiles at the causal diagonal, the window's edge
//   or past sk; then O += P.V by wgmma with P from registers, rounded once
//   to bf16 (in [0, 1]; the row sums stay f32), and V's tile read as it
//   lies through the transposed-B layout. Head dims below 64 are zero-padded
//   to 64 by the loads. Strided views need only 16-byte-multiple strides,
//   which TMA describes.
// * f32: CUDA cores. 256 threads per (batch x query head, 64-query tile);
//   thread (ty, tx) holds query rows 4ty..4ty+3, scores for keys tx + 16j
//   and outputs for head-dim columns spread over tx. Tiles are staged as f32
//   rows padded to dh + 4 floats, so the float4 reads of 16 lanes hit
//   distinct banks; a row's 64 scores live on the 16 lanes of one half-warp,
//   reduced with shuffles.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
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
// bf16: wgmma on tiles that TMA brings into a ring in shared memory
// ---------------------------------------------------------------------------
constexpr int HB_ROWS = 128;   // query rows of a block: two consumer warpgroups of 64
constexpr int HB_STAGES = 4;   // K/V tiles in flight
constexpr int HB_THREADS = 384;  // warpgroups 0-1 consume (wgmma), warpgroup 2 produces (TMA)
constexpr int HB_CONSUMER_WARPS = 8;
// registers per thread after the split (setmaxnreg): the producer needs few,
// the consumers hold S, its successor, P and O; 128 x 40 + 256 x 232 fits
// the SM's 65,536
constexpr int HB_PRODUCER_REGS = 40, HB_CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// The bf16 kernel's place in the problem: batch bi, kv head hk, the first of
// its G query heads h0, its first query row q0 and P = 128 / G rows per head.
// Block row r is query row q0 + r / G of head h0 + r % G.
struct HTile {
  int bi, hk, h0, q0, g, p, first, pmin, pmax, lo, hi;
};

__device__ __forceinline__ HTile hlocate(const Params& p, int g) {
  HTile t;
  t.g = g;
  t.p = HB_ROWS / g;
  const int group = p.hq / p.hkv, n_hg = group / g, n_qt = (p.sq + t.p - 1) / t.p;
  t.q0 = (n_qt - 1 - (int)blockIdx.y) * t.p;  // the longest causal rows start first
  t.bi = blockIdx.x / (p.hkv * n_hg);
  const int rest = blockIdx.x % (p.hkv * n_hg);
  t.hk = rest / n_hg;
  t.h0 = t.hk * group + (rest % n_hg) * g;
  t.first = p.sk - p.sq;  // queries sit at the tail of the key axis
  t.pmin = t.first + t.q0;
  t.pmax = t.first + min(t.q0 + t.p, p.sq) - 1;
  t.lo = p.window > 0 ? max(0, t.pmin - p.window + 1) : 0;
  t.hi = p.causal ? min(p.sk, t.pmax + 1) : p.sk;
  return t;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map into shared memory; completion counted in
// bytes on the barrier
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a tile written by TMA with the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), eight-row groups 1024 bytes apart.
// K-major operands step through a row's 64 columns by moving the start
// address 32 bytes per 16 columns; the MN-major V tile steps 16 keys as two
// eight-row groups (2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n64, f32) = or += A . B; A and B from shared memory (descriptors),
// both K-major; d is overwritten when accumulate == 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, f32) += A . B; A (64 x 16 bf16) from registers, in each warp's
// 16 rows laid out as the A fragment of mma.m16n8k16; B from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// Shared memory, each piece 1024-byte aligned for the 128-byte swizzle: Q
// (NB column blocks of 128 rows x 64), then HB_STAGES stages of K and V (NB
// column blocks of 64 keys x 64 each), then the barriers.
template <int NB>
struct HLayout {
  static constexpr int Q_BYTES = NB * HB_ROWS * 128;
  static constexpr int KV_BYTES = NB * BK * 128;  // one of K or V, one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + HB_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * HB_STAGES + 1) + 1024;  // + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(HB_THREADS, 1)
fa_fwd_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, unsigned short* __restrict__ o,
            const Params p, const int g) {
  constexpr int NB = DH > 64 ? 2 : 1;  // 64-column blocks of the head dim (DH < 64 zero-padded)
  using L = HLayout<NB>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned q_s = base, kv_s = base + L::Q_BYTES, bars = base + L::BAR_OFF;
  // barriers: full[s] at bars + 8s, empty[s] at bars + 8 (STAGES + s), Q's at the end
  const unsigned q_bar = bars + 16 * HB_STAGES;

  const HTile tl = hlocate(p, g);
  const int kt0 = tl.lo / BK * BK;
  const int n_tiles = tl.hi > kt0 ? (tl.hi - kt0 + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HB_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                                     // the producer's expect_tx
      mbar_init(bars + 8 * (HB_STAGES + s), HB_CONSUMER_WARPS);  // one arrive per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= HB_CONSUMER_WARPS) {  // producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(HB_PRODUCER_REGS));
    if (warp == HB_CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(q_s + nb * HB_ROWS * 128, &qmap, q_bar, 64 * nb, tl.h0, tl.q0, tl.bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % HB_STAGES;
        const unsigned full = bars + 8 * s, empty = bars + 8 * (HB_STAGES + s);
        mbar_wait(empty, ((it / HB_STAGES) & 1) ^ 1);  // the stage's previous tile released
        mbar_expect_tx(full, L::STAGE_BYTES);
        const unsigned ks = kv_s + s * L::STAGE_BYTES, vs = ks + L::KV_BYTES;
        const int k0 = kt0 + it * BK;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(ks + nb * BK * 128, &kmap, full, 64 * nb, tl.hk, k0, tl.bi);
          tma_load_4d(vs + nb * BK * 128, &vmap, full, 64 * nb, tl.hk, k0, tl.bi);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(HB_CONSUMER_REGS));
  // consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63; this warp
  // rows 16 wq + gq and + 8 of them, as in the mma fragments
  const int wg = warp / 4, wq = warp % 4, gq = lane / 4, t = lane % 4;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = tl.first + tl.q0 + (64 * wg + 16 * wq + gq + 8 * i) / g;
  const float scale2 = p.scale * LOG2E;  // scores in the log2 domain: exp2f
  float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  // S = Q.K^T of the tile in stage st over the (padded) head dim, 16
  // columns per wgmma, issued but not waited for
  const unsigned q_wg = q_s + wg * 64 * 128;
  auto issue_scores = [&](float(&sc)[32], int st) {
    const unsigned ks = kv_s + st * L::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const unsigned off = (kk % 4) * 32;  // 16 columns into the 128-byte row
      wgmma_ss_n64(sc, sw128_desc(q_wg + (kk / 4) * HB_ROWS * 128 + off),
                   sw128_desc(ks + (kk / 4) * BK * 128 + off), kk > 0);
    }
    wgmma_commit();
  };

  mbar_wait(q_bar, 0);
  float sc[32];
  if (n_tiles > 0) {
    mbar_wait(bars, 0);
    issue_scores(sc, 0);
    wgmma_wait_all();
    fence_regs(sc);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % HB_STAGES, k0 = kt0 + it * BK;
    const unsigned vs = kv_s + s * L::STAGE_BYTES + L::KV_BYTES;
    // the next tile's scores run on the tensor cores under this tile's softmax
    float sn[32];
    const bool more = it + 1 < n_tiles;
    if (more) {
      mbar_wait(bars + 8 * ((it + 1) % HB_STAGES), ((it + 1) / HB_STAGES) & 1);
      issue_scores(sn, (it + 1) % HB_STAGES);
    }

    // sc[4j + 2i + e]: row i (gq, gq + 8), key k0 + 8j + 2t + e. Only tiles
    // on the causal diagonal, at the window's edge or past sk are masked.
    const bool edge = k0 + BK > p.sk || (p.causal && k0 + BK - 1 > tl.pmin) ||
                      (p.window > 0 && k0 < tl.pmax - p.window + 1);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= scale2;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!visible(p, qpos[i], k0 + 8 * j + 2 * t + e)) sc[4 * j + 2 * i + e] = -INFINITY;
    }

    // online softmax; a row's 64 scores lie on the four lanes of its quad.
    // The row sums stay per lane until the end.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[i], mx);
      const float msafe = mnew == -INFINITY ? 0.f : mnew;  // a row that has seen no key yet
      const float alpha = exp2f(m[i] - msafe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f(sc[4 * j + 2 * i + e] - msafe);
          sc[4 * j + 2 * i + e] = pe;
          sum += pe;
        }
      lsum[i] = lsum[i] * alpha + sum;
      m[i] = mnew;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[nb][4 * j + 2 * i] *= alpha;
          acc[nb][4 * j + 2 * i + 1] *= alpha;
        }
    }

    // O += P.V: P's accumulator fragments are the A fragments of the next
    // product, rounded to bf16 (P lies in [0, 1] after the max is taken out;
    // the row sum l stays in f32); V's tile is read as it lies (MN-major)
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) pa[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t vd = sw128_desc(vs + nb * BK * 128 + kk * 2048);
        wgmma_rs_n64_tb(acc[nb], pa[kk], vd);
      }
    wgmma_commit();
    wgmma_wait_all();  // this tile's P.V and the next tile's scores
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (HB_STAGES + s));  // this warp is done with the stage
    if (more) {
      fence_regs(sn);
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = sn[e];
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = 64 * wg + 16 * wq + gq + 8 * i, qr = tl.q0 + r / g;
    if (qr >= p.sq) continue;
    unsigned short* orow = o + (((long long)tl.bi * p.sq + qr) * p.hq + tl.h0 + r % g) * DH;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * nb + 8 * j + 2 * t;
        if (c < DH)
          *reinterpret_cast<unsigned*>(orow + c) =
              pack_bf16(acc[nb][4 * j + 2 * i] * inv, acc[nb][4 * j + 2 * i + 1] * inv);
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

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so the
// library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (64-column, n1, n2, 1) box over bf16 (dh, n1, n2, b) with the given
// strides in elements, 128-byte swizzle; reads past an edge fill zeros
// (head dims below 64 and the ragged last tiles of sq and sk).
int bf16_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int dh, int n1, int n2, int b,
             long long s1, long long s2, long long s3, int box1, int box2) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)n1, (cuuint64_t)n2, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box1, (cuuint32_t)box2, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_dh(const unsigned short* q, const unsigned short* k, const unsigned short* v,
              unsigned short* o, const Params& p, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int group = p.hq / p.hkv;
  const int g = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;  // query heads sharing a block's K/V
  const int rows = HB_ROWS / g;                               // query rows per head
  CUtensorMap qmap, kmap, vmap;
  int err = bf16_map(&qmap, enc, q, DH, p.hq, p.sq, p.b, p.qsh, p.qss, p.qsb, g, rows);
  if (!err) err = bf16_map(&kmap, enc, k, DH, p.hkv, p.sk, p.b, p.ksh, p.kss, p.ksb, 1, BK);
  if (!err) err = bf16_map(&vmap, enc, v, DH, p.hkv, p.sk, p.b, p.vsh, p.vss, p.vsb, 1, BK);
  if (err) return err;
  const int smem = HLayout<(DH > 64 ? 2 : 1)>::BYTES;
  cudaError_t e =
      cudaFuncSetAttribute(fa_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hkv * (group / g), (p.sq + rows - 1) / rows);
  fa_fwd_bf16<DH><<<grid, HB_THREADS, smem, stream>>>(qmap, kmap, vmap, o, p, g);
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

// dynamic shared memory of one bf16 block at head dim dh (for reports)
extern "C" int flash_attention_bf16_smem(int dh) {
  return dh > 64 ? HLayout<2>::BYTES : HLayout<1>::BYTES;
}
