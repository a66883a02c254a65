// Fused IVF probe -> int8 dequant scan -> top-k (IVF_SQ8), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_scan.py::fused_ivf_sq8_topk_pallas.
// A block serves up to 32 queries of one segment (segments on the grid's y
// axis): the probe and the top-k queues of ivf_common.cuh, and between them
// the scan. Each warp owns up to four of the block's queries. It walks the
// union of their probed lists, 128 member slots at a time, compacts the live
// slots (padding may sit anywhere in a list; with mask_dead also slots whose
// gid is < 0), and scores each live row, one per lane, against every query
// of the warp that probed the list: the lane loads its row's code words into
// registers (every load in flight at once), and each word is turned into
// four floats exactly (a byte permute into the mantissa of 2^23 and one
// subtraction), which the queries reuse. Scores are f32 fmaf sums of code_j
// * (scale_j * q_j) in four partial sums (j mod 4) added at the end, offered
// to the query's queue 32 at a time. A warp alone keeps its queries' queues,
// so no block barrier follows the probe.
// See fused_scan.py for the bound.
#include "ivf_common.cuh"

namespace {

constexpr int kRowWords = 16;  // code words of a row held in registers at once (64 codes)
constexpr int kWindow = 128;   // member slots a warp loads at once
constexpr int kBlocksPerSM = 3;  // the occupancy aimed at (registers capped to fit it)
constexpr int kShare = ivf::kSmemPerSM / kBlocksPerSM - 1024;  // shared memory of such a block

// Words w0 .. w0 + kRowWords of a code row into registers (zero past the
// row's rw words, or when !ok), every load in flight at once: 4-byte loads
// when rows are 4-byte aligned (d % 4 == 0), else byte loads.
__device__ __forceinline__ void load_words(int (&v)[kRowWords], const int8_t* __restrict__ row,
                                           bool ok, int w0, int rw, int d) {
  if ((d & 3) == 0) {
    const int* r = reinterpret_cast<const int*>(row) + w0;
#pragma unroll
    for (int u = 0; u < kRowWords; ++u) v[u] = ok && w0 + u < rw ? __ldg(r + u) : 0;
    return;
  }
#pragma unroll
  for (int u = 0; u < kRowWords; ++u) {
    unsigned x = 0;
    const int j = 4 * (w0 + u);
    if (ok && w0 + u < rw) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (j + b < d) x |= (unsigned)(uint8_t)__ldg(row + j + b) << (8 * b);
    }
    v[u] = (int)x;
  }
}

// The four signed codes of a word as exact floats: code + 128 as the low
// byte of the f32 2^23 + (code + 128), minus 2^23 + 128.
__device__ __forceinline__ float4 code_floats(int word) {
  const unsigned u = (unsigned)word ^ 0x80808080u;
  const float off = 8388736.f;
  return make_float4(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)) - off,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)) - off,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)) - off,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)) - off);
}

// Four partial sums, one per byte position of the code words, so that a
// row's products form four independent chains.
__device__ __forceinline__ void dot4(float4 c, float4 q, float4& acc) {
  acc.x = fmaf(c.x, q.x, acc.x);
  acc.y = fmaf(c.y, q.y, acc.y);
  acc.z = fmaf(c.z, q.z, acc.z);
  acc.w = fmaf(c.w, q.w, acc.w);
}

// acc[g] += the words v[0 .. wn) (words w0 .. of this lane's row) . the
// scaled query qi[g], for the NQ queries of the group.
template <int NQ>
__device__ __forceinline__ void score_words(const int (&v)[kRowWords], int wn, const float* qs,
                                            int dq, int w0, const int* qi, float4* acc) {
  const float4* qp[NQ];
#pragma unroll
  for (int g = 0; g < NQ; ++g)
    qp[g] = reinterpret_cast<const float4*>(qs + (size_t)qi[g] * dq) + w0;
#pragma unroll
  for (int u = 0; u < kRowWords; ++u) {
    if (u >= wn) break;
    const float4 c = code_floats(v[u]);
#pragma unroll
    for (int g = 0; g < NQ; ++g) dot4(c, qp[g][u], acc[g]);
  }
}

__global__ void __launch_bounds__(ivf::kThreads, kBlocksPerSM)
    fused_sq8_kernel(const float* __restrict__ q, const int8_t* __restrict__ codes,
                     const float* __restrict__ scale, const float* __restrict__ cents,
                     const int* __restrict__ members, const int* __restrict__ gids,
                     int* __restrict__ out_lids, float* __restrict__ out_sims, int B, int s, int d,
                     int nlist, int cap, int nprobe, int k, int mask_dead, ivf::Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int b0 = blockIdx.x * L.qt, z = blockIdx.y;
  const int qt = min(L.qt, B - b0);
  float* scv = reinterpret_cast<float*>(smem + L.vec);
  for (int j = t; j < L.dq; j += ivf::kThreads) {
    if (j < d)
      ivf::cp_async4(scv + j, scale + j);
    else
      scv[j] = 0.f;
  }
  ivf::block_probe(L, smem, q, b0, qt, d, cents + (size_t)z * nlist * d, nlist, nprobe);

  float* qs = reinterpret_cast<float*>(smem + L.qs);
  const float* sc = reinterpret_cast<const float*>(smem + L.vec);  // staged by the probe's loads
  for (int i = t; i < qt * L.dq; i += ivf::kThreads) qs[i] *= sc[i % L.dq];  // q_j -> scale_j q_j
  __syncthreads();  // the probe scratch is free; the warps are on their own from here

  const int qw = L.qt / ivf::kWarps, r0 = warp * qw, nown = min(qw, qt - r0);
  if (nown <= 0) return;
  const unsigned* pmask = reinterpret_cast<const unsigned*>(smem + L.pmask);
  int* lidw = reinterpret_cast<int*>(smem + L.aux) + warp * kWindow;
  float* const qv = reinterpret_cast<float*>(smem + L.bufv);
  int* const qid = reinterpret_cast<int*>(smem + L.bufi);
  uint64_t* const qst = reinterpret_cast<uint64_t*>(smem + L.stage);
  int* const qn = reinterpret_cast<int*>(smem + L.nst);
  const auto queue = [=](int r) {  // query r's top-k state
    return ivf::Queue{qv + (size_t)r * k, qid + (size_t)r * k, qst + 32 * r, qn + r};
  };
  for (int r = r0; r < r0 + nown; ++r) ivf::queue_init(queue(r), k, lane);
  __syncwarp();

  const int rw = (d + 3) / 4;
  const int* mz = members + (size_t)z * nlist * cap;
  const int* gz = gids + (size_t)z * s;
  const int8_t* cz = codes + (size_t)z * s * d;
  const unsigned own = (1u << nown) - 1u;
  for (int l0 = 0; l0 < nlist; l0 += 32) {
    const unsigned wm = l0 + lane < nlist ? (pmask[l0 + lane] >> r0) & own : 0u;
    unsigned lists = __ballot_sync(ivf::kFull, wm != 0);
    while (lists) {  // each list one of the warp's queries probed
      const int src = __ffs(lists) - 1;
      lists &= lists - 1;
      const int l = l0 + src;
      const unsigned qm = __shfl_sync(ivf::kFull, wm, src);
      int qi[4] = {r0, r0, r0, r0}, nq = 0;  // the warp's queries that probed l
      unsigned rest = qm;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (rest) {
          qi[g] = r0 + __ffs(rest) - 1;
          rest &= rest - 1;
          nq = g + 1;
        }
      }
      for (int base = 0; base < cap; base += kWindow) {
        int x[kWindow / 32];  // the window's slots, every load in flight at once
#pragma unroll
        for (int j = 0; j < kWindow / 32; ++j) {
          const int slot = base + 32 * j + lane;
          x[j] = slot < cap ? mz[(size_t)l * cap + slot] : -1;
        }
        if (mask_dead) {
#pragma unroll
          for (int j = 0; j < kWindow / 32; ++j)
            if (x[j] >= 0 && gz[x[j]] < 0) x[j] = -1;
        }
        int n = 0;  // the live ones, compacted into lidw in slot order
#pragma unroll
        for (int j = 0; j < kWindow / 32; ++j) {
          const unsigned live = __ballot_sync(ivf::kFull, x[j] >= 0);
          if (x[j] >= 0) lidw[n + __popc(live & ivf::lanes_below(lane))] = x[j];
          n += __popc(live);
        }
        __syncwarp();
        for (int g0 = 0; g0 < n; g0 += 32) {  // 32 rows, one per lane
          const int nrows = min(32, n - g0);
          const bool ok = lane < nrows;
          const int mylid = ok ? lidw[g0 + lane] : 0;
          float4 acc[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
          const int8_t* row = cz + (size_t)mylid * d;
          for (int w0 = 0; w0 < rw; w0 += kRowWords) {
            const int wn = min(kRowWords, rw - w0);
            int v[kRowWords];
            load_words(v, row, ok, w0, rw, d);
            switch (nq) {
              case 1: score_words<1>(v, wn, qs, L.dq, w0, qi, acc); break;
              case 2: score_words<2>(v, wn, qs, L.dq, w0, qi, acc); break;
              case 3: score_words<3>(v, wn, qs, L.dq, w0, qi, acc); break;
              default: score_words<4>(v, wn, qs, L.dq, w0, qi, acc); break;
            }
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if (g >= nq) break;
            const float sc = (acc[g].x + acc[g].y) + (acc[g].z + acc[g].w);
            ivf::warp_offer(queue(qi[g]), k, ok, sc, mylid, lane);
          }
        }
      }
    }
  }

  // each query's k best, sorted
  for (int r = r0; r < r0 + nown; ++r) {
    const size_t o = ((size_t)z * B + b0 + r) * k;
    ivf::queue_write(queue(r), k, out_lids + o, out_sims + o, lane);
  }
}

// The block shape for these sizes: the most queries per warp (4, 2, 1)
// whose shared memory lets kBlocksPerSM blocks share an SM, else the most
// that one block holds; false if not even one query a warp fits.
bool plan(int d, int nlist, int k, ivf::Layout* L) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int qw = 4; qw >= 1; qw >>= 1) {
      const int qt = qw * ivf::kWarps;
      const size_t queue = sizeof(float) * (size_t)qt * k;
      const size_t stage = sizeof(uint64_t) * 32 * (size_t)qt;
      const size_t scan = 2 * ivf::align16(queue) + stage + ivf::align16(sizeof(int) * qt) +
                          sizeof(int) * ivf::kWarps * kWindow;
      ivf::place_common(L, qt, d, nlist, scan, true);
      L->bufv = L->region;
      L->bufi = L->bufv + ivf::align16(queue);
      L->stage = L->bufi + ivf::align16(queue);
      L->nst = L->stage + stage;
      L->aux = L->nst + ivf::align16(sizeof(int) * qt);
      if (L->total <= (size_t)(pass == 0 ? kShare : ivf::kSmemLimit)) return true;
    }
  }
  return false;
}

}  // namespace

extern "C" int fused_ivf_sq8_topk(const float* q, const int8_t* codes, const float* scale,
                                  const float* cents, const int* members, const int* gids,
                                  int* out_lids, float* out_sims, int B, int n_seg, int s,
                                  int d, int nlist, int cap, int nprobe, int k, int mask_dead,
                                  void* stream) {
  ivf::Layout L;
  if (!plan(d, nlist, k, &L)) return ivf::kTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sq8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + L.qt - 1) / L.qt, n_seg);
  fused_sq8_kernel<<<grid, ivf::kThreads, L.total, (cudaStream_t)stream>>>(
      q, codes, scale, cents, members, gids, out_lids, out_sims, B, s, d, nlist, cap, nprobe, k,
      mask_dead, L);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block at these sizes (bytes), -1 if none fits.
extern "C" int fused_ivf_sq8_topk_smem(int d, int nlist, int k) {
  ivf::Layout L;
  return plan(d, nlist, k, &L) ? (int)L.total : ivf::kTooLarge;
}
