// Fused IVF probe -> PQ ADC scan -> top-k (IVF_PQ), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_adc.py::fused_ivf_pq_topk_pallas.
// A block serves up to 32 queries of one segment: the probe of
// ivf_common.cuh for all of them at once, then groups of G warps take the
// queries one at a time. A group stages its query's ADC table (m * c f32) in
// its own shared memory, then walks the member slots of the query's probed
// lists: each warp loads 128 slots at once, compacts the live ones (padding
// may sit anywhere in a list; with mask_dead also slots whose gid is < 0
// are dropped) and scores them one per lane as sum_m lut[m][code_m], a
// per-byte gather summed in order m = 0 .. m-1 (the plain version's order,
// so the scores agree bit for bit), offered 32 at a time to the warp's own
// top-k queue for the query; at the end the group's first warp merges the
// other warps' queues into its own. G is the fewest warps whose groups'
// tables fit 64 KB together: 1 (eight queries at once) for m * c up to
// about 1,700 floats, 8 (the whole block on one query, one table) at m = 32,
// c = 256, so the table never limits the blocks an SM holds.
#include "ivf_common.cuh"

namespace {

constexpr size_t kGroupBudget = 64 * 1024;  // shared memory of the groups' tables and queues
constexpr int kWindow = 128;  // member slots a warp loads at once

// Bytes a group's region holds: table, each warp's top-k queue (values,
// ids) and stage, the query's list ids, each warp's compacted slots, the
// warps' stage counts and the list count.
__host__ __device__ inline size_t group_bytes(int m, int c, int k, int nlist, int g) {
  return ivf::align16(sizeof(float) * (size_t)m * c) +
         (size_t)g * (2 * ivf::align16(sizeof(float) * (size_t)k) + sizeof(uint64_t) * 32) +
         ivf::align16(sizeof(int) * (size_t)nlist) + sizeof(int) * (size_t)kWindow * g +
         ivf::align16(sizeof(int) * (size_t)(g + 1));
}

// Warp w's top-k state in a group's queues (each warp: values, ids, stage;
// vb bytes of values or ids).
__device__ __forceinline__ ivf::Queue warp_queue(unsigned char* queues, size_t vb, int* cnts,
                                                 int w) {
  unsigned char* p = queues + w * (2 * vb + sizeof(uint64_t) * 32);
  return ivf::Queue{reinterpret_cast<float*>(p), reinterpret_cast<int*>(p + vb),
                    reinterpret_cast<uint64_t*>(p + 2 * vb), cnts + w};
}

__global__ void __launch_bounds__(ivf::kThreads)
    fused_pq_kernel(const float* __restrict__ q, const float* __restrict__ lut,
                    const uint8_t* __restrict__ codes, const float* __restrict__ cents,
                    const int* __restrict__ members, const int* __restrict__ gids,
                    int* __restrict__ out_lids, float* __restrict__ out_sims, int B, int s, int d,
                    int m, int c, int nlist, int cap, int nprobe, int k, int mask_dead,
                    ivf::Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int b0 = blockIdx.x * L.qt, z = blockIdx.y;
  const int qt = min(L.qt, B - b0);
  ivf::block_probe(L, smem, q, b0, qt, d, cents + (size_t)z * nlist * d, nlist, nprobe);

  const int G = L.g, ng = ivf::kWarps / G, grp = warp / G, wg = warp % G;
  const unsigned* pmask = reinterpret_cast<const unsigned*>(smem + L.pmask);
  const size_t tbl_b = ivf::align16(sizeof(float) * (size_t)m * c);
  const size_t vb = ivf::align16(sizeof(float) * (size_t)k);  // a queue's values (or ids)
  const size_t queue_b = 2 * vb + sizeof(uint64_t) * 32;         // values, ids, stage
  const size_t ql_b = ivf::align16(sizeof(int) * (size_t)nlist);
  unsigned char* gbase = smem + L.region + grp * group_bytes(m, c, k, nlist, G);
  float* tbl = reinterpret_cast<float*>(gbase);
  int* ql = reinterpret_cast<int*>(gbase + tbl_b + G * queue_b);
  int* lidw = reinterpret_cast<int*>(gbase + tbl_b + G * queue_b + ql_b) + wg * kWindow;
  int* cnts = reinterpret_cast<int*>(gbase + tbl_b + G * queue_b + ql_b +
                                     sizeof(int) * kWindow * G);  // [G stage counts, lists]
  const ivf::Queue mine = warp_queue(gbase + tbl_b, vb, cnts, wg);

  const int* mz = members + (size_t)z * nlist * cap;
  const int* gz = gids + (size_t)z * s;
  const uint8_t* cz = codes + (size_t)z * s * m;
  const int mc = m * c, gt = 32 * G;
  for (int r = grp; r < qt; r += ng) {
    for (int i = wg * 32 + lane; i < mc; i += gt)
      ivf::cp_async4(tbl + i, lut + (size_t)(b0 + r) * mc + i);
    ivf::queue_init(mine, k, lane);
    ivf::cp_async_wait();
    if (wg == 0) {  // this query's lists
      int n = 0;
      for (int l0 = 0; l0 < nlist; l0 += 32) {
        const int l = l0 + lane;
        const bool on = l < nlist && ((pmask[l] >> r) & 1u);
        const unsigned bb = __ballot_sync(ivf::kFull, on);
        if (on) ql[n + __popc(bb & ivf::lanes_below(lane))] = l;
        n += __popc(bb);
      }
      if (lane == 0) cnts[G] = n;
    }
    ivf::group_sync(grp, G);
    const int P = cnts[G] * cap;
    for (int base = wg * kWindow; base < P; base += kWindow * G) {  // the group's warps interleave
      int x[kWindow / 32];  // this warp's window of slots, every load in flight at once
#pragma unroll
      for (int j = 0; j < kWindow / 32; ++j) {
        const int p = base + 32 * j + lane;
        x[j] = -1;
        if (p < P) {
          const int li = p / cap;
          x[j] = mz[(size_t)ql[li] * cap + (p - li * cap)];
        }
      }
      if (mask_dead) {
#pragma unroll
        for (int j = 0; j < kWindow / 32; ++j)
          if (x[j] >= 0 && gz[x[j]] < 0) x[j] = -1;
      }
      int n = 0;  // the live ones, compacted into lidw
#pragma unroll
      for (int j = 0; j < kWindow / 32; ++j) {
        const unsigned live = __ballot_sync(ivf::kFull, x[j] >= 0);
        if (x[j] >= 0) lidw[n + __popc(live & ivf::lanes_below(lane))] = x[j];
        n += __popc(live);
      }
      __syncwarp();
      for (int g0 = 0; g0 < n; g0 += 32) {
        const bool ok = lane < n - g0;
        const int lid = ok ? lidw[g0 + lane] : 0;
        float acc = 0.f;
        if (ok) {
          const uint8_t* row = cz + (size_t)lid * m;
          for (int j0 = 0; j0 < m; j0 += 8) {  // eight code loads in flight, then the sum in order
            unsigned b[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) b[u] = j0 + u < m ? row[j0 + u] : 0u;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (j0 + u < m) acc = acc + tbl[(j0 + u) * c + b[u]];
          }
        }
        ivf::warp_offer(mine, k, ok, acc, lid, lane);
      }
      __syncwarp();  // lidw is read before the next window overwrites it
    }
    ivf::group_sync(grp, G);
    if (wg == 0) {  // the other warps' queues into this one, then out
      ivf::queue_flush(mine, k, lane);
      for (int w = 1; w < G; ++w) {
        const ivf::Queue other = warp_queue(gbase + tbl_b, vb, cnts, w);
        ivf::queue_flush(other, k, lane);
        for (int i0 = 0; i0 < k; i0 += 32) {
          const bool in = i0 + lane < k;
          ivf::warp_offer(mine, k, in, in ? other.v[i0 + lane] : -CUDART_INF_F,
                          in ? other.id[i0 + lane] : -1, lane);
        }
      }
      const size_t o = ((size_t)z * B + b0 + r) * k;
      ivf::queue_write(mine, k, out_lids + o, out_sims + o, lane);
    }
    ivf::group_sync(grp, G);  // the queues and table are free for the group's next query
  }
}

bool plan(int d, int m, int c, int nlist, int k, ivf::Layout* L) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int g = 1; g <= ivf::kWarps; g <<= 1) {
      L->g = g;
      const size_t groups = group_bytes(m, c, k, nlist, g) * (ivf::kWarps / g);
      if (pass == 0 && groups > kGroupBudget) continue;
      ivf::place_common(L, ivf::kMaxQT, d, nlist, groups, false);
      if (L->total <= (size_t)ivf::kSmemLimit) return true;
    }
  }
  return false;
}

}  // namespace

extern "C" int fused_ivf_pq_topk(const float* q, const float* lut, const uint8_t* codes,
                                 const float* cents, const int* members, const int* gids,
                                 int* out_lids, float* out_sims, int B, int n_seg, int s, int d,
                                 int m, int c, int nlist, int cap, int nprobe, int k,
                                 int mask_dead, void* stream) {
  ivf::Layout L;
  if (!plan(d, m, c, nlist, k, &L)) return ivf::kTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      fused_pq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + L.qt - 1) / L.qt, n_seg);
  fused_pq_kernel<<<grid, ivf::kThreads, L.total, (cudaStream_t)stream>>>(
      q, lut, codes, cents, members, gids, out_lids, out_sims, B, s, d, m, c, nlist, cap, nprobe,
      k, mask_dead, L);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block at these sizes (bytes), -1 if none fits.
extern "C" int fused_ivf_pq_topk_smem(int d, int m, int c, int nlist, int k) {
  ivf::Layout L;
  return plan(d, m, c, nlist, k, &L) ? (int)L.total : ivf::kTooLarge;
}
