// Stages shared by the fused IVF kernels (fused_scan.cu, fused_adc.cu).
//
// A block of kThreads threads serves up to kMaxQT queries of one segment.
//  * Probe (block_probe): a register-tiled f32 product of the block's
//    queries against the segment's centroids (each thread 2 queries x 4
//    centroids, the centroids staged transposed through shared memory kCT x
//    kDC at a time, exact fmaf sums in order j = 0 .. d-1), then per query
//    the top nprobe by bisection on the (score, lowest index) key, which
//    sets the query's bit in pmask[cluster]. Only the set of probed clusters
//    matters downstream. It is the block's last barrier but one: after it
//    every query belongs to one warp (or one group of warps), which alone
//    touches its top-k queue.
//  * Top-k: a queue per query of its k best (score, id) so far, sorted
//    best first (score descending, ties to the lowest id), in shared memory,
//    kept by one warp. A warp scores 32 candidates at a time, one a lane;
//    those above the queue's last entry are staged, and 32 staged keys at a
//    time are sorted across the lanes (bitonic, shuffles) and merged into
//    the queue: each new entry finds its place by a binary search of the
//    queue, each queue entry its shift by a binary search of the sorted
//    lanes. The work per candidate is bounded
//    whatever the candidate count, the shared memory is k entries a query,
//    and the queue is the sorted output.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ivf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQT = 32;     // queries per block: one bit each in a uint32 probe mask
constexpr int kCT = 64;        // centroids per probe tile
constexpr int kDC = 64;        // dimensions per probe stage
constexpr int kCTS = kCT + 4;  // row stride of the transposed centroid stage (16-byte rows)
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one H100 block
constexpr int kSmemPerSM = 233472;  // shared memory of one H100 SM (1 KB of it reserved a block)
constexpr int kTooLarge = -1;  // launcher result: no block shape fits the shared memory

constexpr unsigned kFull = 0xffffffffu;

// Float bits as an unsigned integer in the same order.
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Larger key = better: higher score, then lower id.
__device__ __forceinline__ uint64_t rank_key(float v, int id) {
  return ((uint64_t)ordered(v) << 32) | (uint64_t)(0xffffffffu - (unsigned)id);
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// 4-byte asynchronous copy from device to shared memory: the copies of a
// staging loop are all in flight at once. cp_async_wait waits for this
// thread's copies; a barrier then publishes them.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Byte offsets of the shared-memory regions, computed the same way on the
// host (to size the launch) and read by the kernel. The probe scratch and
// the scan buffers are alive at different times and share one region.
struct Layout {
  int qt;      // queries per block
  int dq;      // query row stride (floats, d rounded up to 4)
  int g;       // warps per query group (PQ)
  size_t qs, pmask, vec, region;  // vec: a kernel's (dq,) vector
  size_t ct, csim;                // probe scratch (in region)
  size_t bufv, bufi, stage, nst, aux;  // top-k queues, stages and counts; a kernel's scratch
  size_t total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Fills the parts of the layout the two kernels share, given the bytes of
// the kernel's scan region; returns the total.
inline size_t place_common(Layout* L, int qt, int d, int nlist, size_t scan_bytes, bool vec) {
  L->qt = qt;
  L->dq = (d + 3) & ~3;
  size_t o = 0;
  L->qs = o;    o = align16(o + sizeof(float) * (size_t)(qt < 2 ? 2 : qt) * L->dq);
  L->pmask = o; o = align16(o + sizeof(unsigned) * (size_t)nlist);
  L->vec = o;   o = align16(o + (vec ? sizeof(float) * (size_t)L->dq : 0));
  L->region = o;
  L->ct = o;
  L->csim = align16(L->ct + sizeof(float) * (size_t)kDC * kCTS);
  const size_t probe_end = align16(L->csim + sizeof(float) * (size_t)qt * nlist);
  const size_t scan_end = o + scan_bytes;
  L->total = probe_end > scan_end ? probe_end : scan_end;
  return L->total;
}

// csim[r * nlist + l] = qs[r] . cents[l] for r < qt, l < nlist, each an f32
// fmaf chain over j = 0 .. d-1. qs holds max(qt, 2) rows of stride dq, zero
// past the block's queries. Every thread of the block calls it.
__device__ void block_probe_sims(const float* qs, int dq, int qt, const float* __restrict__ cents,
                                 int nlist, int d, float* ct, float* csim) {
  const int t = threadIdx.x;
  const int qp = t / 16, cq = t % 16;  // queries 2qp, 2qp + 1; centroids 4cq .. 4cq + 3
  const int r0 = 2 * qp, r1 = r0 + 1;
  const bool on = r0 < qt;
  const float* a0 = qs + (size_t)(on ? r0 : 0) * dq;
  const float* a1 = qs + (size_t)(on ? r1 : 1) * dq;  // a zero row when r1 == qt
  for (int c0 = 0; c0 < nlist; c0 += kCT) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int d0 = 0; d0 < d; d0 += kDC) {
      const int dn = min(kDC, d - d0);
      __syncthreads();  // the previous stage is consumed
      for (int i = t; i < kCT * kDC; i += kThreads) {
        const int cc = i / kDC, jj = i - cc * kDC;
        if (jj < dn && c0 + cc < nlist)
          cp_async4(ct + jj * kCTS + cc, cents + (size_t)(c0 + cc) * d + d0 + jj);
        else
          ct[jj * kCTS + cc] = 0.f;
      }
      cp_async_wait();
      __syncthreads();
      if (on) {
        for (int jj = 0; jj < dn; ++jj) {
          const float x0 = a0[d0 + jj], x1 = a1[d0 + jj];
          const float4 c = *reinterpret_cast<const float4*>(ct + jj * kCTS + 4 * cq);
          acc[0][0] = fmaf(x0, c.x, acc[0][0]);
          acc[0][1] = fmaf(x0, c.y, acc[0][1]);
          acc[0][2] = fmaf(x0, c.z, acc[0][2]);
          acc[0][3] = fmaf(x0, c.w, acc[0][3]);
          acc[1][0] = fmaf(x1, c.x, acc[1][0]);
          acc[1][1] = fmaf(x1, c.y, acc[1][1]);
          acc[1][2] = fmaf(x1, c.z, acc[1][2]);
          acc[1][3] = fmaf(x1, c.w, acc[1][3]);
        }
      }
    }
    if (on) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = c0 + 4 * cq + i;
        if (l < nlist) {
          csim[(size_t)r0 * nlist + l] = acc[0][i];
          if (r1 < qt) csim[(size_t)r1 * nlist + l] = acc[1][i];
        }
      }
    }
  }
}

// Barrier of the `g` warps of group `grp` (named barrier grp + 1; the
// block's own barrier is 0).
__device__ __forceinline__ void group_sync(int grp, int g) {
  if (g == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(32 * g) : "memory");
  }
}

// Sets bit r of pmask[l] for the nprobe clusters of query r with the
// highest csim row values (ties to the lowest cluster index), 0 < nprobe:
// the nprobe-th best key (score, lowest index) by bisection on the key bits
// below the highest bit on which the keys differ, a threshold that takes a
// bit while at least nprobe keys stay at or above it and stops once exactly
// nprobe do (the keys are distinct). One warp.
__device__ void warp_probe_select(const float* cs, int nlist, int nprobe, int r, unsigned* pmask,
                                  int lane) {
  if (nprobe >= nlist) {
    for (int l = lane; l < nlist; l += 32) atomicOr(&pmask[l], 1u << r);
    return;
  }
  const uint64_t k0 = rank_key(cs[0], 0);
  uint64_t diff = 0;
  for (int l = lane; l < nlist; l += 32) diff |= rank_key(cs[l], l) ^ k0;
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(diff >> 32));
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)diff);
  const int top = hi ? 63 - __clz(hi) : 31 - __clz(lo);  // nlist > 1 distinct keys differ
  uint64_t t = k0 & ~((((uint64_t)2) << top) - 1);  // every key is >= t
  for (int b = top; b >= 0; --b) {
    const uint64_t c = t | ((uint64_t)1 << b);
    unsigned n = 0;
    for (int l = lane; l < nlist; l += 32) n += rank_key(cs[l], l) >= c;
    n = __reduce_add_sync(kFull, n);
    if (n >= (unsigned)nprobe) {
      t = c;
      if (n == (unsigned)nprobe) break;
    }
  }
  for (int l = lane; l < nlist; l += 32)
    if (rank_key(cs[l], l) >= t) atomicOr(&pmask[l], 1u << r);
}

// The block's probe: loads its qt queries (zero rows and columns past
// them), computes their centroid similarities and leaves in pmask[l] bit r
// set iff query r probed cluster l. Ends with a block barrier.
__device__ void block_probe(const Layout& L, unsigned char* smem, const float* __restrict__ q,
                            int b0, int qt, int d, const float* __restrict__ cents, int nlist,
                            int nprobe) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  unsigned* pmask = reinterpret_cast<unsigned*>(smem + L.pmask);
  float* csim = reinterpret_cast<float*>(smem + L.csim);
  for (int i = t; i < max(L.qt, 2) * L.dq; i += kThreads) {
    const int r = i / L.dq, j = i - r * L.dq;
    if (r < qt && j < d)
      cp_async4(qs + i, q + (size_t)(b0 + r) * d + j);
    else
      qs[i] = 0.f;
  }
  for (int l = t; l < nlist; l += kThreads) pmask[l] = 0;
  cp_async_wait();
  __syncthreads();
  block_probe_sims(qs, L.dq, qt, cents, nlist, d, reinterpret_cast<float*>(smem + L.ct), csim);
  __syncthreads();
  for (int r = warp; r < qt; r += kWarps)
    warp_probe_select(csim + (size_t)r * nlist, nlist, nprobe, r, pmask, lane);
  __syncthreads();
}

__device__ __forceinline__ uint64_t shfl64(uint64_t x, int src) {
  return ((uint64_t)__shfl_sync(kFull, (unsigned)(x >> 32), src) << 32) |
         __shfl_sync(kFull, (unsigned)x, src);
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t x, int mask) {
  return ((uint64_t)__shfl_xor_sync(kFull, (unsigned)(x >> 32), mask) << 32) |
         __shfl_xor_sync(kFull, (unsigned)x, mask);
}

// The key of the queue's last (k-th) entry: a candidate enters only above it.
__device__ __forceinline__ uint64_t queue_floor(const float* v, const int* id, int k) {
  return rank_key(v[k - 1], id[k - 1]);
}

// Merges the lanes' keys x where `pass` (x above the queue's floor) into the
// sorted queue (v, id) of k entries, keeping the k best. Every lane of the
// warp calls it; the queue is published (__syncwarp) on return.
__device__ void warp_merge(float* v, int* id, int k, bool pass, uint64_t x, int lane) {
  x = pass ? x : 0;
  for (int size = 2; size <= 32; size <<= 1) {  // bitonic sort over the lanes, best first
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = shfl_xor64(x, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
    }
  }
  const int np = __popc(__ballot_sync(kFull, pass));
  // a new key's place: its lane plus the queue entries at or above it
  int at = k;
  if (lane < np) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rank_key(v[mid], id[mid]) >= x) lo = mid + 1;
      else hi = mid;
    }
    at = lane + lo;
  }
  // a queue entry's shift: the new keys above it (binary search of the
  // sorted lanes); chunks from the last, so no entry is overwritten unread
  for (int c0 = (k - 1) & ~31; c0 >= 0; c0 -= 32) {
    const int i = c0 + lane;
    const bool in = i < k;
    const float vi = in ? v[i] : -CUDART_INF_F;
    const int ii = in ? id[i] : -1;
    const uint64_t xi = rank_key(vi, ii);
    int lo = 0, hi = np;
#pragma unroll
    for (int step = 0; step < 6; ++step) {  // hi - lo <= 32 halves to 0 in 6 steps
      const int mid = (lo + hi) >> 1;
      const uint64_t xm = shfl64(x, mid < 32 ? mid : 31);
      if (lo < hi) {
        if (xm > xi) lo = mid + 1;
        else hi = mid;
      }
    }
    if (!__any_sync(kFull, in && lo > 0)) break;  // shifts only shrink towards the front
    __syncwarp();
    if (in && lo > 0 && i + lo < k) {
      v[i + lo] = vi;
      id[i + lo] = ii;
    }
    __syncwarp();
  }
  if (at < k) {
    const unsigned o = (unsigned)(x >> 32);
    v[at] = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
    id[at] = (int)~(unsigned)x;
  }
  __syncwarp();
}

// A query's top-k state: its queue (v, id: k entries, sorted) and a stage
// of up to 32 keys above the queue's last entry, merged into the queue 32
// at a time (so the sort and merge run once per 32 admitted candidates,
// not once per offer that admits any).
struct Queue {
  float* v;
  int* id;
  uint64_t* stage;  // 32 keys
  int* n;           // keys staged
};

__device__ __forceinline__ void queue_init(const Queue& Q, int k, int lane) {
  for (int i = lane; i < k; i += 32) {
    Q.v[i] = -CUDART_INF_F;
    Q.id[i] = -1;
  }
  if (lane == 0) *Q.n = 0;
}

// Merges the staged keys into the queue. Every lane of the warp calls it.
__device__ __forceinline__ void queue_flush(const Queue& Q, int k, int lane) {
  const int c = *Q.n;
  if (c == 0) return;
  warp_merge(Q.v, Q.id, k, lane < c, lane < c ? Q.stage[lane] : 0, lane);
  if (lane == 0) *Q.n = 0;
  __syncwarp();
}

// Offers the lanes' (s, id) where `ok` to the query: those above the
// queue's last entry are staged, the stage merged first if they would
// overflow it. Every lane of the warp calls it.
__device__ __forceinline__ void warp_offer(const Queue& Q, int k, bool ok, float s, int id,
                                           int lane) {
  const uint64_t x = rank_key(s, id);
  const bool pass = ok && s > -CUDART_INF_F && x > queue_floor(Q.v, Q.id, k);
  const unsigned m = __ballot_sync(kFull, pass);
  if (m == 0) return;
  int c = *Q.n;
  if (c + __popc(m) > 32) {
    queue_flush(Q, k, lane);
    c = 0;
  }
  if (pass) Q.stage[c + __popc(m & lanes_below(lane))] = x;
  __syncwarp();
  if (lane == 0) *Q.n = c + __popc(m);
  __syncwarp();
}

// Flushes the stage and writes the queue to the k output slots. One warp.
__device__ __forceinline__ void queue_write(const Queue& Q, int k, int* out_id, float* out_v,
                                            int lane) {
  queue_flush(Q, k, lane);
  for (int i = lane; i < k; i += 32) {
    out_id[i] = Q.id[i];
    out_v[i] = Q.v[i];
  }
}

}  // namespace ivf
