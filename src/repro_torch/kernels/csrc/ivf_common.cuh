// Stages shared by the fused IVF kernels (fused_scan.cu, fused_adc.cu).
//
// One WARP serves one (query, segment) pair; a block holds up to kMaxWarps
// queries of one segment, which share the block's staged centroids and
// whose reads of the segment's lists and codes meet in L1/L2. Shared memory:
//   block: [kernel-specific shared data] centroid stage[32 * (d | 1)]
//   warp:  [kernel-specific query data] csim[nlist] sc[P] lid[P] probe[nprobe]
// Selections are warp-wide integer max-reductions (redux.sync); after the
// probe no block barrier is left, so the warps never wait for each other.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ivf {

constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one H100 block

constexpr unsigned kFull = 0xffffffffu;

// Float bits as an unsigned integer in the same order (for the integer
// warp reductions).
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// True in the one lane whose (v, key) is the warp's best: highest score,
// then lowest key (keys are distinct among finite scores). `any` is false
// when every lane holds -inf. Two integer max-reductions, no shuffles.
__device__ __forceinline__ bool warp_winner(float v, int key, bool* any) {
  const unsigned hi = ordered(v);
  const unsigned top = __reduce_max_sync(kFull, hi);
  *any = top != ordered(-CUDART_INF_F);
  const unsigned lo = hi == top ? (unsigned)INT32_MAX - (unsigned)key : 0u;
  const unsigned best_lo = __reduce_max_sync(kFull, lo);  // every lane takes part
  return hi == top && lo == best_lo;
}

// Probe: csim[l] = q . centroid[l], then the top nprobe clusters into
// probe[] (ties to the lowest cluster index). nprobe <= nlist. Every warp
// of the block calls it (`active` false for a warp without a query): the
// centroids pass through `stage` (32 rows of stride d | 1, so the lanes'
// row reads hit distinct banks) 32 at a time, read from device memory
// once per block instead of once per query.
__device__ void block_probe(const float* qs, const float* cents, int nlist, int d, int nprobe,
                            float* stage, float* csim, int* probe, int lane, bool active) {
  const int rs = d | 1;
  for (int c0 = 0; c0 < nlist; c0 += 32) {
    const int rows = min(32, nlist - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d;
      stage[r * rs + (i - r * d)] = cents[(size_t)c0 * d + i];
    }
    __syncthreads();
    if (active && lane < rows) {
      const float* c = stage + lane * rs;
      float acc = 0.f;
      for (int j = 0; j < d; ++j) acc = fmaf(qs[j], c[j], acc);
      csim[c0 + lane] = acc;  // slot c0 + lane belongs to this lane
    }
  }
  if (!active) return;
  for (int t = 0; t < nprobe; ++t) {
    float v = -CUDART_INF_F;
    int key = INT32_MAX;
    for (int l = lane; l < nlist; l += 32)  // this lane's clusters, ascending
      if (csim[l] > v) v = csim[l], key = l;
    bool any;
    if (warp_winner(v, key, &any)) {
      probe[t] = key;
      csim[key] = -CUDART_INF_F;  // only the owning lane reads it again
    }
  }
  __syncwarp();
}

// The live candidates of the probed lists, compacted into lid[0, n) in
// list order: member slots that are padding (-1) or, with mask_dead, whose
// gid is < 0 are dropped. Returns n (the same in every lane).
__device__ int compact_candidates(const int* mem, const int* probe, int nprobe, int cap,
                                  const int* gz, int mask_dead, int* lid, int lane) {
  const int P = nprobe * cap;
  int n = 0;
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    int l = p < P ? mem[probe[p / cap] * cap + p % cap] : -1;
    if (l >= 0 && mask_dead && gz[l] < 0) l = -1;
    const unsigned live = __ballot_sync(kFull, l >= 0);
    if (l >= 0) lid[n + __popc(live & ((1u << lane) - 1u))] = l;
    n += __popc(live);
  }
  __syncwarp();
  return n;
}

// Top-k of P scored candidates (ties to the lowest local id). Each lane
// first sorts the slots it owns (p = lane, lane + 32, ...) by score, then
// every round takes the best head of the 32 lists and the owning lane
// advances. Candidates scored -inf are never taken; output slots beyond
// the candidates are written as -1 / -inf.
__device__ void warp_topk(float* sc, int* lid, int P, int k, int* out_lids, float* out_sims,
                          int lane) {
  for (int p = lane + 32; p < P; p += 32) {  // insertion sort of this lane's slots
    const float v = sc[p];
    const int l = lid[p];
    int q = p - 32;
    for (; q >= 0 && (sc[q] < v || (sc[q] == v && lid[q] > l)); q -= 32) {
      sc[q + 32] = sc[q];
      lid[q + 32] = lid[q];
    }
    sc[q + 32] = v;
    lid[q + 32] = l;
  }
  int head = lane;
  for (int t = 0; t < k; ++t) {
    const float v = head < P ? sc[head] : -CUDART_INF_F;
    const int l = head < P ? lid[head] : -1;
    bool any;
    const bool mine = warp_winner(v, l, &any);
    if (!any) {
      for (int u = t + lane; u < k; u += 32) {
        out_lids[u] = -1;
        out_sims[u] = -CUDART_INF_F;
      }
      return;
    }
    if (mine) {
      out_lids[t] = l;
      out_sims[t] = v;
      head += 32;
    }
  }
}

// Dynamic shared memory of a block of `warps` warps.
inline size_t block_smem(size_t shared_floats, size_t warp_floats, int nlist, int P, int nprobe,
                         int warps) {
  const size_t per_warp =
      sizeof(float) * (warp_floats + nlist + P) + sizeof(int) * ((size_t)P + nprobe);
  return sizeof(float) * shared_floats + per_warp * warps;
}

// Warps per block: up to kMaxWarps, as many as fit the shared memory; 0 if
// not even one does.
inline int pick_warps(size_t shared_floats, size_t warp_floats, int nlist, int P, int nprobe) {
  int w = kMaxWarps;
  while (w > 0 && block_smem(shared_floats, warp_floats, nlist, P, nprobe, w) > kSmemLimit) --w;
  return w;
}

}  // namespace ivf
