// Fused IVF probe -> int8 dequant scan -> top-k (IVF_SQ8), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_scan.py::fused_ivf_sq8_topk_pallas.
// One warp per (query, segment), segments on the grid's y axis. The warp
// probes the top-nprobe clusters, walks their member lists (a gather,
// cheap on a GPU, where the TPU scanned the whole segment under a mask),
// scores each candidate as sum_j code_j * (scale_j * q_j) in f32, one
// candidate per lane, with the scale folded into the query once, and keeps
// the top k with ties to the lowest local id. See fused_scan.py for the
// bound and the design note.
#include "ivf_common.cuh"

namespace {

// One candidate's score from its code row (rw words of 4 codes each) and
// the scaled query.
__device__ __forceinline__ float sq8_row_dot(const int* row, int rw, const float* qs) {
  float acc = 0.f;
  for (int w = 0; w < rw; ++w) {
    const int word = row[w];
    const char4 c = *reinterpret_cast<const char4*>(&word);
    const int j = 4 * w;
    acc = fmaf((float)c.x, qs[j], acc);
    acc = fmaf((float)c.y, qs[j + 1], acc);
    acc = fmaf((float)c.z, qs[j + 2], acc);
    acc = fmaf((float)c.w, qs[j + 3], acc);
  }
  return acc;
}

__global__ void fused_sq8_kernel(const float* __restrict__ q, const int8_t* __restrict__ codes,
                                 const float* __restrict__ scale, const float* __restrict__ cents,
                                 const int* __restrict__ members, const int* __restrict__ gids,
                                 int* __restrict__ out_lids, float* __restrict__ out_sims, int B,
                                 int s, int d, int nlist, int cap, int nprobe, int k,
                                 int mask_dead) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * warps + warp, z = blockIdx.y;
  const bool active = b < B;
  const int P = nprobe * cap;
  extern __shared__ float smem[];
  float* cstage = smem;              // 32 * (d | 1), shared by the block
  float* qs = cstage + 32 * (d | 1) + (size_t)warp * (d + nlist + 2 * (size_t)P + nprobe);
  float* csim = qs + d;              // nlist
  float* sc = csim + nlist;          // P
  int* lid = (int*)(sc + P);         // P
  int* probe = lid + P;              // nprobe
  if (active)
    for (int j = lane; j < d; j += 32) qs[j] = q[(size_t)b * d + j];
  __syncthreads();
  ivf::block_probe(qs, cents + (size_t)z * nlist * d, nlist, d, nprobe, cstage, csim, probe,
                   lane, active);
  if (!active) return;
  for (int j = lane; j < d; j += 32) qs[j] *= scale[j];  // q_j -> scale_j * q_j
  __syncwarp();

  const int8_t* cz = codes + (size_t)z * s * d;
  const int n = ivf::compact_candidates(members + (size_t)z * nlist * cap, probe, nprobe, cap,
                                        gids + (size_t)z * s, mask_dead, lid, lane);
  for (int p = lane; p < n; p += 32) {  // one candidate per lane
    const int8_t* row = cz + (size_t)lid[p] * d;
    float acc = 0.f;
    if ((d & 3) == 0) {  // rows are 4-byte aligned: one load per 4 codes
      acc = sq8_row_dot(reinterpret_cast<const int*>(row), d / 4, qs);
    } else {
      for (int j = 0; j < d; ++j) acc = fmaf((float)row[j], qs[j], acc);
    }
    sc[p] = acc;
  }
  __syncwarp();
  const size_t o = ((size_t)z * B + b) * k;
  ivf::warp_topk(sc, lid, n, k, out_lids + o, out_sims + o, lane);
}

}  // namespace

extern "C" int fused_ivf_sq8_topk(const float* q, const int8_t* codes, const float* scale,
                                  const float* cents, const int* members, const int* gids,
                                  int* out_lids, float* out_sims, int B, int n_seg, int s,
                                  int d, int nlist, int cap, int nprobe, int k, int mask_dead,
                                  void* stream) {
  const int P = nprobe * cap;
  const size_t shared = 32 * (size_t)(d | 1);
  const size_t per_warp = d;
  const int warps = ivf::pick_warps(shared, per_warp, nlist, P, nprobe);
  if (warps == 0) return (int)cudaErrorInvalidValue;  // one query's lists exceed shared memory
  const size_t smem = ivf::block_smem(shared, per_warp, nlist, P, nprobe, warps);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sq8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + warps - 1) / warps, n_seg);
  fused_sq8_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      q, codes, scale, cents, members, gids, out_lids, out_sims, B, s, d, nlist, cap, nprobe,
      k, mask_dead);
  return (int)cudaGetLastError();
}
