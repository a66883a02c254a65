// Fused IVF probe -> PQ ADC scan -> top-k (IVF_PQ), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_adc.py::fused_ivf_pq_topk_pallas.
// Same structure as fused_scan.cu: one warp per (query, segment), the
// probe and the top-k from ivf_common.cuh. The query's ADC table
// (m * c f32, at most 32 KB) sits in shared memory and each candidate's
// score is sum_m lut[m][code_m], a per-byte gather summed in order
// m = 0 .. m-1 (the plain version's order, so the scores agree bit for bit).
#include "ivf_common.cuh"

namespace {

__global__ void fused_pq_kernel(const float* __restrict__ q, const float* __restrict__ lut,
                                const uint8_t* __restrict__ codes, const float* __restrict__ cents,
                                const int* __restrict__ members, const int* __restrict__ gids,
                                int* __restrict__ out_lids, float* __restrict__ out_sims, int B,
                                int s, int d, int m, int c, int nlist, int cap, int nprobe, int k,
                                int mask_dead) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * warps + warp, z = blockIdx.y;
  const bool active = b < B;
  const int P = nprobe * cap;
  const int mc = m * c;
  extern __shared__ float smem[];
  float* cstage = smem;  // 32 * (d | 1), shared by the block
  float* qs = cstage + 32 * (d | 1) + (size_t)warp * (d + mc + nlist + 2 * (size_t)P + nprobe);
  float* lt = qs + d;           // m * c
  float* csim = lt + mc;        // nlist
  float* sc = csim + nlist;     // P
  int* lid = (int*)(sc + P);    // P
  int* probe = lid + P;         // nprobe
  if (active) {
    for (int j = lane; j < d; j += 32) qs[j] = q[(size_t)b * d + j];
    for (int j = lane; j < mc; j += 32) lt[j] = lut[(size_t)b * mc + j];
  }
  __syncthreads();
  ivf::block_probe(qs, cents + (size_t)z * nlist * d, nlist, d, nprobe, cstage, csim, probe,
                   lane, active);
  if (!active) return;

  const int n = ivf::compact_candidates(members + (size_t)z * nlist * cap, probe, nprobe, cap,
                                        gids + (size_t)z * s, mask_dead, lid, lane);
  const uint8_t* cz = codes + (size_t)z * s * m;
  for (int p = lane; p < n; p += 32) {
    const uint8_t* row = cz + (size_t)lid[p] * m;
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc = acc + lt[j * c + row[j]];
    sc[p] = acc;
  }
  __syncwarp();
  const size_t o = ((size_t)z * B + b) * k;
  ivf::warp_topk(sc, lid, n, k, out_lids + o, out_sims + o, lane);
}

}  // namespace

extern "C" int fused_ivf_pq_topk(const float* q, const float* lut, const uint8_t* codes,
                                 const float* cents, const int* members, const int* gids,
                                 int* out_lids, float* out_sims, int B, int n_seg, int s, int d,
                                 int m, int c, int nlist, int cap, int nprobe, int k,
                                 int mask_dead, void* stream) {
  const int P = nprobe * cap;
  const size_t shared = 32 * (size_t)(d | 1);
  const size_t per_warp = (size_t)d + (size_t)m * c;
  const int warps = ivf::pick_warps(shared, per_warp, nlist, P, nprobe);
  if (warps == 0) return (int)cudaErrorInvalidValue;  // one query's lists exceed shared memory
  const size_t smem = ivf::block_smem(shared, per_warp, nlist, P, nprobe, warps);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + warps - 1) / warps, n_seg);
  fused_pq_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      q, lut, codes, cents, members, gids, out_lids, out_sims, B, s, d, m, c, nlist, cap, nprobe,
      k, mask_dead);
  return (int)cudaGetLastError();
}
