// Unfused PQ asymmetric-distance (ADC) scan, for sm_90a:
//   out[q, n] = sum_j lut[q, j, codes[n, j]],  j = 0 .. m-1 in order.
//
// Replaces the TPU kernel repro/kernels/pq_adc.py::pq_adc_pallas, which had
// no gather and expanded every code into a one-hot row for m matrix
// products. What bounds it on the H100 is writing the (q, n) f32 result;
// the q * n * m table lookups come next, as shared-memory traffic.
//
// Design (the launch plan, kernels/pq_adc.py::launch_plan, picks qt, the
// warps and the grid and passes them in):
// - A block stages the tables of a tile of qt queries (1 to 16) in shared
//   memory, interleaved by query: lt[(j * c + code) * qt + qq]. A lane owns
//   QI = 4 queries of the tile (1 below qt = 4), so one 128-bit load returns
//   its QI terms for a code; the qt / QI lanes that cover the tile share a row
//   group, so at qt = 16 a quarter-warp reads two 64-byte segments (1.5
//   wavefronts on average) where one lane a row would meet ~2.5. A tile of
//   32 (one line a phase) measured slower on the H100: the grid then writes
//   twice as many output rows at once (repro_torch.bench.pq_adc_variants).
//   Queries beyond q are zeros in the tile and never written.
// - A lane owns 4 consecutive code rows, a warp 4 * 32 / (qt / QI) rows a
//   chunk (32 at qt = 16). The warp stages its chunk's codes in its own
//   shared memory, as bytes transposed (a column j holds the chunk's rows),
//   from coalesced loads of the int32 or byte codes as they lie; there each
//   code is checked against [0, c) and clamped into it, so no read leaves
//   the tables and an out-of-range code sets the flag the wrapper reads. A
//   lane then reads one 32-bit word a column: its 4 rows' codes. No block
//   barrier a chunk.
// - Each (query, row) sum is added in order j = 0 .. m-1 in f32, as the
//   plain version adds it, so both agree bit for bit.
// - A lane writes each query's 4 rows as one 16-byte streaming store, so at
//   qt = 16 a warp's store covers 128 contiguous bytes of 4 query rows
//   (plain stores measured 10% slower); scalar stores where n % 4 != 0 or
//   at the ragged end.
// - Persistent grid: the plan's blocks split the (query tile, chunk) work
//   units into equal contiguous ranges, so there is no partial wave and a
//   block restages tables only where its range crosses into the next tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerLane = 4;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTile = 16;  // queries a block's tile holds at most
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one H100 block
constexpr int kMaxDevices = 64;

// The QI terms of one code for this lane's queries, from lt + QI-aligned offset.
template <int QI>
__device__ __forceinline__ void load_terms(const float* p, float (&t)[QI]) {
  if constexpr (QI == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    t[0] = v.x, t[1] = v.y, t[2] = v.z, t[3] = v.w;
  } else {
    t[0] = *p;
  }
}

template <int QI>
__global__ void __launch_bounds__(kMaxThreads, 1)
    pq_adc_kernel(const float* __restrict__ lut, const void* __restrict__ codes,
                  float* __restrict__ out, int* __restrict__ flag, int Q, int N, int m, int c,
                  int code_bytes, int qt, int nc, int units) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mc = m * c;
  const int qt_log = __ffs(qt) - 1;  // qt is a power of two
  const int lanes = qt / QI;         // lanes that share a row group
  const int rows = kRowsPerLane * (32 / lanes);  // code rows of a warp's chunk
  const int stride = rows + 4;                   // bytes of a staged code column
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* lt = reinterpret_cast<float*>(smem);
  uint8_t* cs = smem + qt * mc * (int)sizeof(float) + warp * m * stride;
  const int li = lane & (lanes - 1), g = lane >> (__ffs(lanes) - 1);
  const float* tq = lt + li * QI;                // this lane's queries
  const uint8_t* cg = cs + kRowsPerLane * g;     // this lane's rows of a staged column
  const bool vec_table = mc % 4 == 0 && (reinterpret_cast<uintptr_t>(lut) & 15) == 0;
  const bool vec_out = N % 4 == 0;
  bool bad = false;

  const int u_begin = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u_end = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  for (int u = u_begin; u < u_end;) {
    const int tile = u / nc;
    const int ch_end = min(u_end, (tile + 1) * nc) - tile * nc;
    const int q0 = tile * qt;
    const int nq = min(qt, Q - q0);
    __syncthreads();  // the previous tile's tables are consumed
    if (vec_table) {  // 16-byte reads along a query's table: a quarter of the round trips
      for (int i = threadIdx.x; i < (qt * mc) >> 2; i += blockDim.x) {
        const int qq = i & (qt - 1), p = (i >> qt_log) << 2;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qq < nq) v = *reinterpret_cast<const float4*>(lut + (size_t)(q0 + qq) * mc + p);
        lt[(p + 0) * qt + qq] = v.x;
        lt[(p + 1) * qt + qq] = v.y;
        lt[(p + 2) * qt + qq] = v.z;
        lt[(p + 3) * qt + qq] = v.w;
      }
    } else {
      for (int i = threadIdx.x; i < qt * mc; i += blockDim.x) {  // lt[p * qt + qq]
        const int qq = i & (qt - 1), p = i >> qt_log;
        lt[i] = qq < nq ? lut[(size_t)(q0 + qq) * mc + p] : 0.f;
      }
    }
    __syncthreads();

    for (int ch = u - tile * nc + warp; ch < ch_end; ch += nwarps) {
      const int row0 = ch * rows;
      const int nrows = min(rows, N - row0);
      __syncwarp();  // the previous chunk's staged codes are consumed
      {  // element e = lane + 32 i of the chunk's codes is (row, column) = divmod(e, m)
        const size_t base = (size_t)row0 * m;
        int r = lane / m, j = lane % m;
        const int d_row = 32 / m, d_col = 32 % m;
        for (int e = lane; e < rows * m; e += 32) {
          unsigned v = 0;
          if (r < nrows) {
            v = code_bytes == 1 ? (unsigned)static_cast<const uint8_t*>(codes)[base + e]
                                : (unsigned)static_cast<const int*>(codes)[base + e];
            if (v >= (unsigned)c) {  // negative int32 codes too
              bad = true;
              v = c - 1;
            }
          }
          cs[j * stride + r] = (uint8_t)v;
          r += d_row, j += d_col;
          if (j >= m) j -= m, ++r;
        }
      }
      __syncwarp();

      float acc[kRowsPerLane][QI];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; r += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(cg + r);
#pragma unroll
        for (int b = 0; b < 4; ++b) load_terms<QI>(tq + ((w >> (8 * b)) & 255) * qt, acc[r + b]);
      }
      const float* tj = tq;
      const uint8_t* cj = cg;
      for (int j = 1; j < m; ++j) {
        tj += c * qt, cj += stride;
#pragma unroll
        for (int r = 0; r < kRowsPerLane; r += 4) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(cj + r);  // 4 rows' codes
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float t[QI];
            load_terms<QI>(tj + ((w >> (8 * b)) & 255) * qt, t);
#pragma unroll
            for (int k = 0; k < QI; ++k) acc[r + b][k] = acc[r + b][k] + t[k];
          }
        }
      }

      const int row = row0 + kRowsPerLane * g;
#pragma unroll
      for (int k = 0; k < QI; ++k) {
        if (li * QI + k >= nq) continue;
        float* o = out + (size_t)(q0 + li * QI + k) * N + row;
        if (vec_out && row + kRowsPerLane <= N) {
#pragma unroll
          for (int r = 0; r < kRowsPerLane; r += 4)
            __stcs(reinterpret_cast<float4*>(o + r),
                   make_float4(acc[r][k], acc[r + 1][k], acc[r + 2][k], acc[r + 3][k]));
        } else {
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r)
            if (row + r < N) __stcs(o + r, acc[r][k]);
        }
      }
    }
    u = tile * nc + ch_end;
  }
  if (bad && flag) *flag = 1;
}

template <int QI>
cudaError_t launch(const float* lut, const void* codes, float* out, int* flag, int Q, int N, int m,
                   int c, int code_bytes, int qt, int nc, int units, int warps, int grid, int smem,
                   cudaStream_t stream) {
  // raise the kernel's shared-memory ceiling once a device (the host call is
  // not free: this wrapper runs every few microseconds at small shapes)
  static int ceiling[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || ceiling[dev] < smem) {
    err = cudaFuncSetAttribute(pq_adc_kernel<QI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ceiling[dev] = kSmemLimit;
  }
  pq_adc_kernel<QI><<<grid, warps * 32, smem, stream>>>(lut, codes, out, flag, Q, N, m, c,
                                                        code_bytes, qt, nc, units);
  return cudaGetLastError();
}

// Shared memory a block of `warps` warps needs at a query tile of qt: the
// tile's interleaved tables and each warp's staged code chunk
// (kernels/pq_adc.py::smem_bytes, which the launch plan uses).
long long pq_adc_smem(int m, int c, int qt, int warps) {
  const int qi = qt < 4 ? 1 : 4;
  const int rows = kRowsPerLane * (32 / (qt / qi));
  return (long long)qt * m * c * sizeof(float) + (long long)warps * m * (rows + 4);
}

// codes (N, m) int32 (code_bytes 4) or uint8 (1), contiguous; flag, when not
// null, is a zero int the device can write (host memory mapped for it, or
// device memory), set to 1 by the kernel if a code lies outside [0, c).
// sizes = {Q, N, m, c, code_bytes, qt, warps, grid, smem}: the sizes and the
// launch plan, one array so that a call from Python converts few arguments.
}  // namespace

extern "C" int pq_adc(const float* lut, const void* codes, float* out, int* flag,
                      const int* sizes, void* stream) {
  const int Q = sizes[0], N = sizes[1], m = sizes[2], c = sizes[3], code_bytes = sizes[4];
  const int qt = sizes[5], warps = sizes[6], grid = sizes[7], smem = sizes[8];
  const int qi = qt < 4 ? 1 : 4;
  const int rows = qt >= 1 && qt <= kMaxTile ? kRowsPerLane * (32 / (qt / qi)) : 1;
  const long long nc = (N + rows - 1) / rows;
  const long long units = (long long)((Q + qt - 1) / qt) * nc;
  if (qt < 1 || qt > kMaxTile || (qt & (qt - 1)) || warps < 1 || warps * 32 > kMaxThreads ||
      grid < 1 || smem > kSmemLimit || pq_adc_smem(m, c, qt, warps) > smem ||
      (code_bytes != 1 && code_bytes != 4) || c < 1 || c > 256 || m < 1 || N < 1 || Q < 1 ||
      units > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (qi == 4)
    return (int)launch<4>(lut, codes, out, flag, Q, N, m, c, code_bytes, qt, (int)nc, (int)units,
                          warps, grid, smem, s);
  return (int)launch<1>(lut, codes, out, flag, Q, N, m, c, code_bytes, qt, (int)nc, (int)units,
                        warps, grid, smem, s);
}
