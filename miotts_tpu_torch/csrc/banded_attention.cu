// Banded (window-65) attention for the codec transformers, f32.
//
// Replaces: miotts_tpu/ops/pallas/banded_attention.py::banded_attention_pallas
// (Pallas TPU kernel, body `kernel`, pallas_call at :108).
//
// Computes, for q/k/v [BH, T, D] f32 and lengths [BH] int32:
//   out[q] = softmax_k( q.k / sqrt(D) ) . v  over keys admitted by
//   (|k - q| <= half && 0 <= k < length) || k == q      (half = window / 2)
// The diagonal term keeps padded query rows (q >= length) finite; they are
// computed like any other row and equal the plain version's.
//
// What bounds it on the H100: almost nothing at the codec's shapes. A query
// row does (2*half + 1) * D * 2 FMAs (~8.3 k at half 32, D 64) and the
// whole call reads q/k/v once from device memory (a few MB), so the kernel
// sits far below both the f32 FMA roof and the 3.35 TB/s memory roof; what
// costs is latency: staging, reductions and the number of blocks in flight.
//
// Simple design: one block per (bh, 64-row query tile). The tile's K/V rows
// [q0 - half, q0 + 64 + half) and its Q rows are staged once in shared
// memory (rows outside [0, T) are zero and masked), with a row stride of
// D + 1 floats so that lanes reading different rows at the same column hit
// different banks. Each warp then owns query rows: lane j scores keys j,
// j + 32, ... of the row's window, the warp reduces max and sum with
// shuffles, and lanes j, j + 32, ... accumulate output columns from the
// probabilities kept in a per-warp shared buffer. Scores, max, exp and sum
// run in f32; each output element is written once. At half 32 and D 64 the
// block needs 85 KB of shared memory, above the 48 KB static limit, so the
// launcher raises the dynamic limit with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
banded_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, int T, int D, int half, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;                  // padded row stride
  const int W = 2 * half + 1;            // keys in one query's window
  const int rows_kv = kTileQ + 2 * half; // staged K/V rows
  float* qs = smem;                      // [kTileQ][DP]
  float* ks = qs + kTileQ * DP;          // [rows_kv][DP]
  float* vs = ks + rows_kv * DP;         // [rows_kv][DP]
  float* ps = vs + rows_kv * DP;         // [kWarps][W]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int k0 = q0 - half;              // absolute position of staged row 0
  const int64_t base = (int64_t)bh * T * D;
  const int len = lengths[bh];

  for (int i = threadIdx.x; i < rows_kv * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int t = k0 + r;
    const bool in = t >= 0 && t < T;
    ks[r * DP + d] = in ? k[base + (int64_t)t * D + d] : 0.f;
    vs[r * DP + d] = in ? v[base + (int64_t)t * D + d] : 0.f;
  }
  for (int i = threadIdx.x; i < kTileQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    qs[r * DP + d] = t < T ? q[base + (int64_t)t * D + d] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = ps + warp * W;
  for (int r = warp; r < kTileQ; r += kWarps) {
    const int qi = q0 + r;
    if (qi >= T) break;
    const float* qr = qs + r * DP;

    float m = -INFINITY;
    for (int j = lane; j < W; j += 32) {
      const int kp = qi - half + j;      // staged row of kp is r + j
      const bool allow = kp == qi || (kp >= 0 && kp < len && kp < T);
      float s = -INFINITY;
      if (allow) {
        const float* kr = ks + (r + j) * DP;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc * scale;
      }
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);  // finite: the diagonal is always admitted

    float l = 0.f;
    for (int j = lane; j < W; j += 32) {
      const float e = expf(pw[j] - m);   // exp(-inf) = 0 for masked keys
      pw[j] = e;
      l += e;
    }
    l = warp_sum(l);
    __syncwarp();

    const float inv = 1.f / l;
    float* o = out + base + (int64_t)qi * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < W; ++j) acc = fmaf(pw[j] * inv, vs[(r + j) * DP + d], acc);
      o[d] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// q/k/v/out: [BH, T, D] f32 contiguous; lengths: [BH] int32. Launches on
// `stream` and returns cudaGetLastError() (0 on success); a D or window too
// wide for the 227 KB of shared memory a block may have fails here.
extern "C" int miotts_banded_attention_f32(const void* q, const void* k, const void* v,
                                           const void* lengths, void* out, int BH, int T,
                                           int D, int half, float scale, void* stream) {
  const int DP = D + 1;
  const size_t smem = sizeof(float) * ((size_t)kTileQ * DP
                                       + 2 * (size_t)(kTileQ + 2 * half) * DP
                                       + (size_t)kWarps * (2 * half + 1));
  cudaError_t err = cudaFuncSetAttribute(banded_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTileQ - 1) / kTileQ, BH);
  banded_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lengths, (float*)out,
      T, D, half, scale);
  return (int)cudaGetLastError();
}
