// Kernel K6: one AMP resblock layer of the mel vocoder in ONE launch,
//   y = conv2(actB(conv1(actA(x), dilation d))) + x,   [B, T, C] f32,
// with every intermediate kept in shared memory.
//
// Replaces: miotts_tpu/ops/pallas/resblock.py::fused_resblock_layer (Pallas
// TPU kernel; pallas_call in _resblock_call at :218).
//
// Computes models/vocoder.py's unfused chain activation1d -> conv1d_same ->
// activation1d -> conv1d_same(+ residual) with its edge rules at every
// stage: the activations read their input at clamp(t, 0, length-1) and
// write 0 outside [0, length), so the convs see zero padding; rows
// t >= length of the result are 0. The C x C x k convs (odd k) carry their
// biases; the activations take 1-D filters and per-channel a, inv (see
// activation1d.cu).
//
// What bounds it on the H100: operations. The two convs do 2 * 2 k C^2 T
// = 75.5 GFLOP at the top stage (T = 491 520 padded rows, C = 128, k = 3),
// 1.13 ms at 67 TFLOP/s f32; the layer moves only x in and y out (503 MB,
// 0.15 ms), which is the point of fusing: the three intermediates never
// reach device memory.
//
// Simple design: one block per (batch, 51-row output tile). The margins
// telescope outward (k = 3, 12-tap filters, d = 5): conv2 needs actB rows
// +-1, actB needs conv1 rows -6/+5, conv1 needs actA rows +-d, actA needs
// input rows -6/+5, so the input window is 51 + 34 rows. The halo rows are
// recomputed by each tile (actA does ~1.45x and conv1 ~1.25x the output
// rows' work); 51 makes conv1's 64 rows exactly one pass of the 8-warp
// register tiling. Two row buffers alternate: input -> [actA] -> R1 ->
// [conv1] -> input's buffer -> [actB] -> R1's buffer -> [conv2] -> device
// memory, plus the snake scratch: 119 KB at C = 128. Weights (2 x 196 KB)
// are read through L1/L2, as in K4; the residual is re-read from x.

#include "vocoder_common.cuh"

namespace {

using namespace miotts_vocoder;

constexpr int kTile = 51;    // output rows a block (see above)
constexpr int kZChunk = 32;  // activation output rows buffered at once

// Row ranges of one tile: global first row and count of each stage's
// output, outermost last.
struct Ranges {
  int r3_lo, n3;  // actB outputs (conv2 input)
  int r2_lo, n2;  // conv1 outputs (actB input)
  int r1_lo, n1;  // actA outputs (conv1 input)
  int a_lo, na;   // input rows (actA input)
};

__host__ __device__ inline Ranges ranges(int t0, int n_out, const ActGeom& gA, const ActGeom& gB,
                                         int half1, int half2) {
  Ranges q;
  q.r3_lo = t0 - half2;
  q.n3 = n_out + 2 * half2;
  q.r2_lo = q.r3_lo - gB.hlo;
  q.n2 = q.n3 + gB.hlo + gB.hhi;
  q.r1_lo = q.r2_lo - half1;
  q.n1 = q.n2 + 2 * half1;
  q.a_lo = q.r1_lo - gA.hlo;
  q.na = q.n1 + gA.hlo + gA.hhi;
  return q;
}

// conv1's epilogue: bias, into a shared row buffer.
struct StoreShared {
  float* dst;
  const float* bias;
  int C;
  __device__ void operator()(int r, int col, const float* acc) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[r * C + col + q] = acc[q] + bias[col + q];
  }
};

__global__ void __launch_bounds__(kThreads)
resblock_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                const float* __restrict__ fuA_g, const float* __restrict__ fdA_g,
                const float* __restrict__ aA, const float* __restrict__ invA,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ fuB_g, const float* __restrict__ fdB_g,
                const float* __restrict__ aB, const float* __restrict__ invB,
                const float* __restrict__ w2, const float* __restrict__ b2,
                float* __restrict__ out, int T, int C, ActGeom gA, ActGeom gB, int k1c, int d,
                int k2c, int buf0_rows, int buf1_rows) {
  extern __shared__ float smem[];
  float* fuA = smem;
  float* fdA = fuA + pad4(gA.k1);
  float* fuB = fdA + pad4(gA.k2);
  float* fdB = fuB + pad4(gB.k1);
  float* buf0 = fdB + pad4(gB.k2);   // input window, then conv1's rows
  float* buf1 = buf0 + buf0_rows * C;  // actA's rows, then actB's rows
  float* zb = buf1 + buf1_rows * C;  // snake scratch

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n_out = min(kTile, T - t0);
  const int len = min(max(lengths[b], 0), T);
  const int64_t row0 = (int64_t)b * T + t0;
  if (t0 >= len) {
    zero_rows(out, row0, n_out, C, 0, C);
    return;
  }
  const int half1 = (k1c - 1) / 2 * d, half2 = (k2c - 1) / 2;
  const Ranges q = ranges(t0, n_out, gA, gB, half1, half2);
  for (int i = threadIdx.x; i < gA.k1; i += kThreads) fuA[i] = fuA_g[i];
  for (int i = threadIdx.x; i < gA.k2; i += kThreads) fdA[i] = fdA_g[i];
  for (int i = threadIdx.x; i < gB.k1; i += kThreads) fuB[i] = fuB_g[i];
  for (int i = threadIdx.x; i < gB.k2; i += kThreads) fdB[i] = fdB_g[i];
  for (int i = threadIdx.x; i < q.na * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const int t = q.a_lo + r;  // rows outside [0, length) are never read
    buf0[i] = (t >= 0 && t < T) ? x[((int64_t)b * T + t) * C + c] : 0.f;
  }
  __syncthreads();
  act_rows(buf0, q.a_lo, C, buf1, C, q.r1_lo, q.n1, zb, kZChunk, C, len,
           ActArgs{fuA, fdA, aA, invA, gA});
  __syncthreads();
  conv_rows(buf1, q.r1_lo, C, w1, k1c, d, C, q.r2_lo, q.n2, StoreShared{buf0, b1, C});
  __syncthreads();
  act_rows(buf0, q.r2_lo, C, buf1, C, q.r3_lo, q.n3, zb, kZChunk, C, len,
           ActArgs{fuB, fdB, aB, invB, gB});
  __syncthreads();
  conv_rows(buf1, q.r3_lo, C, w2, k2c, 1, C, t0, n_out,
            StoreRows{out, b2, x, row0, t0, len, C});
}

}  // namespace

// x/out [B, T, C] f32 contiguous, lengths [B] int32; actA/actB: filters
// fu [k1 >= 2], fd [k2 >= 1] and a/inv [C], f32; w1 [k1c, C, C] and
// w2 [k2c, C, C] f32 with odd k1c/k2c, biases b1/b2 [C]; C % 4 == 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success); a C
// too wide for the 227 KB of shared memory fails here.
extern "C" int miotts_resblock_layer_f32(
    const void* x, const void* lengths, const void* fuA, int k1A, const void* fdA, int k2A,
    const void* aA, const void* invA, const void* w1, const void* b1, int k1c, int d,
    const void* fuB, int k1B, const void* fdB, int k2B, const void* aB, const void* invB,
    const void* w2, const void* b2, int k2c, void* out, int B, int T, int C, void* stream) {
  const ActGeom gA = act_geom(k1A, k2A), gB = act_geom(k1B, k2B);
  const Ranges q = ranges(0, kTile, gA, gB, (k1c - 1) / 2 * d, (k2c - 1) / 2);
  const int buf0_rows = max(q.na, q.n2), buf1_rows = max(q.n1, q.n3);
  const int z_rows = 2 * (kZChunk - 1) + max(k2A, k2B);
  const size_t smem = sizeof(float) * ((size_t)pad4(k1A) + pad4(k2A) + pad4(k1B) + pad4(k2B)
                                       + (size_t)(buf0_rows + buf1_rows + z_rows) * C);
  cudaError_t err = cudaFuncSetAttribute(resblock_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTile - 1) / kTile, B);
  resblock_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)lengths, (const float*)fuA, (const float*)fdA,
      (const float*)aA, (const float*)invA, (const float*)w1, (const float*)b1,
      (const float*)fuB, (const float*)fdB, (const float*)aB, (const float*)invB,
      (const float*)w2, (const float*)b2, (float*)out, T, C, gA, gB, k1c, d, k2c, buf0_rows,
      buf1_rows);
  return (int)cudaGetLastError();
}
