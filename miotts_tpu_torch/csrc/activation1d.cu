// Kernel K5: BigVGAN's anti-aliased snake activation (Activation1d) in
// [B, T, C] layout, f32: 2x upsample -> ADAA snake-beta -> 2x downsample,
// length unchanged, one pass.
//
// Replaces: miotts_tpu/ops/pallas/activation1d.py::fused_activation1d
// (Pallas TPU kernel; pallas_call in _fused_call at :329).
//
// Computes models/vocoder.py's composite upsample_activation ->
// adaa_snake_beta -> downsample_activation for 1-D filters fu [k1 >= 2],
// fd [k2 >= 1] and per-channel a = e^alpha, inv = 1 / (2 (e^beta + 1e-9)):
// replicate padding reads the true edges (clamp to [0, length-1] at the
// input rate and [0, 2 length - 1] at the 2x rate), the 2x stream's sample
// before 0 is 0, and rows t >= length are 0.
//
// What bounds it on the H100: bytes. At [1, 491 520, 128] with 384 000 valid
// rows it must read 197 MB and write 252 MB (0.13 ms at 3.35 TB/s); per
// output it evaluates two 2x samples (a 6-tap FIR and the snake: a sinf, a
// cosf, a division and ~9 more operations each) and a 12-tap FIR, ~72
// operations, 0.05 ms at 67 TFLOP/s if sinf/cosf cost what an FMA does
// (they cost several times more).
//
// Simple design: one block per (batch, 128-row tile, 32 channels); a warp's
// lanes run along the channels, so every load and store is coalesced. The
// tile's input window (plus an 11-row halo at 12/12 taps) is staged in
// shared memory; the snake's outputs for 64 output rows at a time go to a
// shared buffer, from which the stride-2 FIR reads. Each 2x sample is
// recomputed from the staged input where it is needed (upsampled value and
// its predecessor), so no 2x-rate signal reaches device memory, and the
// edge rules are clamped indices by global position rather than the TPU
// kernel's masked sums. sinf/cosf are the accurate versions (no
// --use_fast_math): the snake's arguments are not small.

#include "vocoder_common.cuh"

namespace {

using namespace miotts_vocoder;

constexpr int kTile = 128;   // output rows a block
constexpr int kCh = 32;      // channels a block
constexpr int kZChunk = 64;  // output rows whose snake samples are buffered at once

__global__ void __launch_bounds__(kThreads)
activation1d_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                    const float* __restrict__ fu_g, const float* __restrict__ fd_g,
                    const float* __restrict__ a, const float* __restrict__ inv,
                    float* __restrict__ out, int T, int C, ActGeom g) {
  extern __shared__ float smem[];
  float* fu = smem;                         // [k1]
  float* fd = fu + pad4(g.k1);              // [k2]
  float* xs = fd + pad4(g.k2);              // [kTile + hlo + hhi][kCh]
  float* zb = xs + (kTile + g.hlo + g.hhi) * kCh;  // [2 (kZChunk - 1) + k2][kCh]

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kCh;
  const int t0 = blockIdx.x * kTile;
  const int nc = min(kCh, C - c0);
  const int n_out = min(kTile, T - t0);
  const int len = min(max(lengths[b], 0), T);
  const int64_t row0 = (int64_t)b * T + t0;
  if (t0 >= len) {
    zero_rows(out, row0, n_out, C, c0, nc);
    return;
  }
  for (int i = threadIdx.x; i < g.k1; i += kThreads) fu[i] = fu_g[i];
  for (int i = threadIdx.x; i < g.k2; i += kThreads) fd[i] = fd_g[i];
  const int src_lo = t0 - g.hlo;
  const int n_src = n_out + g.hlo + g.hhi;
  for (int i = threadIdx.x; i < n_src * nc; i += kThreads) {
    const int r = i / nc, c = i - r * nc;
    const int t = src_lo + r;  // rows outside [0, length) are never read
    xs[r * nc + c] = (t >= 0 && t < T) ? x[((int64_t)b * T + t) * C + c0 + c] : 0.f;
  }
  __syncthreads();
  act_rows(xs, src_lo, nc, out + row0 * C + c0, C, t0, n_out, zb, kZChunk, nc, len,
           ActArgs{fu, fd, a + c0, inv + c0, g});
}

}  // namespace

// x/out [B, T, C] f32 contiguous, lengths [B] int32, fu [k1] and fd [k2]
// f32 (k1 >= 2, k2 >= 1), a/inv [C] f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int miotts_activation1d_f32(const void* x, const void* lengths, const void* fu, int k1,
                                       const void* fd, int k2, const void* a, const void* inv,
                                       void* out, int B, int T, int C, void* stream) {
  const ActGeom g = act_geom(k1, k2);
  const size_t smem = sizeof(float) * ((size_t)pad4(k1) + pad4(k2)
                                       + (size_t)(kTile + g.hlo + g.hhi) * kCh
                                       + (size_t)(2 * (kZChunk - 1) + k2) * kCh);
  cudaError_t err = cudaFuncSetAttribute(activation1d_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTile - 1) / kTile, (C + kCh - 1) / kCh, B);
  activation1d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)lengths, (const float*)fu, (const float*)fd, (const float*)a,
      (const float*)inv, (float*)out, T, C, g);
  return (int)cudaGetLastError();
}
