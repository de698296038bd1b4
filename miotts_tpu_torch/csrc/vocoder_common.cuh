// Device routines shared by the mel vocoder's kernels K5 (activation1d.cu)
// and K6 (resblock.cu). The convs of K4 (conv1d.cu) and K6 run the
// implicit-GEMM main loop of conv_gemm.cuh instead; K6 keeps its own
// activation (one pass over each 2x-rate sample, the TPU kernel's fast
// sin/cos) and takes only act_geom and kThreads from here. f32 on the CUDA
// cores.
//
// Layout is the port's [B, T, C] (channels fastest). What is left here:
//
//   act_geom:  the static halo geometry of one Activation1d (K5, K6);
//   act_rows:  BigVGAN's anti-aliased snake (Activation1d) for a range of
//              output rows: 2x upsample (transposed FIR with replicate pad
//              at the true length), ADAA snake-beta, stride-2 FIR down
//              (K5);
//   zero_rows: zero a tile's rows (K5).
//
// Edge rules, by GLOBAL row position, on every tile: act inputs are read at
// clamp(g, 0, length-1) (replicate pad); the upsampled stream's sample
// before 0 is 0; act outputs outside [0, length) are 0 (so a following conv
// sees zero padding); the 2x-rate stream is read at clamp(u, 0, 2*length-1)
// for the downsample's replicate pad.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace miotts_vocoder {

constexpr int kThreads = 256;  // 8 warps a block, for K5 and K6

__host__ __device__ inline int floor_div2(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }  // 16-byte shared offsets

// Static geometry of one Activation1d with up filter k1 taps and down
// filter k2 taps (models/vocoder.py upsample_activation / downsample_
// activation): the upsample pads `pad` rows a side and crops `pl` at the
// 2x rate; the downsample pads `pl2` at its left. An output row t reads
// input rows [t - hlo, t + hhi] only (before the clamp to the length).
struct ActGeom {
  int k1, k2, pad, pl, pl2, hlo, hhi;
};

__host__ inline ActGeom act_geom(int k1, int k2) {
  ActGeom g;
  g.k1 = k1;
  g.k2 = k2;
  g.pad = k1 / 2 - 1;
  g.pl = 2 * g.pad + (k1 - 2) / 2;
  g.pl2 = k2 / 2 - (k2 % 2 == 0 ? 1 : 0);
  // output t reads the 2x stream at p in [2t - pl2, 2t + k2-1 - pl2] and
  // the sample before each; 2x sample u reads input (u + pl - j) / 2 - pad
  g.hlo = g.pad - floor_div2(g.pl - g.pl2 - k1);
  g.hhi = floor_div2(k2 - 1 - g.pl2 + g.pl) - g.pad;
  return g;
}

// One activation's operands: filters staged in shared memory, per-channel
// snake coefficients a = e^alpha and inv = 1 / (2 (e^beta + 1e-9)) in
// device memory (already offset to the block's first channel).
struct ActArgs {
  const float* fu;
  const float* fd;
  const float* a;
  const float* inv;
  ActGeom g;
};

// 2x-rate upsampled sample u >= 0 of channel c: the transposed FIR of the
// zero-stuffed, replicate-padded input, 2 * sum_j fu[j] * x[(u + pl - j) / 2
// - pad] over the j that hit a stuffed (even, non-negative) position. The
// stuffed stream's end is never reached for u < 2 * length.
__device__ __forceinline__ float up_sample(const float* src, int src_lo, int stride, int c, int u,
                                           int len, const float* fu, const ActGeom& g) {
  const int w0 = u + g.pl;
  float acc = 0.f;
  for (int j = w0 & 1; j < g.k1 && j <= w0; j += 2) {
    const int gi = min(max((w0 - j) / 2 - g.pad, 0), len - 1);
    acc = fmaf(fu[j], src[(gi - src_lo) * stride + c], acc);
  }
  return 2.f * acc;
}

// ADAA snake-beta of sample x with predecessor p (models/vocoder.py
// adaa_snake_beta). Accurate sinf/cosf and a true division: a*(x+p) is
// not small, and the fast intrinsics' error grows with |x|.
__device__ __forceinline__ float snake(float x, float p, float a, float inv) {
  const float s = x + p;
  const float ad = a * (x - p);
  const float sinc = fabsf(ad) < 1e-12f ? 1.f : sinf(ad) / ad;
  return s * 0.5f + inv * (1.f - cosf(a * s) * sinc);
}

// Activation1d outputs for global rows [o_lo, o_lo + n_out) of nc channels,
// written to dst (row stride dst_stride; shared or device memory). src
// holds input rows from global row src_lo on (row stride src_stride) and
// must cover the clamped reads of the valid output rows, i.e. rows
// [max(o_lo, 0) - hlo, min(o_lo + n_out, len) - 1 + hhi] clamped to
// [0, len - 1]. Rows outside [0, len) are written as 0. zbuf is shared
// scratch for (2 * (zchunk - 1) + k2) * nc floats: the snake's outputs
// for zchunk output rows at a time. Every thread of the block must call.
__device__ inline void act_rows(const float* src, int src_lo, int src_stride, float* dst,
                                int dst_stride, int o_lo, int n_out, float* zbuf, int zchunk,
                                int nc, int len, const ActArgs& A) {
  const ActGeom& g = A.g;
  const int lo = max(o_lo, 0), hi = min(o_lo + n_out, len);
  for (int i = threadIdx.x; i < n_out * nc; i += blockDim.x) {
    const int r = i / nc, c = i - r * nc;
    const int t = o_lo + r;
    if (t < lo || t >= hi) dst[(int64_t)r * dst_stride + c] = 0.f;
  }
  for (int t0 = lo; t0 < hi; t0 += zchunk) {
    const int n = min(zchunk, hi - t0);
    const int z0 = 2 * t0 - g.pl2;  // first 2x position these outputs read
    const int nz = 2 * (n - 1) + g.k2;
    for (int i = threadIdx.x; i < nz * nc; i += blockDim.x) {
      const int r = i / nc, c = i - r * nc;
      const int u = min(max(z0 + r, 0), 2 * len - 1);  // downsample's replicate pad
      const float cur = up_sample(src, src_lo, src_stride, c, u, len, A.fu, g);
      const float prev = u > 0 ? up_sample(src, src_lo, src_stride, c, u - 1, len, A.fu, g) : 0.f;
      zbuf[r * nc + c] = snake(cur, prev, __ldg(A.a + c), __ldg(A.inv + c));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * nc; i += blockDim.x) {
      const int r = i / nc, c = i - r * nc;
      float acc = 0.f;
      for (int j = 0; j < g.k2; ++j) acc = fmaf(A.fd[j], zbuf[(2 * r + j) * nc + c], acc);
      dst[(int64_t)(t0 - o_lo + r) * dst_stride + c] = acc;
    }
    __syncthreads();
  }
}

// Zero rows [t0, t0 + n) x [c0, c0 + nc) of a [B, T, C] tensor (a tile
// wholly at or past its example's length).
__device__ inline void zero_rows(float* out, int64_t row0, int n, int C, int c0, int nc) {
  for (int i = threadIdx.x; i < n * nc; i += blockDim.x) {
    const int r = i / nc, c = i - r * nc;
    out[(row0 + r) * C + c0 + c] = 0.f;
  }
}

}  // namespace miotts_vocoder
