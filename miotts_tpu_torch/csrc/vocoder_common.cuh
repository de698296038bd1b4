// Device routines shared by the mel vocoder's kernels K4 (conv1d.cu),
// K5 (activation1d.cu) and K6 (resblock.cu). f32 on the CUDA cores.
//
// Layout is the port's [B, T, C] (channels fastest). A block stages a time
// tile of rows in shared memory, channels along the row, and the routines
// below turn one staged buffer into the next:
//
//   act_rows:  BigVGAN's anti-aliased snake (Activation1d) for a range of
//              output rows: 2x upsample (transposed FIR with replicate pad
//              at the true length), ADAA snake-beta, stride-2 FIR down.
//   conv_rows: a stride-1 'same' dilated conv for a range of output rows,
//              k shifted [rows, Cin] x [Cin, Cout] products summed in f32.
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

constexpr int kThreads = 256;       // 8 warps a block, for every kernel here
constexpr int kRowsPerThread = 8;   // conv register tile: 8 rows x 4 columns
constexpr int kPassRows = 8 * kRowsPerThread;

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

// Stride-1 'same' conv rows: for local output rows r in [0, n_out) (global
// o_lo + r) and every output column,
//   y[r][co] = sum_j sum_ci W[j][ci][co] * src[o_lo + r + j*d - half - src_lo][ci]
// with half = (k-1)/2 * d, src row stride Cin, W [k, Cin, Cout] in device
// memory (read through L1/L2: 458 KB at k=7, C=128, too large to stage)
// and Cout % 4 == 0. Each thread keeps kRowsPerThread x 4 f32 sums, a warp
// covers 128 columns; epi(r, col, acc4) takes each finished quad. No block
// barrier inside, so warps may leave early.
template <class Epi>
__device__ void conv_rows(const float* src, int src_lo, int Cin, const float* __restrict__ W, int k,
                          int d, int Cout, int o_lo, int n_out, const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = (k - 1) / 2 * d;
  for (int cb = 0; cb < Cout; cb += 128) {
    const int col = cb + lane * 4;
    const bool col_ok = col < Cout;
    for (int pb = 0; pb < n_out; pb += kPassRows) {
      const int r0 = pb + warp * kRowsPerThread;
      if (r0 >= n_out) continue;
      int off[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        off[r] = (min(r0 + r, n_out - 1) + o_lo - half - src_lo) * Cin;
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int j = 0; j < k; ++j) {
        const float* wj = W + (size_t)j * Cin * Cout + (col_ok ? col : 0);
        const int sj = j * d * Cin;
#pragma unroll 4
        for (int ci = 0; ci < Cin; ++ci) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(wj + (size_t)ci * Cout));
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            const float xv = src[off[r] + sj + ci];
            acc[r][0] = fmaf(xv, w.x, acc[r][0]);
            acc[r][1] = fmaf(xv, w.y, acc[r][1]);
            acc[r][2] = fmaf(xv, w.z, acc[r][2]);
            acc[r][3] = fmaf(xv, w.w, acc[r][3]);
          }
        }
      }
      if (col_ok) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          if (r0 + r < n_out) epi(r0 + r, col, acc[r]);
      }
    }
  }
}

// The epilogue that writes a conv's rows to device memory: bias, then the
// residual, then the length mask (rows t >= length are 0).
struct StoreRows {
  float* out;
  const float* bias;      // [Cout] or null
  const float* residual;  // [B, T, Cout] or null
  int64_t row0;           // b * T + first global row of the tile
  int t0, len, Cout;
  __device__ void operator()(int r, int col, const float* acc) const {
    const int64_t idx = (row0 + r) * Cout + col;
    const bool valid = t0 + r < len;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = acc[q];
      if (bias) v += bias[col + q];
      if (residual) v += residual[idx + q];
      out[idx + q] = valid ? v : 0.f;
    }
  }
};

// Zero rows [t0, t0 + n) x [c0, c0 + nc) of a [B, T, C] tensor (a tile
// wholly at or past its example's length).
__device__ inline void zero_rows(float* out, int64_t row0, int n, int C, int c0, int nc) {
  for (int i = threadIdx.x; i < n * nc; i += blockDim.x) {
    const int r = i / nc, c = i - r * nc;
    out[(row0 + r) * C + c0 + c] = 0.f;
  }
}

}  // namespace miotts_vocoder
