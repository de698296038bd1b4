// The implicit-GEMM main loop of a stride-1 dilated conv1d tile, f32 on the
// CUDA cores, shared by K4 (conv1d.cu) and K6 (resblock.cu).
//
// A block computes a TM-row x TN-column output tile, M = rows, N = output
// channels, K = k * Cin, the K loop walking (tap j, 32-channel chunk). The
// caller stages the tile's input window in shared memory: TM + 2 half rows
// (half = (k-1)/2 * d; window row 0 is output row 0 shifted by -half) at a
// row stride of XS = chunks_of(Cin) * 32 + 4 floats, so that the rows a
// warp reads together fall in different banks, with the channels past Cin
// zero. The weight chunks w[j][ci0:ci0+32][c0:c0+TN] stream through two
// shared buffers with cp.async, the next chunk in flight while the current
// one is used, so each block reads each weight once from L2. Each thread
// keeps an RM x RN register tile (rows strided by TM / RM, columns in
// float4 groups strided by TN / (RN / 4)): at 8 x 8, 64 FMAs for every 16
// float4 loads from shared memory. The caller writes the sums out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace miotts_conv {

using namespace miotts_async;

constexpr int kChunk = 32;  // input channels a weight chunk
constexpr int kXPad = 4;    // floats of row padding in the input window

__host__ __device__ inline int chunks_of(int Cin) { return (Cin + kChunk - 1) / kChunk; }

template <int TM, int TN, int RM, int RN>
struct Tile {
  static constexpr int kThreads = (TM / RM) * (TN / RN);
  static constexpr int kNQ = RN / 4;          // float4 column groups a thread
  static constexpr int kColStep = TN / kNQ;   // between a thread's groups
  static constexpr int kRowStep = TM / RM;    // between a thread's rows
  static size_t smem(int Cin, int half) {
    return sizeof(float) * ((size_t)(TM + 2 * half) * (chunks_of(Cin) * kChunk + kXPad) +
                            2 * (size_t)kChunk * TN);
  }
};

// acc[r][c] = sum over taps j and channels ci of
//   xs[(ty + r * kRowStep + j * d) * XS + ci] * w[j][ci][c0 + col(c)]
// for this thread's rows and columns (tx = tid % (TN / RN), ty = tid /
// (TN / RN); col(c) = (c / 4) * kColStep + tx * 4 + c % 4). xs is the input
// window (see above), ws shared scratch for 2 * kChunk * TN floats, w
// [k, Cin, Cout] in device memory. The caller may have cp.async copies of
// its own in flight: they complete with the first weight chunk. Every
// thread of the block must call; ends with a block barrier.
template <int TM, int TN, int RM, int RN>
__device__ __forceinline__ void conv_gemm(const float* xs, int XS, float* ws,
                                          const float* __restrict__ w, int Cin, int Cout, int c0,
                                          int k, int d, float (&acc)[RM][RN]) {
  using Tl = Tile<TM, TN, RM, RN>;
  constexpr int NT = Tl::kThreads;
  const int tid = threadIdx.x;
  const int nch = chunks_of(Cin);
  auto stage_w = [&](int kc, int buf) {
    const int j = kc / nch, ci0 = (kc - j * nch) * kChunk;
    float* dst = ws + buf * kChunk * TN;
    for (int i = tid; i < kChunk * TN / 4; i += NT) {
      const int r = i / (TN / 4), c = (i - r * (TN / 4)) * 4;
      const int ci = ci0 + r, col = c0 + c;
      const bool ok = ci < Cin && col < Cout;
      cp_async16(dst + r * TN + c, ok ? w + ((int64_t)j * Cin + ci) * Cout + col : w,
                 ok ? 16 : 0);
    }
  };
  stage_w(0, 0);
  cp_async_commit();

  const int tx = tid % (TN / RN), ty = tid / (TN / RN);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

  const int nk = k * nch;
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      stage_w(kc + 1, (kc + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j = kc / nch, ci0 = (kc - j * nch) * kChunk;
    const float* xb = xs + (ty + j * d) * XS + ci0;
    const float* wb = ws + (kc & 1) * kChunk * TN + tx * 4;
#pragma unroll 2
    for (int c4 = 0; c4 < kChunk; c4 += 4) {
      float4 xv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xb + r * Tl::kRowStep * XS + c4);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 wv[Tl::kNQ];
#pragma unroll
        for (int q = 0; q < Tl::kNQ; ++q)
          wv[q] = *reinterpret_cast<const float4*>(wb + (c4 + cc) * TN + q * Tl::kColStep);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float xr = cc == 0 ? xv[r].x : cc == 1 ? xv[r].y : cc == 2 ? xv[r].z : xv[r].w;
#pragma unroll
          for (int q = 0; q < Tl::kNQ; ++q) {
            acc[r][4 * q + 0] = fmaf(xr, wv[q].x, acc[r][4 * q + 0]);
            acc[r][4 * q + 1] = fmaf(xr, wv[q].y, acc[r][4 * q + 1]);
            acc[r][4 * q + 2] = fmaf(xr, wv[q].z, acc[r][4 * q + 2]);
            acc[r][4 * q + 3] = fmaf(xr, wv[q].w, acc[r][4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites this buffer
  }
}

}  // namespace miotts_conv
