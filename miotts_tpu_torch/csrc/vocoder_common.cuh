// The mel vocoder's activation, shared by kernels K5 (activation1d.cu) and
// K6 (resblock.cu): BigVGAN's anti-aliased snake (Activation1d), 2x
// upsample (transposed FIR with replicate pad at the true length) -> ADAA
// snake-beta -> stride-2 FIR down, f32 on the CUDA cores. Both kernels run
// act_channel below, so the unfused short-request route (K5, K4, K5, K4)
// and the fused layer (K6) round alike. The convs of K4 and K6 run
// conv_gemm.cuh instead.
//
// Layout is the port's [B, T, C] (channels fastest). Here:
//
//   act_geom / Geo:  the halo geometry of one Activation1d, at run time
//                    and for compile-time taps;
//   fast_sin/cos, rcp_newton, snake: the snake as the TPU kernel computes
//                    it (activation1d.py _fast_sincos, resblock.py _snake);
//   act_channel:     one channel of a run of output rows, each 2x-rate
//                    sample computed once, in registers.
//
// Edge rules, by GLOBAL row position: act inputs are read at clamp(g, 0,
// length-1) (replicate pad); the upsampled stream's sample before 0 is 0;
// act outputs outside [0, length) are 0 (so a following conv sees zero
// padding); the 2x-rate stream is read at clamp(u, 0, 2*length-1) for the
// downsample's replicate pad.
//
// What bounds the activation on the H100: instructions. A steady output
// row costs one new input row, two 6-tap FIRs, two snakes (~60
// instructions each: both sin/cos polynomials are evaluated and one
// selected) and a 12-tap FIR at 12/12 taps, ~180 instructions a lane; it
// moves 8 bytes (K5) or none (K6, in shared memory). A run's first row
// needs 12 snakes; its 12 input rows are loaded at once. Measured on an
// NVIDIA H100 80GB HBM3, 700.00 W: K5 0.379 ms at [1, 491 520, 128] (its
// bound 0.134 ms), K6 3.27 ms (PERF.md §6).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace miotts_vocoder {

constexpr int kThreads = 256;  // 8 warps a block, for K5 and K6

__host__ __device__ constexpr int floor_div2(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

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

// act_geom's numbers for compile-time taps
template <int K1, int K2>
struct Geo {
  static constexpr int pad = K1 / 2 - 1;
  static constexpr int pl = 2 * pad + (K1 - 2) / 2;
  static constexpr int pl2 = K2 / 2 - (K2 % 2 == 0 ? 1 : 0);
  static constexpr int hlo = pad - floor_div2(pl - pl2 - K1);
  static constexpr int hhi = floor_div2(K2 - 1 - pl2 + pl) - pad;
  static constexpr int NX = hlo + hhi + 1;  // input rows an output reads
  // whether tap j reaches the 2x sample 2t - pl2 - 1 + i (an even
  // position of the stuffed stream), and the register index of the input
  // row it reads, relative to the row t - hlo (an even numerator: exact).
  // A step's new samples are i = K2 - 1 and K2; the first row's, i <= K2.
  __host__ __device__ static constexpr bool tap(int i, int j) {
    return ((i - 1 - pl2 + pl - j) & 1) == 0;
  }
  __host__ __device__ static constexpr int rel(int i, int j) {
    return (i - 1 - pl2 + pl - j) / 2 - pad + hlo;
  }
  __host__ __device__ static constexpr bool in_window() {
    for (int i = 0; i <= K2; ++i)
      for (int j = 0; j < K1; ++j)
        if (tap(i, j) && (rel(i, j) < 0 || rel(i, j) >= NX)) return false;
    return pl >= K1 - 1;  // every tap of the same parity is in range for u >= 0
  }
};

// One activation's operands in device memory: filters fu [g.k1], fd [g.k2],
// per-channel a = e^alpha and inv = 1 / (2 (e^beta + 1e-9)).
struct ActOps {
  const float* fu;
  const float* fd;
  const float* a;
  const float* inv;
  ActGeom g;
};

// --- the snake, as the TPU kernel computes it ---------------------------

constexpr float kPio2C1 = 1.5703125f;  // pi/2 in three parts (activation1d.py)
constexpr float kPio2C2 = 4.837512969970703e-04f;
constexpr float kPio2C3 = 7.549790126404332e-08f;
constexpr float kSinCosClamp = 6433.f;

// theta (clamped) = q pi/2 + r, r in [-pi/4, pi/4]
__device__ __forceinline__ float sincos_reduce(float theta, int& q) {
  const float t = fminf(fmaxf(theta, -kSinCosClamp), kSinCosClamp);
  const float kf = rintf(t * 0.636619772367581343f);
  q = (int)kf;
  float r = t - kf * kPio2C1;
  r = r - kf * kPio2C2;
  return r - kf * kPio2C3;
}
// Cephes minimax polynomials on [-pi/4, pi/4]
__device__ __forceinline__ float sin_poly(float r, float r2) {
  return r + r * r2 * (-1.6666654611e-1f + r2 * (8.3321608736e-3f + r2 * -1.9515295891e-4f));
}
__device__ __forceinline__ float cos_poly(float r2) {
  return 1.f - 0.5f * r2 +
         r2 * r2 *
             (4.166664568298827e-2f + r2 * (-1.388731625493765e-3f + r2 * 2.443315711809948e-5f));
}
__device__ __forceinline__ float fast_sin(float theta) {
  int q;
  const float r = sincos_reduce(theta, q), r2 = r * r;
  const float s = (q & 1) ? cos_poly(r2) : sin_poly(r, r2);
  return (q & 2) ? -s : s;
}
__device__ __forceinline__ float fast_cos(float theta) {
  int q;
  const float r = sincos_reduce(theta, q), r2 = r * r;
  const float c = (q & 1) ? sin_poly(r, r2) : cos_poly(r2);
  return ((q + 1) & 2) ? -c : c;
}
__device__ __forceinline__ float rcp_newton(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r * (2.f - v * r);
}
// ADAA snake-beta of sample x with predecessor p (resblock.py _snake)
__device__ __forceinline__ float snake(float x, float p, float a, float inv) {
  const float s = x + p, ad = a * (x - p);
  const bool tiny = fabsf(ad) < 1e-12f;
  const float sinc = tiny ? 1.f : fast_sin(ad) * rcp_newton(ad);
  return s * 0.5f + inv * (1.f - fast_cos(a * s) * sinc);
}

// --- the activation -------------------------------------------------------

// Channel c of output rows [o_lo + r0, o_lo + r1): src holds global row
// src_lo at row 0, dst global row o_lo at row 0, both at row stride XS (in
// shared memory for K6, device memory for K5). Rows outside [0, len) are
// written as 0; src must hold every row in [0, len) that the valid rows
// read. K1 = K2 = 0 takes the taps at run time. kAhead > 0 (src in device
// memory) prefetches the input row kAhead steps ahead into L2.
//
// The thread walks its rows in order and keeps the downsample's K2 snake
// outputs and the upsample's input rows in registers: a step takes one new
// input row, two K1/2-tap FIRs, two snakes and the K2-tap FIR, with no
// integer division. Steps whose reads reach a clamped edge (near 0 and
// near len) compute each new 2x sample and its predecessor at clamped
// indices instead, with the same arithmetic in the same order, so the
// result does not depend on which path ran.
template <int K1, int K2, int kAhead = 0>
__device__ void act_channel(const float* src, int src_lo, float* dst, int XS, int o_lo, int r0,
                            int r1, int c, int len, const ActOps& A) {
  const int g0 = o_lo + r0, g1 = o_lo + r1;
  const int ta = max(g0, 0), tb = min(g1, len);
  if (ta >= tb) {
    for (int t = g0; t < g1; ++t) dst[(t - o_lo) * XS + c] = 0.f;
    return;
  }
  for (int t = g0; t < ta; ++t) dst[(t - o_lo) * XS + c] = 0.f;
  for (int t = tb; t < g1; ++t) dst[(t - o_lo) * XS + c] = 0.f;
  const float a = __ldg(A.a + c), inv = __ldg(A.inv + c);
  const ActGeom& g = A.g;
  auto X = [&](int gi) { return src[(min(max(gi, 0), len - 1) - src_lo) * XS + c]; };

  if constexpr (K1 == 0) {  // generic taps: every 2x sample at clamped indices
    auto up = [&](int u) {
      const int w0 = u + g.pl;
      float acc = 0.f;
      for (int j = w0 & 1; j < g.k1 && j <= w0; j += 2)
        acc = fmaf(__ldg(A.fu + j), X(((w0 - j) >> 1) - g.pad), acc);
      return 2.f * acc;
    };
    for (int t = ta; t < tb; ++t) {
      float acc = 0.f;
      for (int j = 0; j < g.k2; ++j) {
        const int uc = min(max(2 * t - g.pl2 + j, 0), 2 * len - 1);
        const float z = snake(up(uc), uc > 0 ? up(uc - 1) : 0.f, a, inv);
        acc = fmaf(__ldg(A.fd + j), z, acc);
      }
      dst[(t - o_lo) * XS + c] = acc;
    }
  } else {
    using G = Geo<K1, K2>;
    static_assert(G::in_window(), "taps outside the register window");
    float fu[K1], fd[K2];
#pragma unroll
    for (int j = 0; j < K1; ++j) fu[j] = __ldg(A.fu + j);
#pragma unroll
    for (int j = 0; j < K2; ++j) fd[j] = __ldg(A.fd + j);
    auto up = [&](int u) {  // 2x sample u >= 0 at clamped input rows
      const int w0 = u + G::pl;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K1; ++j)
        if (((w0 - j) & 1) == 0) acc = fmaf(fu[j], X(((w0 - j) >> 1) - G::pad), acc);
      return 2.f * acc;
    };
    auto z = [&](int u) {  // the snake at 2x position u, clamped to [0, 2 len - 1]
      const int uc = min(max(u, 0), 2 * len - 1);
      return snake(up(uc), uc > 0 ? up(uc - 1) : 0.f, a, inv);
    };
    auto down = [&](const float(&zw)[K2]) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K2; ++j) acc = fmaf(fd[j], zw[j], acc);
      return acc;
    };
    float zw[K2];  // the snake at 2x positions 2t - pl2 + j
    float xw[G::NX];  // input rows t - hlo .. t + hhi of the last step
    float upl = 0.f;  // the last 2x sample so far
    auto clamped_steps = [&](int t0, int t1) {
      for (int t = t0; t < t1; ++t) {
#pragma unroll
        for (int j = 0; j + 2 < K2; ++j) zw[j] = zw[j + 2];
        zw[K2 - 2] = z(2 * t - G::pl2 + K2 - 2);
        zw[K2 - 1] = z(2 * t - G::pl2 + K2 - 1);
        dst[(t - o_lo) * XS + c] = down(zw);
      }
    };
    // the first row's window: where its reads reach no clamp, its input
    // rows are loaded at once and its 2x samples come from registers (the
    // same sums in the same order as up()); else each at clamped indices
    const bool warm = ta - G::hlo >= 0 && ta + G::hhi <= len - 1 && 2 * ta - G::pl2 - 1 >= 0 &&
                      2 * ta - G::pl2 + K2 - 1 <= 2 * len - 1;
    if (warm) {
#pragma unroll
      for (int i = 0; i < G::NX; ++i) xw[i] = src[(ta - G::hlo + i - src_lo) * XS + c];
      float ups[K2 + 1];  // 2x samples 2 ta - pl2 - 1 + i
#pragma unroll
      for (int i = 0; i <= K2; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K1; ++j)
          if (G::tap(i, j)) acc = fmaf(fu[j], xw[G::rel(i, j)], acc);
        ups[i] = 2.f * acc;
      }
#pragma unroll
      for (int j = 0; j < K2; ++j) zw[j] = snake(ups[j + 1], ups[j], a, inv);
      upl = ups[K2];
    } else {
#pragma unroll
      for (int j = 0; j < K2; ++j) zw[j] = z(2 * ta - G::pl2 + j);
    }
    dst[(ta - o_lo) * XS + c] = down(zw);
    // steps [ia, ib) reach no clamp: the window rows [t - 1 - hlo, t + hhi]
    // lie in [0, len) and the new 2x samples in [1, 2 len - 1]
    const int lo = max(G::hlo + 1, -floor_div2(K2 - 3 - G::pl2));
    const int hi = min(len - G::hhi, floor_div2(2 * len + G::pl2 - K2) + 1);
    const int ia = min(max(ta + 1, lo), tb), ib = max(min(tb, hi), ia);
    clamped_steps(ta + 1, ia);
    if (ia < ib) {
      if (!(warm && ia == ta + 1)) {  // else the window and upl are the first row's
#pragma unroll
        for (int i = 0; i < G::NX; ++i) xw[i] = src[(ia - 1 - G::hlo + i - src_lo) * XS + c];
        upl = up(2 * (ia - 1) - G::pl2 + K2 - 1);
      }
      const float* sp = src + (ia + G::hhi - src_lo) * XS + c;
      float* dp = dst + (ia - o_lo) * XS + c;
      float next = *sp;  // the new input row of step t, loaded a step ahead
      for (int t = ia; t < ib; ++t) {
        if constexpr (kAhead > 0) {
          if (t + kAhead < ib) {
            asm volatile("prefetch.global.L2 [%0];" ::"l"(sp + kAhead * XS));
          }
        }
#pragma unroll
        for (int i = 0; i + 1 < G::NX; ++i) xw[i] = xw[i + 1];
        xw[G::NX - 1] = next;
        sp += XS;
        if (t + 1 < ib) next = *sp;
        float u2[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < K1; ++j)
            if (G::tap(K2 - 1 + s, j)) acc = fmaf(fu[j], xw[G::rel(K2 - 1 + s, j)], acc);
          u2[s] = 2.f * acc;
        }
#pragma unroll
        for (int j = 0; j + 2 < K2; ++j) zw[j] = zw[j + 2];
        zw[K2 - 2] = snake(u2[0], upl, a, inv);
        zw[K2 - 1] = snake(u2[1], u2[0], a, inv);
        upl = u2[1];
        *dp = down(zw);
        dp += XS;
      }
    }
    clamped_steps(ib, tb);
  }
}

}  // namespace miotts_vocoder
