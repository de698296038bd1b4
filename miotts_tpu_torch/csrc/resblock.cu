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
// biases; the activations take 1-D filters and per-channel a, inv. They
// are vocoder_common.cuh's act_channel, which K5 runs too: the TPU kernel's
// Cody-Waite + minimax sin/cos (activation1d.py _fast_sincos, |err| ~1e-7,
// argument clamp +-6433) and a reciprocal refined by one Newton step
// (resblock.py _snake).
//
// What bounds it on the H100: operations. The two convs do 2 * 2 k C^2 n
// = 75.5 GFLOP at the top stage (n = 384 000 valid rows, C = 128, k = 3),
// 1.13 ms at 67 TFLOP/s f32; the layer moves only x in and y out (0.15
// ms), which is the point of fusing: the three intermediates never reach
// device memory.
//
// Design: one block of 256 threads per (batch, output tile of n_out rows);
// the tile plan is computed by ops/cuda/resblock.py launch_shape (n_out =
// 128 for k = 3 and filters up to 24 taps at C = 128) and passed in.
// - The margins telescope outward: conv2 needs actB rows +-half2, actB
//   needs conv1 rows -hlo/+hhi (6/5 at 12 taps), conv1 needs actA rows
//   +-half1 = d, actA needs input rows -hlo/+hhi. conv1 is computed for
//   TM1 = 144 rows (>= 128 + 2 + 11), so actA does (144 + 2 d) / 128 <=
//   1.2x and conv1 1.125x of the output rows' work (51-row tiles: 1.45x and
//   1.25x).
// - Both convs run K4's implicit-GEMM main loop (conv_gemm.cuh): weight
//   chunks w[j][ci0:ci0+32][:] double-buffered in shared memory with
//   cp.async, the window at a C+4 row stride, an 8x8 (conv1: 9x8) register
//   tile a thread. Sums stay f32 on the CUDA cores.
// - The activations run one thread per (channel, half of the rows) through
//   vocoder_common.cuh's act_channel over the staged rows: each 2x-rate
//   sample computed once in registers, taps unrolled for 12-tap filters (a
//   generic template takes other tap counts), the steps that reach a
//   clamped edge at clamped indices with the same arithmetic.
// - Shared memory (C = 128, d = 5): the input window (165 rows, later
//   conv1's 144 rows), actA's rows (154, later actB's 130) at 132 floats a
//   row, and the 32 KB weight ring: 197 KB, one block an SM.
// The residual is re-read from x (L2) in conv2's epilogue.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W: 3.27 ms
// at [1, 491 520, 128] with 384 000 valid rows, d = 5 (2.7x its bound;
// 4.08 ms before its activations loaded their first row's window at once,
// the 51-row design 14.12 ms), 0.15-1.73 ms at the earlier vocoder stages.
// clock64 stamps (before that change) put 58% of the block's cycles
// in the convs (each at ~58% of the f32 peak) and 42% in the activations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm.cuh"
#include "smem_limit.cuh"
#include "vocoder_common.cuh"

namespace {

using namespace miotts_vocoder;
using namespace miotts_conv;

constexpr int kTN = 128;  // output channels of one GEMM pass (the block loops over C)
constexpr int kRN = 8;    // register tile columns a thread
constexpr int kMaxSmem = 227 * 1024;

// the tile plans (ops/cuda/resblock.py VARIANTS): conv1 and conv2 GEMM rows
template <int V>
struct Variant;
template <>
struct Variant<0> {
  static constexpr int TM1 = 144, RM1 = 9, TM2 = 128, RM2 = 8;
};
template <>
struct Variant<1> {
  static constexpr int TM1 = 80, RM1 = 5, TM2 = 64, RM2 = 4;
};

// Activation outputs for rows [o_lo, o_lo + n) of every channel: one thread
// per (channel, share of the rows). Every thread of the block must call.
template <int K1, int K2>
__device__ void act_tile(const float* src, int src_lo, float* dst, int XS, int o_lo, int n, int C,
                         int len, const ActOps& A) {
  const int splits = C >= kThreads ? 1 : kThreads / C;
  const int per = (n + splits - 1) / splits;
  for (int w = threadIdx.x; w < C * splits; w += kThreads) {
    const int h = w / C, c = w - h * C;
    act_channel<K1, K2>(src, src_lo, dst, XS, o_lo, min(n, h * per), min(n, h * per + per), c,
                        len, A);
  }
}

// One conv over the window xs: TM output rows of every channel, through
// K4's main loop, each finished float4 handed to epi(row, col, v).
template <int TM, int RM, class Epi>
__device__ __forceinline__ void conv_pass(const float* xs, int XS, float* ws,
                                          const float* __restrict__ w, int C, int k, int d,
                                          const Epi& epi) {
  using Tl = Tile<TM, kTN, RM, kRN>;
  static_assert(Tl::kThreads == kThreads, "one GEMM thread per block thread");
  const int tx = threadIdx.x % (kTN / kRN), ty = threadIdx.x / (kTN / kRN);
  for (int c0 = 0; c0 < C; c0 += kTN) {
    float acc[RM][kRN];
    conv_gemm<TM, kTN, RM, kRN>(xs, XS, ws, w, C, C, c0, k, d, acc);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < Tl::kNQ; ++q) {
        const int col = c0 + q * Tl::kColStep + tx * 4;
        if (col < C)
          epi(ty + r * Tl::kRowStep, col,
              make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]));
      }
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Rows of a tile starting at output row t0 (the plan in the comment at the
// top; ops/cuda/resblock.py launch_shape computes the same).
struct Rows {
  int r3_lo, n3;  // actB outputs = conv2's window
  int r2_lo;      // conv1 outputs (TM1 rows) = actB's input
  int r1_lo, n1;  // actA outputs = conv1's window
  int a_lo, na;   // input window
  int rows_in, rows_a;
};

template <int V>
__host__ __device__ inline Rows rows_of(int t0, int n_out, const ActGeom& gA, const ActGeom& gB,
                                        int half1, int half2) {
  Rows q;
  q.r3_lo = t0 - half2;
  q.n3 = n_out + 2 * half2;
  q.r2_lo = q.r3_lo - gB.hlo;
  q.r1_lo = q.r2_lo - half1;
  q.n1 = Variant<V>::TM1 + 2 * half1;
  q.a_lo = q.r1_lo - gA.hlo;
  q.na = q.n1 + gA.hlo + gA.hhi;
  q.rows_in = max(q.na, Variant<V>::TM1);
  q.rows_a = max(q.n1, Variant<V>::TM2 + 2 * half2);
  return q;
}

template <int V, int K1, int K2>
__global__ void __launch_bounds__(kThreads, 1)
resblock_kernel(const float* __restrict__ x, const int* __restrict__ lengths, ActOps A,
                const float* __restrict__ w1, const float* __restrict__ b1, ActOps Bo,
                const float* __restrict__ w2, const float* __restrict__ b2,
                float* __restrict__ out, int T, int C, int k1c, int d, int k2c, int n_out) {
  using Vt = Variant<V>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y, t0 = blockIdx.x * n_out;
  const int n_tile = min(n_out, T - t0);
  const int len = min(max(lengths[b], 0), T);
  const int64_t row0 = (int64_t)b * T + t0;
  if (t0 >= len) {  // wholly past the length: zero this tile's rows
    const int c4 = C / 4;
    for (int i = tid; i < n_tile * c4; i += kThreads)
      reinterpret_cast<float4*>(out + row0 * C)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int half1 = (k1c - 1) / 2 * d, half2 = (k2c - 1) / 2;
  const Rows q = rows_of<V>(t0, n_out, A.g, Bo.g, half1, half2);
  const int XS = chunks_of(C) * kChunk + kXPad;
  float* buf_in = smem;                   // input window, then conv1's rows
  float* buf_a = buf_in + q.rows_in * XS;  // actA's rows, then actB's rows
  float* ws = buf_a + q.rows_a * XS;       // the weight chunks [2][32][kTN]

  {  // the input window, zero outside [0, len)
    const int c4 = C / 4;
    const float* xb = x + (int64_t)b * T * C;
    for (int i = tid; i < q.na * c4; i += kThreads) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const int t = q.a_lo + r;
      const bool ok = t >= 0 && t < len;
      cp_async16(buf_in + r * XS + c, ok ? xb + (int64_t)t * C + c : x, ok ? 16 : 0);
    }
    cp_async_commit();
  }
  for (int i = tid; i < q.rows_a * (XS - kXPad - C); i += kThreads) {  // channels past C: 0
    const int r = i / (XS - kXPad - C);
    buf_a[r * XS + C + i - r * (XS - kXPad - C)] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  act_tile<K1, K2>(buf_in, q.a_lo, buf_a, XS, q.r1_lo, q.n1, C, len, A);
  __syncthreads();
  conv_pass<Vt::TM1, Vt::RM1>(buf_a, XS, ws, w1, C, k1c, d, [&](int r, int col, float4 v) {
    *reinterpret_cast<float4*>(buf_in + r * XS + col) =
        add4(v, __ldg(reinterpret_cast<const float4*>(b1 + col)));
  });
  __syncthreads();
  act_tile<K1, K2>(buf_in, q.r2_lo, buf_a, XS, q.r3_lo, q.n3, C, len, Bo);
  __syncthreads();
  conv_pass<Vt::TM2, Vt::RM2>(buf_a, XS, ws, w2, C, k2c, 1, [&](int r, int col, float4 v) {
    if (r >= n_tile) return;
    const int64_t idx = (row0 + r) * C + col;
    v = add4(add4(v, __ldg(reinterpret_cast<const float4*>(b2 + col))),
             *reinterpret_cast<const float4*>(x + idx));
    if (t0 + r >= len) v = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(out + idx) = v;
  });
}

template <int V, int K1, int K2>
cudaError_t launch(const float* x, const int* lengths, const ActOps& A, const float* w1,
                   const float* b1, const ActOps& Bo, const float* w2, const float* b2, float* out,
                   int B, int T, int C, int k1c, int d, int k2c, int n_out, size_t smem,
                   cudaStream_t stream) {
  auto kern = resblock_kernel<V, K1, K2>;
  static size_t allowed[miotts_smem::kMaxDevices] = {};  // raised for each larger size seen
  {
    const cudaError_t e = miotts_smem::raise_limit(kern, smem, allowed);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + n_out - 1) / n_out, B);
  kern<<<grid, kThreads, smem, stream>>>(x, lengths, A, w1, b1, Bo, w2, b2, out, T, C, k1c, d, k2c,
                                         n_out);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_taps(bool taps12, const float* x, const int* lengths, const ActOps& A,
                        const float* w1, const float* b1, const ActOps& Bo, const float* w2,
                        const float* b2, float* out, int B, int T, int C, int k1c, int d, int k2c,
                        int n_out, size_t smem, cudaStream_t st) {
  return taps12 ? launch<V, 12, 12>(x, lengths, A, w1, b1, Bo, w2, b2, out, B, T, C, k1c, d, k2c,
                                    n_out, smem, st)
                : launch<V, 0, 0>(x, lengths, A, w1, b1, Bo, w2, b2, out, B, T, C, k1c, d, k2c,
                                  n_out, smem, st);
}

}  // namespace

// x/out [B, T, C] f32 contiguous and 16-byte aligned, lengths [B] int32;
// actA/actB: filters fu [k1 >= 2], fd [k2 >= 1] and a/inv [C], f32; w1
// [k1c, C, C] and w2 [k2c, C, C] f32 with odd k1c/k2c, biases b1/b2 [C],
// 16-byte aligned; C % 4 == 0. `variant` and `n_out` are the tile plan of
// ops/cuda/resblock.py launch_shape (0: conv GEMMs of 144 and 128 rows, 1:
// 80 and 64; n_out output rows a block). Launches on `stream` and returns
// cudaGetLastError() (0 on success); a plan whose rows do not chain or
// whose buffers exceed 227 KB of shared memory fails here.
extern "C" int miotts_resblock_layer_f32(
    const void* x, const void* lengths, const void* fuA, int k1A, const void* fdA, int k2A,
    const void* aA, const void* invA, const void* w1, const void* b1, int k1c, int d,
    const void* fuB, int k1B, const void* fdB, int k2B, const void* aB, const void* invB,
    const void* w2, const void* b2, int k2c, void* out, int B, int T, int C, int variant,
    int n_out, void* stream) {
  if (C < 4 || C % 4 || k1c % 2 == 0 || k2c % 2 == 0 || d < 1 || B < 1 || B > 65535 || T < 1 ||
      k1A < 2 || k1B < 2 || k2A < 1 || k2B < 1 || n_out < 1 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const ActOps A{(const float*)fuA, (const float*)fdA, (const float*)aA, (const float*)invA,
                 act_geom(k1A, k2A)};
  const ActOps Bo{(const float*)fuB, (const float*)fdB, (const float*)aB, (const float*)invB,
                  act_geom(k1B, k2B)};
  const int half1 = (k1c - 1) / 2 * d, half2 = (k2c - 1) / 2;
  const Rows q = variant == 0 ? rows_of<0>(0, n_out, A.g, Bo.g, half1, half2)
                              : rows_of<1>(0, n_out, A.g, Bo.g, half1, half2);
  const int tm1 = variant == 0 ? Variant<0>::TM1 : Variant<1>::TM1;
  const int tm2 = variant == 0 ? Variant<0>::TM2 : Variant<1>::TM2;
  // conv1's rows must cover actB's reads, conv2's tile the output rows
  if (n_out > tm2 || q.n3 + Bo.g.hlo + Bo.g.hhi > tm1) return (int)cudaErrorInvalidValue;
  const int XS = chunks_of(C) * kChunk + kXPad;
  const size_t smem =
      sizeof(float) * ((size_t)(q.rows_in + q.rows_a) * XS + 2 * (size_t)kChunk * kTN);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool taps12 = k1A == 12 && k2A == 12 && k1B == 12 && k2B == 12;
  const auto* xf = (const float*)x;
  const auto* lf = (const int*)lengths;
  const auto st = (cudaStream_t)stream;
  const cudaError_t e =
      variant == 0
          ? launch_taps<0>(taps12, xf, lf, A, (const float*)w1, (const float*)b1, Bo,
                           (const float*)w2, (const float*)b2, (float*)out, B, T, C, k1c, d, k2c,
                           n_out, smem, st)
          : launch_taps<1>(taps12, xf, lf, A, (const float*)w1, (const float*)b1, Bo,
                           (const float*)w2, (const float*)b2, (float*)out, B, T, C, k1c, d, k2c,
                           n_out, smem, st);
  return (int)e;
}
