// Kernel K4: stride-1 'same' dilated conv1d in [B, T, C] layout, f32, with
// the bias, an optional residual and the length mask fused.
//
// Replaces: miotts_tpu/ops/pallas/conv1d.py::conv1d_same_pallas (Pallas TPU
// kernel; pallas_call in _conv_call at :129).
//
// Computes, for x [B, T, Cin], w [k, Cin, Cout] (odd k), lengths [B]:
//   y[b, t] = sum_j x~[b, t + (j - (k-1)/2) * d] @ w[j]  (+ bias) (+ residual)
// where x~ reads 0 at t < 0 and t >= length (zero 'same' padding at the
// true length), and y[b, t] = 0 for t >= length.
//
// What bounds it on the H100: operations. At the vocoder's noise conv
// (T = 384 000 valid rows, k = 7, C = 128) the work is 2 k C^2 T = 88 GFLOP,
// 1.3 ms at the card's 67 TFLOP/s of f32 outside the tensor cores, against
// 0.12 ms to move its 393 MB once. At the short route's 640 rows it is
// bound by latency: the whole conv is 31 MFLOP.
//
// Design: an implicit GEMM, M = rows, N = Cout, K = k * Cin, the K loop
// walking (tap j, 32-channel chunk); the main loop lives in conv_gemm.cuh,
// shared with K6 (resblock.cu). A block owns a TM-row x TN-column
// output tile. It stages the tile's input window [t0 - half, t0 + TM +
// half) x Cin once, with the zero padding applied by cp.async's zero fill,
// at a row stride of Cin + 4 floats so that the rows a warp reads together
// fall in different banks. The weight chunks w[j][ci0:ci0+32][c0:c0+TN]
// stream through two shared buffers with cp.async, the next chunk in
// flight while the current one is used, so each block reads each weight
// once from L2. Each thread keeps an RM x RN register tile (rows strided by
// TM / RM, columns in float4 groups): at 8 x 8, 64 FMAs for every 16
// float4 loads from shared memory. The tile is chosen by T on the host
// (ops/cuda/conv1d.py launch_shape): 128 x 128 with 8 x 8 a thread for
// long inputs, down to 16 x 32 with 2 x 4 a thread, so that 640 rows still
// give 160 blocks. No tensor cores: the sums stay f32, as the TPU
// kernel's do. The epilogue adds the bias and the residual and zeroes rows
// past the length; a tile wholly past the length only zeroes its rows.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 2.27 ms
// for that noise conv, 57.8% of the f32 peak on the valid rows (cuDNN's
// F.conv1d, all 491 520 rows: 2.86 ms), and 15.7 us at 640 rows (k 3),
// 6% of the peak: there the 160 small blocks wait on latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm.cuh"

namespace {

using namespace miotts_conv;

template <int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__(Tile<TM, TN, RM, RN>::kThreads)
conv1d_same_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   const float* __restrict__ residual, float* __restrict__ out, int T, int Cin,
                   int Cout, int k, int d) {
  using Tl = Tile<TM, TN, RM, RN>;
  constexpr int NT = Tl::kThreads;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * TM, c0 = blockIdx.z * TN;
  const int n_out = min(TM, T - t0);
  const int len = min(max(lengths[b], 0), T);
  const int64_t row0 = (int64_t)b * T + t0;
  const int tid = threadIdx.x;
  if (t0 >= len) {  // wholly past the length: zero this tile's rows
    const int nc4 = min(TN, Cout - c0) / 4;
    for (int i = tid; i < n_out * nc4; i += NT) {
      const int r = i / nc4, c = c0 + (i - r * nc4) * 4;
      *reinterpret_cast<float4*>(out + (row0 + r) * Cout + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int half = (k - 1) / 2 * d;
  const int nch = chunks_of(Cin);
  const int XS = nch * kChunk + kXPad;  // window row stride
  const int n_src = TM + 2 * half;
  float* xs = smem;                   // [n_src][XS]
  float* ws = smem + n_src * XS;      // [2][kChunk][TN]

  // the input window, zero outside [0, len) and past Cin
  {
    const int c4n = nch * kChunk / 4;
    const float* xb = x + (int64_t)b * T * Cin;
    for (int i = tid; i < n_src * c4n; i += NT) {
      const int r = i / c4n, c = (i - r * c4n) * 4;
      const int t = t0 - half + r;
      const bool ok = t >= 0 && t < len && c < Cin;
      cp_async16(xs + r * XS + c, ok ? xb + (int64_t)t * Cin + c : x, ok ? 16 : 0);
    }
  }
  const int tx = tid % (TN / RN), ty = tid / (TN / RN);
  float acc[RM][RN];
  conv_gemm<TM, TN, RM, RN>(xs, XS, ws, w, Cin, Cout, c0, k, d, acc);

  // bias, then the residual, then the length mask
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int lr = ty + r * Tl::kRowStep;
    if (lr >= n_out) continue;
    const bool valid = t0 + lr < len;
    const int64_t rowi = (row0 + lr) * Cout;
#pragma unroll
    for (int q = 0; q < Tl::kNQ; ++q) {
      const int col = c0 + q * Tl::kColStep + tx * 4;
      if (col >= Cout) continue;
      float4 v = make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2],
                             acc[r][4 * q + 3]);
      if (bias) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + col);
        v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
      }
      if (residual) {
        const float4 rv = *reinterpret_cast<const float4*>(residual + rowi + col);
        v.x += rv.x; v.y += rv.y; v.z += rv.z; v.w += rv.w;
      }
      if (!valid) v = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(out + rowi + col) = v;
    }
  }
}

template <int TM, int TN, int RM, int RN>
int launch(const float* x, const int* lengths, const float* w, const float* bias,
           const float* residual, float* out, int B, int T, int Cin, int Cout, int k, int d,
           cudaStream_t stream) {
  using Tl = Tile<TM, TN, RM, RN>;
  const size_t smem = Tl::smem(Cin, (k - 1) / 2 * d);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;  // raised once for each larger size seen
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv1d_same_kernel<TM, TN, RM, RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid((T + TM - 1) / TM, B, (Cout + TN - 1) / TN);
  conv1d_same_kernel<TM, TN, RM, RN><<<grid, Tl::kThreads, smem, stream>>>(
      x, lengths, w, bias, residual, out, T, Cin, Cout, k, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, Cin], w [k, Cin, Cout], bias [Cout] or null, residual [B, T, Cout]
// or null, out [B, T, Cout]: f32 contiguous, 16-byte aligned; lengths [B]
// int32; k odd, Cin % 4 == 0, Cout % 4 == 0. `tile` picks the block tile
// (rows x columns, register tile a thread): 0 = 128 x 128 (8 x 8),
// 1 = 64 x 64 (8 x 8), 2 = 16 x 32 (2 x 4). Launches on `stream` and returns
// cudaGetLastError() (0 on success); a window too wide for the 227 KB of
// shared memory fails here.
extern "C" int miotts_conv1d_same_f32(const void* x, const void* lengths, const void* w,
                                      const void* bias, const void* residual, void* out, int B,
                                      int T, int Cin, int Cout, int k, int d, int tile,
                                      void* stream) {
  if (k % 2 == 0 || Cin % 4 || Cout % 4 || d < 1 || B < 1 || B > 65535 || T < 1)
    return (int)cudaErrorInvalidValue;
  const auto* xf = (const float*)x;
  const auto* lf = (const int*)lengths;
  const auto* wf = (const float*)w;
  const auto* bf = (const float*)bias;
  const auto* rf = (const float*)residual;
  auto* of = (float*)out;
  const auto st = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch<128, 128, 8, 8>(xf, lf, wf, bf, rf, of, B, T, Cin, Cout, k, d, st);
    case 1: return launch<64, 64, 8, 8>(xf, lf, wf, bf, rf, of, B, T, Cin, Cout, k, d, st);
    case 2: return launch<16, 32, 2, 4>(xf, lf, wf, bf, rf, of, B, T, Cin, Cout, k, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
