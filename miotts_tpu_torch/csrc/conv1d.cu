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
// 0.12 ms to move its 393 MB once.
//
// Simple design: one block per (batch, 128-row time tile). The tile's input
// window [t0 - half, t0 + 128 + half) x Cin is staged in shared memory with
// the zero padding applied as it loads (68 KB at k=7, C=128; the launcher
// raises the dynamic limit). The weights, 458 KB at k=7, are too large to
// stage and are read as float4 through L1/L2. Each thread sums an 8-row x
// 4-column register tile over the taps and Cin; a warp covers 128 output
// columns, eight warps 64 rows a pass. The epilogue adds the bias and the
// residual and zeroes rows past the length. No tensor cores: the sums stay
// f32, as the TPU kernel's do.

#include "vocoder_common.cuh"

namespace {

using namespace miotts_vocoder;

constexpr int kTile = 128;  // output rows a block

__global__ void __launch_bounds__(kThreads)
conv1d_same_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   const float* __restrict__ residual, float* __restrict__ out, int T, int Cin,
                   int Cout, int k, int d) {
  extern __shared__ float xs[];  // [kTile + 2 * half][Cin]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n_out = min(kTile, T - t0);
  const int len = min(max(lengths[b], 0), T);
  const int64_t row0 = (int64_t)b * T + t0;
  if (t0 >= len) {
    zero_rows(out, row0, n_out, Cout, 0, Cout);
    return;
  }
  const int half = (k - 1) / 2 * d;
  const int src_lo = t0 - half;
  const int n_src = n_out + 2 * half;
  for (int i = threadIdx.x; i < n_src * Cin; i += kThreads) {
    const int r = i / Cin, c = i - r * Cin;
    const int t = src_lo + r;
    xs[i] = (t >= 0 && t < len) ? x[((int64_t)b * T + t) * Cin + c] : 0.f;
  }
  __syncthreads();
  conv_rows(xs, src_lo, Cin, w, k, d, Cout, t0, n_out,
            StoreRows{out, bias, residual, row0, t0, len, Cout});
}

}  // namespace

// x [B, T, Cin], w [k, Cin, Cout], bias [Cout] or null, residual [B, T, Cout]
// or null, out [B, T, Cout]: f32 contiguous; lengths [B] int32; k odd,
// Cout % 4 == 0. Launches on `stream` and returns cudaGetLastError() (0 on
// success); a window too wide for the 227 KB of shared memory fails here.
extern "C" int miotts_conv1d_same_f32(const void* x, const void* lengths, const void* w,
                                      const void* bias, const void* residual, void* out, int B,
                                      int T, int Cin, int Cout, int k, int d, void* stream) {
  const int half = (k - 1) / 2 * d;
  const size_t smem = sizeof(float) * (size_t)(kTile + 2 * half) * Cin;
  cudaError_t err = cudaFuncSetAttribute(conv1d_same_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTile - 1) / kTile, B);
  conv1d_same_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)lengths, (const float*)w, (const float*)bias,
      (const float*)residual, (float*)out, T, Cin, Cout, k, d);
  return (int)cudaGetLastError();
}
