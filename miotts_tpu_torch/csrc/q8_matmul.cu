// Activation (bf16 or f32) times Q8_0 weights, dequantized in the tile, f32 out.
//
// Replaces: miotts_tpu/ops/pallas/quant_matmul.py::q8_matmul (Pallas TPU
// kernel, body `_kernel` :26, pallas_call :81).
//
// What it computes (as the TPU kernel):
//   y[t, n] = sum_k bf16(x[t, k]) * bf16(float(q[k, n]) * s[k / 32, n])
// with x [T, K] bf16 or f32, q [K, N] int8 (N contiguous), s [K/32, N] f32,
// y [T, N] f32. Each product of two bf16 values is exact in f32, so the
// kernel and its plain version differ only in the order of the f32 sums.
//
// What bounds it on the H100: at decode (T = 1..8) it streams the weights,
// ~1.125 bytes per weight (int8 plus a 4-byte scale per 32), with T FMAs per
// weight -- far below the card's ~295 FLOP/byte balance point. The 0.1B
// logits head (768 x 151.8k) is 116.6 MB of int8 and 14.6 MB of scales: at
// 3.35 TB/s no kernel can take it in less than ~39 us. The dequantization
// itself (byte -> float, times the scale, round to bf16) costs more
// instructions than the FMAs, so it is kept to cheap ones: a byte
// permutation and a subtraction make the float, and one pack instruction
// rounds two weights to bf16. On an NVIDIA H100 80GB HBM3 at 700 W this
// design reads the head at T = 1 in ~76 us (~1.7 TB/s, half the roofline)
// and each layer leaf in ~9 us, 1.5-2.2x the time of cuBLAS's bf16 GEMV
// on twice the bytes (PERF.md keeps the measurements).
//
// Simple design, no tensor cores, TMA or atomics:
// - a block owns 128 output columns and TT rows of x (TT in {1, 2, 4, 8},
//   chosen by the wrapper; larger T is tiled over grid.y). Lane l of each
//   warp owns 4 neighbouring columns, so a warp reads one 128-byte line of
//   int8 per weight row (a coalesced 4-byte load a lane) and one float4 of
//   scales per 32-row block;
// - the block's 8 warps split its K range by whole Q8_0 blocks (warp w takes
//   blocks w, w + 8, ...; the loop over K replaces the TPU's sequential k
//   grid axis) and accumulate in f32 registers; the warps' partial sums are
//   added in shared memory in a fixed order;
// - the bf16-rounded x tile [TT, K-range] sits in shared memory, read as a
//   broadcast by every lane;
// - leaves with few column blocks (wo, w_down: N = 768) would leave most SMs
//   idle, so the wrapper may split K over grid.z as well: each split writes
//   its partial [T, N] to scratch and a second pass adds the splits in
//   order. Results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQBlock = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;              // columns a lane owns
constexpr int kTileN = 32 * kCols;    // columns a block owns
constexpr int kMaxSmem = 227 * 1024;  // opt-in shared memory of one block on sm_90

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four int8 (one 32-bit word) to four exact floats: each byte, offset by 128
// to unsigned, becomes the low mantissa byte of 2^23, and 2^23 + 128 is
// subtracted again.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// grid (ceil(N / 128), ceil(T / TT), Z); block 256 threads. Block (bx, by,
// bz) writes out[bz][t][n] for rows t in [by*TT, by*TT + TT) and columns n
// in [bx*128, bx*128 + 128), summed over the Q8_0 blocks [bz*kb_per_z,
// bz*kb_per_z + kb_per_z).
template <int TT>
__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const void* __restrict__ x, int x_f32, const int8_t* __restrict__ q,
                 const float* __restrict__ s, float* __restrict__ out, int T, int K, int N,
                 int kb_per_z) {
  extern __shared__ float smem[];  // the x tile [TT][span], then the warps' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kTileN + lane * kCols;
  const int t0 = blockIdx.y * TT;
  const int kb0 = blockIdx.z * kb_per_z;
  const int kb1 = min(kb0 + kb_per_z, K / kQBlock);
  const int k0 = kb0 * kQBlock;
  const int span = max(kb1 - kb0, 0) * kQBlock;

  for (int i = threadIdx.x; i < TT * span; i += kThreads) {
    const int t = i / span, k = i - t * span;
    float v = 0.f;
    if (t0 + t < T) {
      const int64_t idx = (int64_t)(t0 + t) * K + k0 + k;
      v = x_f32 ? bf16_round(static_cast<const float*>(x)[idx])
                : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[idx]);
    }
    smem[i] = v;
  }
  __syncthreads();

  float acc[TT][kCols];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[t][j] = 0.f;

  if (c < N) {
    for (int kb = kb0 + warp; kb < kb1; kb += kWarps) {
      const float4 sc = *reinterpret_cast<const float4*>(s + (int64_t)kb * N + c);
      const int8_t* qp = q + (int64_t)kb * kQBlock * N + c;
      const float* xs = smem + (kb - kb0) * kQBlock;
#pragma unroll
      for (int r = 0; r < kQBlock; ++r) {
        float f[4];
        int8x4_to_float(*reinterpret_cast<const uint32_t*>(qp + (int64_t)r * N), f);
        const float2 w01 = __bfloat1622float2(__floats2bfloat162_rn(f[0] * sc.x, f[1] * sc.y));
        const float2 w23 = __bfloat1622float2(__floats2bfloat162_rn(f[2] * sc.z, f[3] * sc.w));
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float xv = xs[t * span + r];
          acc[t][0] = fmaf(xv, w01.x, acc[t][0]);
          acc[t][1] = fmaf(xv, w01.y, acc[t][1]);
          acc[t][2] = fmaf(xv, w23.x, acc[t][2]);
          acc[t][3] = fmaf(xv, w23.y, acc[t][3]);
        }
      }
    }
  }
  __syncthreads();  // the x tile is no longer read: its memory takes the warps' sums

  float* red = smem;  // [kWarps][TT][kTileN]
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[(warp * TT + t) * kTileN + lane * kCols + j] = acc[t][j];
  __syncthreads();
  for (int i = threadIdx.x; i < TT * kTileN; i += kThreads) {
    const int t = i / kTileN, col = i - t * kTileN;
    const int n = blockIdx.x * kTileN + col;
    if (t0 + t < T && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * TT + t) * kTileN + col];
      out[((int64_t)blockIdx.z * T + t0 + t) * N + n] = sum;
    }
  }
}

// out[i] = sum over z of part[z][i], in order z = 0, 1, ...
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int Z,
                                  int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int z = 0; z < Z; ++z) sum += part[z * count + i];
  out[i] = sum;
}

template <int TT>
cudaError_t launch(const void* x, int x_f32, const int8_t* q, const float* s, float* dst, int T,
                   int K, int N, int Z, int kb_per_z, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        q8_matmul_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kTileN - 1) / kTileN, (T + TT - 1) / TT, Z);
  q8_matmul_kernel<TT><<<grid, kThreads, smem, stream>>>(x, x_f32, q, s, dst, T, K, N, kb_per_z);
  return cudaGetLastError();
}

}  // namespace

// x [T, K] (bf16, or f32 when x_f32 != 0), q [K, N] int8, s [K/32, N] f32,
// out [T, N] f32; all contiguous, q 4-byte and s 16-byte aligned. tt in
// {1, 2, 4, 8} is the row tile; Z >= 1 splits K over grid.z, and for Z > 1
// `partial` holds Z * T * N floats of scratch. Requires K % 32 == 0 and
// N % 4 == 0. Launches on `stream` and returns the first CUDA error of the
// launches (0 on success).
extern "C" int miotts_q8_matmul(const void* x, int x_f32, const void* q, const void* s, void* out,
                                void* partial, int T, int K, int N, int tt, int Z, void* stream) {
  if (T < 1 || K < kQBlock || K % kQBlock || N < kCols || N % kCols || Z < 1 ||
      (Z > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkb = K / kQBlock;
  const int kb_per_z = (nkb + Z - 1) / Z;
  const size_t tile = (size_t)tt * kb_per_z * kQBlock, red = (size_t)kWarps * tt * kTileN;
  const size_t smem = (tile > red ? tile : red) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* dst = Z > 1 ? (float*)partial : (float*)out;
  const int8_t* qp = (const int8_t*)q;
  const float* sp = (const float*)s;
  cudaError_t e;
  switch (tt) {
    case 1: e = launch<1>(x, x_f32, qp, sp, dst, T, K, N, Z, kb_per_z, smem, st); break;
    case 2: e = launch<2>(x, x_f32, qp, sp, dst, T, K, N, Z, kb_per_z, smem, st); break;
    case 4: e = launch<4>(x, x_f32, qp, sp, dst, T, K, N, Z, kb_per_z, smem, st); break;
    case 8: e = launch<8>(x, x_f32, qp, sp, dst, T, K, N, Z, kb_per_z, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || Z == 1) return (int)e;
  const int64_t count = (int64_t)T * N;
  sum_splits_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>((const float*)partial,
                                                                      (float*)out, Z, count);
  return (int)cudaGetLastError();
}
