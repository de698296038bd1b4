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
// before 0 is 0, and rows t >= length are 0. The snake is the TPU kernel's
// default (fast Cody-Waite + minimax sin/cos, Newton reciprocal), the same
// device code as K6's activations (vocoder_common.cuh act_channel).
//
// What bounds it on the H100: bytes, at 0.134 ms for [1, 491 520, 128]
// with 384 000 valid rows (197 MB read, 252 MB written at 3.35 TB/s). Its
// instructions come close: ~180 an output row a lane (two snakes of ~60,
// two 6-tap FIRs, one 12-tap FIR, the window shifts) are ~0.3 ms at the
// card's FP32 issue rate, which is what the kernel's time approaches.
//
// Design: a thread owns one channel and one run of output rows, and walks
// the run with act_channel, reading x straight from device memory (no
// shared memory: there is no conv to feed); the 32 lanes of a warp are 32
// adjacent channels, so every row a warp reads or writes is one 128-byte
// line. A run starts by loading its first row's 12-row window at once;
// then each step reads one new row, prefetched into L2 8 steps ahead so
// that a warp keeps several rows in flight. The run length and the warps of
// a block come from ops/cuda/activation1d.py launch_shape: 128 rows at the
// last stage (the warm-up small against the run), down to 1 row at the
// short route's 640 rows (enough warps on the card; there a lone warp's
// chain of ~180 dependent instructions a step is the time).
//
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (scripts/
// bench_torch_k1_k5.py --sweep): 0.379 ms at [1, 491 520, 128] with 384 000
// valid rows (2.8x its bound; the earlier block-staged design: 1.674 ms),
// 58 us at 61 440 rows, 15 us at 5 120, 9.5 us at 640 (the earlier design:
// 0.213 ms, 64 us, 54 us).

#include "vocoder_common.cuh"

namespace {

using namespace miotts_vocoder;

constexpr int kAheadRows = 8;  // L2 prefetch distance of the input rows

template <int K1, int K2>
__global__ void __launch_bounds__(kThreads)
activation1d_kernel(const float* __restrict__ x, const int* __restrict__ lengths, ActOps A,
                    float* __restrict__ out, int T, int C, int run) {
  const int lane = threadIdx.x & 31;
  const int groups = (C + 31) / 32;  // 32-channel groups a row
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int c = (w % groups) * 32 + lane;
  const int r0 = (w / groups) * run;
  if (c >= C || r0 >= T) return;
  const int b = blockIdx.y;
  const int len = min(max(lengths[b], 0), T);
  const int64_t off = (int64_t)b * T * C;
  act_channel<K1, K2, kAheadRows>(x + off, 0, out + off, C, 0, r0, min(T, r0 + run), c, len, A);
}

template <int K1, int K2>
cudaError_t launch(const float* x, const int* lengths, const ActOps& A, float* out, int B, int T,
                   int C, int run, int warps, cudaStream_t stream) {
  const long long runs = (T + run - 1) / run, all = runs * ((C + 31) / 32);
  const dim3 grid((unsigned)((all + warps - 1) / warps), B);
  activation1d_kernel<K1, K2><<<grid, warps * 32, 0, stream>>>(x, lengths, A, out, T, C, run);
  return cudaGetLastError();
}

}  // namespace

// x/out [B, T, C] f32 contiguous, lengths [B] int32, fu [k1] and fd [k2]
// f32 (k1 >= 2, k2 >= 1), a/inv [C] f32. `run` (output rows a thread) and
// `warps` (a block) are the plan of ops/cuda/activation1d.py launch_shape.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int miotts_activation1d_f32(const void* x, const void* lengths, const void* fu, int k1,
                                       const void* fd, int k2, const void* a, const void* inv,
                                       void* out, int B, int T, int C, int run, int warps,
                                       void* stream) {
  if (k1 < 2 || k2 < 1 || B < 1 || B > 65535 || T < 1 || C < 1 ||
      (long long)T * C >= (1LL << 31) || run < 1 || warps < 1 || warps * 32 > kThreads)
    return (int)cudaErrorInvalidValue;
  const ActOps A{(const float*)fu, (const float*)fd, (const float*)a, (const float*)inv,
                 act_geom(k1, k2)};
  const auto* xf = (const float*)x;
  const auto* lf = (const int*)lengths;
  auto* of = (float*)out;
  const auto st = (cudaStream_t)stream;
  return (int)(k1 == 12 && k2 == 12 ? launch<12, 12>(xf, lf, A, of, B, T, C, run, warps, st)
                                    : launch<0, 0>(xf, lf, A, of, B, T, C, run, warps, st));
}
