// One-token GQA attention over the LLM's KV cache (the decode step), bf16.
//
// Replaces: miotts_tpu/ops/pallas/decode_attention.py::decode_attention_pallas
// (Pallas TPU kernel, body `_kernel` :60, pallas_call :188).
//
// Operand contract (as the JAX kernel and decode_attention_xla):
//   q [B, KVH, G, HD], k_cur/v_cur [B, KVH, HD], cache_k/cache_v
//   [B, S, KVH, HD], pos [B] int32; all bf16 but pos. Keys are read
//   STRICTLY below pos[b] (the caller scatters this step's k/v after the
//   layer stack), plus the current token's k/v passed as operands. Scores,
//   max, exp and sum run in f32; the cache probabilities are rounded to
//   bf16 before the value product; the output [B, KVH*G*HD] is bf16, with
//   the current token's term rounded as decode_attention_xla rounds it.
//   A lane with pos = 0 attends to its current token alone.
//
// What bounds it on the H100: device-memory bytes and latency. Each block
// streams pos * HD * 2 bytes of K (twice: once per pass) and of V once, and
// does 2 * G FMAs per element read -- far below the card's 295 FLOP/byte
// balance point. At the 0.1B shape (B 1, KVH 2, G 6, HD 64, S 700) the
// whole call moves ~0.5 MB, so it is bound by launch and per-block latency,
// not by bandwidth.
//
// Simple design: one block per (lane, kv head) serves that head's G query
// heads, so each K/V row is read once for all G of them. Pass 1: each
// thread takes cache rows s = t, t + 128, ... (16-byte loads of a row), keeps
// an online max and sum per query head, and the block combines them and
// folds in the current token. Pass 2 walks the rows in 128-row tiles:
// threads recompute their row's scores, write the bf16-rounded
// probabilities to shared memory, then each thread accumulates output
// columns (d, g) over the tile, with coalesced V loads. The TPU kernel's
// lane-block/MXU trick is not carried over; a flash-decoding split over S
// (more blocks for long caches) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;
constexpr int kMaxHD = 128;

__device__ __forceinline__ void row_scores(const __nv_bfloat16* __restrict__ krow,
                                           const float (*qs)[kMaxHD], int G, int HD,
                                           float scale, float* acc) {
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  for (int c = 0; c < HD; c += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float kf[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      kf[2 * j] = f.x;
      kf[2 * j + 1] = f.y;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g] = fmaf(qs[g][c + j], kf[j], acc[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] *= scale;
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_cur,
                        const __nv_bfloat16* __restrict__ v_cur,
                        const __nv_bfloat16* __restrict__ cache_k,
                        const __nv_bfloat16* __restrict__ cache_v,
                        const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                        int S, int KVH, int G, int HD, float scale) {
  __shared__ float qs[kMaxG][kMaxHD];
  __shared__ float ps[kMaxG][kThreads];
  __shared__ float red_m[kMaxG][kThreads];
  __shared__ float red_l[kMaxG][kThreads];
  __shared__ float m_fin[kMaxG], l_fin[kMaxG], p_cur[kMaxG];

  const int b = blockIdx.x / KVH, n = blockIdx.x - b * KVH;
  const int t = threadIdx.x;
  const int P = min(max(pos[b], 0), S);
  const int64_t row_stride = (int64_t)KVH * HD;  // between cache rows s, s + 1
  const __nv_bfloat16* kc = cache_k + (int64_t)b * S * row_stride + (int64_t)n * HD;
  const __nv_bfloat16* vc = cache_v + (int64_t)b * S * row_stride + (int64_t)n * HD;
  const int64_t head = (int64_t)(b * KVH + n);

  for (int i = t; i < G * HD; i += kThreads)
    qs[i / HD][i % HD] = __bfloat162float(q[head * G * HD + i]);
  __syncthreads();

  // pass 1: per-thread online max/sum over rows s = t, t + 128, ...
  float m[kMaxG], l[kMaxG], x[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) { m[g] = -INFINITY; l[g] = 0.f; }
  for (int s = t; s < P; s += kThreads) {
    row_scores(kc + s * row_stride, qs, G, HD, scale, x);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (x[g] > m[g]) { l[g] = l[g] * expf(m[g] - x[g]) + 1.f; m[g] = x[g]; }
      else { l[g] += expf(x[g] - m[g]); }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) { red_m[g][t] = m[g]; red_l[g][t] = l[g]; }
  __syncthreads();

  if (t < G) {
    const int g = t;
    float M = -INFINITY;
    for (int i = 0; i < kThreads; ++i) M = fmaxf(M, red_m[g][i]);
    float L = 0.f;
    if (M > -INFINITY)
      for (int i = 0; i < kThreads; ++i)
        if (red_m[g][i] > -INFINITY) L += red_l[g][i] * expf(red_m[g][i] - M);
    // the current token's score
    const __nv_bfloat16* kr = k_cur + head * HD;
    float sc = 0.f;
    for (int d = 0; d < HD; ++d) sc = fmaf(qs[g][d], __bfloat162float(kr[d]), sc);
    sc *= scale;
    const float Mf = fmaxf(M, sc);
    const float Lf = (M > -INFINITY ? L * expf(M - Mf) : 0.f) + expf(sc - Mf);
    m_fin[g] = Mf;
    l_fin[g] = Lf;
    p_cur[g] = expf(sc - Mf) / Lf;
  }
  __syncthreads();

  // pass 2: bf16 probabilities per tile, then the value product
  const int d = t % HD;
  const int gs = t / HD, ngs = kThreads / HD;  // this thread owns g = gs, gs + ngs, ...
  float acc[kMaxG];
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < P; s0 += kThreads) {
    const int s = s0 + t;
    if (s < P) {
      row_scores(kc + s * row_stride, qs, G, HD, scale, x);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) ps[g][t] = __bfloat162float(__float2bfloat16(expf(x[g] - m_fin[g]) / l_fin[g]));
    }
    __syncthreads();
    const int rows = min(kThreads, P - s0);
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      const float vv = __bfloat162float(vc[(s0 + j) * row_stride + d]);
#pragma unroll
      for (int i = 0; i < kMaxG; ++i) {
        const int g = gs + i * ngs;
        if (g < G) acc[i] = fmaf(ps[g][j], vv, acc[i]);
      }
    }
    __syncthreads();
  }

  // the current token's term is rounded as decode_attention_xla rounds it:
  // bf16 cache product, bf16 probability times bf16 value, bf16 sum
  const float vcur = __bfloat162float(v_cur[head * HD + d]);
#pragma unroll
  for (int i = 0; i < kMaxG; ++i) {
    const int g = gs + i * ngs;
    if (g < G) {
      const float att = __bfloat162float(__float2bfloat16(acc[i]));
      const float pc = __bfloat162float(__float2bfloat16(p_cur[g]));
      const float cur = __bfloat162float(__float2bfloat16(pc * vcur));
      out[(head * G + g) * HD + d] = __float2bfloat16(att + cur);
    }
  }
}

}  // namespace

// Shapes as in the header note; every tensor contiguous, 16-byte aligned.
// Requires G <= 8, HD a divisor of 128 and a multiple of 8. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int miotts_decode_attention_bf16(const void* q, const void* k_cur,
                                            const void* v_cur, const void* cache_k,
                                            const void* cache_v, const void* pos, void* out,
                                            int B, int S, int KVH, int G, int HD, float scale,
                                            void* stream) {
  if (G > kMaxG || HD > kMaxHD || HD % 8 || kThreads % HD) return (int)cudaErrorInvalidValue;
  decode_attention_kernel<<<B * KVH, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
      (const __nv_bfloat16*)cache_k, (const __nv_bfloat16*)cache_v, (const int*)pos,
      (__nv_bfloat16*)out, S, KVH, G, HD, scale);
  return (int)cudaGetLastError();
}
