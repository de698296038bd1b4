// The LLM decode step's per-layer glue, fused into three kernels (bf16):
//
//   K7 add_rms_norm    x <- bf16(x + delta) in place, then
//                      bf16(xf * rsqrt(mean(xf^2) + eps) * weight)
//   K8 qkv_rope_cache  the fused QKV product's bias add, RoPE on q and k,
//                      q in K2's layout, this step's k/v, and their row of
//                      the KV cache at pos
//   K9 silu_mul        bf16(bf16(silu(gate)) * up) over the gate|up product
//
// Replaces: no Pallas kernel. On the TPU, XLA fused this glue into the
// matmuls around it (miotts_tpu/models/llm.py: rms_norm, apply_rope, the
// bias and residual adds, silu); in PyTorch each of those expressions is
// its own kernel node, ~54 a layer, ~650 of the ~830 kernels of a decode
// step inside a chunk graph.
//
// What bounds them on the H100: latency. A 0.1B decode step's rows are
// 768 (K7), 1 024 (K8) and 4 096 (K9) bf16 values a lane -- a few KB a
// launch, nanoseconds at 3.35 TB/s. The cost is the launch and the gap
// before the next kernel, so the design's aim is fewer launches: one
// kernel where PyTorch ran 9 (K7), ~36 (K8, with the end-of-step cache
// scatter) and 2 (K9), each a single pass over its row with no second
// kernel for a reduction.
//
// Arithmetic. Each kernel rounds where the plain PyTorch version
// (ops/cuda/llm_fused.py) rounds, with the *_rn intrinsics for every
// product and sum so that nvcc contracts nothing into an FMA:
// - K7: the residual sum in f32, rounded to bf16; squares and their sum in
//   f32 (each thread its 8 values in order, then a fixed xor-shuffle tree,
//   then the warps' sums in order: a row's result depends on its row
//   alone, never on B), times 1/D (ATen's mean), plus eps, rsqrtf (ATen's
//   rsqrt), then (xf * scale) * weight with the f32 weight, rounded once.
//   Only the order of the f32 sum differs from ATen's reduction.
// - K8: bias add in f32 rounded to bf16; the angle pos * inv_freq[i] as
//   one f32 product (inv_freq computed by torch.pow as rope_angles does);
//   precise cosf/sinf; x0 c - x1 s and x0 s + x1 c, each product and the
//   sum rounded to f32, then to bf16. NEOX pairs (i, i + HD/2) or adjacent
//   pairs (2i, 2i + 1).
// - K9: x / (1 + expf(-x)) in f32 (ATen's silu; IEEE division), rounded to
//   bf16, times up in f32, rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 r(float v) { return __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// K7: one block a row, one thread a 16-byte vector of 8 values
// ---------------------------------------------------------------------------

__global__ void add_rms_norm_kernel(bf16* __restrict__ x, const bf16* __restrict__ delta,
                                    long long delta_ld, const float* __restrict__ weight,
                                    bf16* __restrict__ out, int D, float eps) {
  const int row = blockIdx.x, t = threadIdx.x, nv = D / 8;
  __shared__ float warp_sum[32];
  float v[8];
  float ss = 0.f;
  if (t < nv) {
    uint4* xrow = reinterpret_cast<uint4*>(x + (long long)row * D);
    uint4 xr = xrow[t];
    bf16* xs = reinterpret_cast<bf16*>(&xr);
    if (delta != nullptr) {
      uint4 dr = reinterpret_cast<const uint4*>(delta + (long long)row * delta_ld)[t];
      const bf16* ds = reinterpret_cast<const bf16*>(&dr);
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[j] = r(__fadd_rn(f(xs[j]), f(ds[j])));
      xrow[t] = xr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = f(xs[j]);
      ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if ((t & 31) == 0) warp_sum[t >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total = __fadd_rn(total, warp_sum[w]);
  const float mean = __fmul_rn(total, __fdiv_rn(1.f, (float)D));
  const float scale = rsqrtf(__fadd_rn(mean, eps));
  if (t < nv) {
    const float4* w4 = reinterpret_cast<const float4*>(weight) + 2 * t;
    const float4 wa = w4[0], wb = w4[1];
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    uint4 o;
    bf16* os = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) os[j] = r(__fmul_rn(__fmul_rn(v[j], scale), wv[j]));
    reinterpret_cast<uint4*>(out + (long long)row * D)[t] = o;
  }
}

// ---------------------------------------------------------------------------
// K8: one block a lane, one thread a pair of values of one head
// ---------------------------------------------------------------------------

__global__ void qkv_rope_cache_kernel(const bf16* __restrict__ qkv, long long ld,
                                      const bf16* __restrict__ bias,
                                      const float* __restrict__ inv_freq,
                                      const int* __restrict__ pos, bf16* __restrict__ cache_k,
                                      bf16* __restrict__ cache_v, bf16* __restrict__ q_out,
                                      bf16* __restrict__ k_out, bf16* __restrict__ v_out, int H,
                                      int KVH, int HD, int S, int neox) {
  const int b = blockIdx.x, half = HD / 2;
  const int n_pairs = (H + 2 * KVH) * half;
  const int p = pos[b];
  const bool write_row = p >= 0 && p < S;
  const float fp = (float)p;
  const bf16* row = qkv + (long long)b * ld;
  const long long kv_width = (long long)KVH * HD;
  const long long cache_row = ((long long)b * S + (write_row ? p : 0)) * kv_width;
  for (int i = threadIdx.x; i < n_pairs; i += blockDim.x) {
    const int head = i / half, j = i - head * half;
    const bool rotate = head < H + KVH;
    const int c0 = head * HD + ((rotate && !neox) ? 2 * j : j);
    const int c1 = c0 + ((rotate && !neox) ? 1 : half);
    bf16 a0 = row[c0], a1 = row[c1];
    if (bias != nullptr) {
      a0 = r(__fadd_rn(f(a0), f(bias[c0])));
      a1 = r(__fadd_rn(f(a1), f(bias[c1])));
    }
    bf16 y0 = a0, y1 = a1;
    if (rotate) {
      const float ang = __fmul_rn(fp, inv_freq[j]);
      const float c = cosf(ang), s = sinf(ang);
      const float x0 = f(a0), x1 = f(a1);
      y0 = r(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
      y1 = r(__fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c)));
    }
    if (head < H) {
      bf16* q = q_out + (long long)b * H * HD;
      q[c0] = y0;
      q[c1] = y1;
    } else {
      const bool is_k = head < H + KVH;
      const int base = (is_k ? H : H + KVH) * HD;
      bf16* dst = (is_k ? k_out : v_out) + (long long)b * kv_width;
      dst[c0 - base] = y0;
      dst[c1 - base] = y1;
      if (write_row) {
        bf16* cache = (is_k ? cache_k : cache_v) + cache_row;
        cache[c0 - base] = y0;
        cache[c1 - base] = y1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9: one thread a 16-byte vector of 8 gate and 8 up values
// ---------------------------------------------------------------------------

__global__ void silu_mul_kernel(const bf16* __restrict__ gu, long long ld, bf16* __restrict__ out,
                                int rows, int F) {
  const int nv = F / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * nv) return;
  const int rw = (int)(idx / nv), c = (int)(idx - (long long)rw * nv);
  const bf16* g_row = gu + (long long)rw * ld;
  uint4 gr = reinterpret_cast<const uint4*>(g_row)[c];
  uint4 ur = reinterpret_cast<const uint4*>(g_row + F)[c];
  const bf16* gs = reinterpret_cast<const bf16*>(&gr);
  const bf16* us = reinterpret_cast<const bf16*>(&ur);
  uint4 o;
  bf16* os = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float xv = f(gs[j]);
    const float s = f(r(__fdiv_rn(xv, __fadd_rn(1.f, expf(-xv)))));
    os[j] = r(__fmul_rn(s, f(us[j])));
  }
  reinterpret_cast<uint4*>(out + (long long)rw * F)[c] = o;
}

constexpr int kSiluThreads = 256;

int round_warps(int n) { return (n + 31) / 32 * 32; }

}  // namespace

// x [rows, D] (updated in place when delta is given), delta [rows, *] with
// row stride delta_ld (may be null), weight [D] f32, out [rows, D]; every
// row 16-byte aligned. Requires D % 8 == 0 and D <= 8192.
extern "C" int miotts_add_rms_norm_bf16(void* x, const void* delta, long long delta_ld,
                                        const void* weight, void* out, int rows, int D, float eps,
                                        void* stream) {
  if (rows < 1 || rows > 65535 || D < 8 || D % 8 || D / 8 > 1024 ||
      (delta != nullptr && (delta_ld < D || delta_ld % 8)))
    return (int)cudaErrorInvalidValue;
  add_rms_norm_kernel<<<rows, round_warps(D / 8), 0, (cudaStream_t)stream>>>(
      (bf16*)x, (const bf16*)delta, delta_ld, (const float*)weight, (bf16*)out, D, eps);
  return (int)cudaGetLastError();
}

// qkv [B, *] with row stride ld (columns q | k | v, (H + 2 KVH) HD used),
// bias [(H + 2 KVH) HD] (may be null), inv_freq [HD / 2] f32, pos [B]
// int32, cache_k/cache_v [B, S, KVH, HD]; out q_out [B, H HD], k_out/v_out
// [B, KVH HD]. A lane whose pos is outside [0, S) writes no cache row.
extern "C" int miotts_qkv_rope_cache_bf16(const void* qkv, long long ld, const void* bias,
                                          const void* inv_freq, const void* pos, void* cache_k,
                                          void* cache_v, void* q_out, void* k_out, void* v_out,
                                          int B, int H, int KVH, int HD, int S, int neox,
                                          void* stream) {
  if (B < 1 || B > 65535 || H < 1 || KVH < 1 || HD < 2 || HD % 2 || S < 1 ||
      ld < (long long)(H + 2 * KVH) * HD)
    return (int)cudaErrorInvalidValue;
  const int n_pairs = (H + 2 * KVH) * (HD / 2);
  const int threads = n_pairs < 512 ? round_warps(n_pairs) : 512;
  qkv_rope_cache_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, ld, (const bf16*)bias, (const float*)inv_freq, (const int*)pos,
      (bf16*)cache_k, (bf16*)cache_v, (bf16*)q_out, (bf16*)k_out, (bf16*)v_out, H, KVH, HD, S,
      neox);
  return (int)cudaGetLastError();
}

// gu [rows, *] with row stride ld (gate at [0, F), up at [F, 2F)), out
// [rows, F]; rows 16-byte aligned. Requires F % 8 == 0 and ld % 8 == 0.
extern "C" int miotts_silu_mul_bf16(const void* gu, long long ld, void* out, int rows, int F,
                                    void* stream) {
  if (rows < 1 || F < 8 || F % 8 || ld < 2LL * F || ld % 8)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * (F / 8);
  const long long blocks = (n + kSiluThreads - 1) / kSiluThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  silu_mul_kernel<<<(unsigned)blocks, kSiluThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)gu, ld, (bf16*)out, rows, F);
  return (int)cudaGetLastError();
}
