// Kernel K1: banded (window-65) attention for the codec transformers, f32,
// in the trunk's own [B, T, H, D] layout.
//
// Replaces: miotts_tpu/ops/pallas/banded_attention.py::banded_attention_pallas
// (Pallas TPU kernel, body `kernel`, pallas_call at :108).
//
// Computes, for q/k/v [B, T, H, D] f32 and lengths [B] int32:
//   out[b, q, h] = softmax_k( q.k / sqrt(D) ) . v  over keys admitted by
//   (|k - q| <= half && 0 <= k < length) || k == q      (half = window / 2)
// with f32 scores, softmax and output, written to [B, T, H, D] (so the
// trunk's reshape to [B, T, H D] is free). The diagonal term keeps padded
// query rows (q >= length) finite; they are computed like any other row.
//
// What bounds it on the H100: bytes, barely. At B=1 H=8 T=1024 D=64 it
// reads q/k/v and writes out once, 8.4 MB (2.5 us at 3.35 TB/s), and does
// 136 MFLOP of admitted score and value FMAs (2.0 us at 67 TFLOP/s f32).
// At a 40-code request's T = 64 and 128 there is a few hundred KB of work:
// launch and one block's latency set the time.
//
// Design: one block per (example, head, tile of 16 or 32 query rows), the
// tile picked by ops/cuda/banded_attention.py launch_shape so that the
// grid fills the card where the work allows (>= 132 blocks), else one block
// per (head, 16 rows). The tile's Q rows and its K/V rows [q0 - half,
// q0 + tile + half) that lie in [0, T) are staged in shared memory with
// cp.async (a row stride of D + 4 floats: 16-byte aligned, conflict-free
// float4 reads). Each warp owns 4 query rows:
// - scores: lane j holds keys j, j + 32, j + 64 of the warp's 68-key span
//   for all 4 rows, a 4 x 3 register tile fed by float4 loads (the 4 q
//   rows broadcast, 3 k rows a lane), 12 independent f32 sums;
// - softmax: row max and row sum by warp shuffles, 4 rows interleaved;
// - values: the normalized probabilities go to a per-warp buffer [key][row]
//   and each lane accumulates 2 output columns for the 4 rows (8 sums),
//   one float2 of V and one float4 of probabilities a key.
// Short warps, many of them: with at most ~2 warps a scheduler at these
// shapes, each warp's chain of dependent loads, shuffles and FMAs is what
// the time is (8-row warps measured slower at every request shape).
// D = 64 (both codec stacks: 768/12 prenet, 512/8 decoder) is a compile-time
// instance; any other width runs the run-time instance (scalar staging,
// zero-padded to a multiple of 4, columns in passes of 64). A window whose
// span needs more than 8 key slots a lane, or a width that does not fit
// shared memory, is refused.
//
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (scripts/
// bench_torch_k1_k5.py): 11.6 us at a 400-code request's prenet (H=12
// T=512) and 12.2 us at its decoder (H=8 T=1024), 6.0 and 6.2 us at a
// 40-code request's T = 64 and 128 (the earlier one-warp-a-row design:
// 34.7-40.2 us; SDPA with the band mask 17-134 us). clock64 stamps
// (scripts/stamp_torch_k1.py) put a decoder warp at ~19 k cycles: staging
// 6.2 k (each 32-row tile reads 224 rows, 14.7 MB of L2 traffic in all for
// 8.4 MB of data), scores 5.4 k, softmax 3.3 k, values 4.3 k, with ~4 warps
// a scheduler: chains of dependent loads, shuffles and FMAs, not the card's
// rates, set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "smem_limit.cuh"

namespace {

using namespace miotts_async;

constexpr int kRows = 4;         // query rows a warp
constexpr int kMaxThreads = 256;  // a block: 4 warps (16-row tile) or 8 (32-row tile)
constexpr int kMaxSmem = 227 * 1024;

// Phase stamps (compiled only with -DMIOTTS_STAMPS, by
// scripts/stamp_torch_k1.py): lane 0 of each warp adds the cycles since its
// last stamp to g_stamps[phase]: 0 the copies issued (from the kernel's
// start), 1 their wait and the block barrier, 2 scores, 3 softmax, 4 values
// and stores.
#ifdef MIOTTS_STAMPS
__device__ unsigned long long g_stamps[5];
#define STAMP(i)                                                                  \
  do {                                                                            \
    const long long now_ = clock64();                                             \
    if ((threadIdx.x & 31) == 0)                                                  \
      atomicAdd(&g_stamps[i], (unsigned long long)(now_ - last_));                \
    last_ = now_;                                                                 \
  } while (0)
#else
#define STAMP(i) ((void)0)
#endif

__host__ __device__ inline int padded_width(int D) { return ((D + 3) & ~3) + 4; }

// floats of shared memory for a tile of `tile` rows
__host__ __device__ inline int smem_floats(int tile, int D, int half) {
  return (tile + 2 * (tile + 2 * half)) * padded_width(D) + tile * (kRows + 2 * half);
}

// D > 0: that width at compile time; D = 0: the width d_rt at run time.
// NS: the most 32-key slots a lane holds; ns (<= NS) the slots this window
// needs, ceil((kRows + 2 half) / 32).
template <int D, int NS>
__global__ void __launch_bounds__(kMaxThreads)
banded_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, int T, int H, int d_rt, int half, int ns,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
#ifdef MIOTTS_STAMPS
  long long last_ = clock64();
#endif
  const int h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), T);
  const int Dn = D > 0 ? D : d_rt;
  const int Dr = (Dn + 3) & ~3;       // staged width, zero-padded
  const int DP = padded_width(Dn);    // row stride
  const int tile = (blockDim.x >> 5) * kRows;
  const int span = kRows + 2 * half;      // keys a warp's rows reach
  const int rows_kv = tile + 2 * half;
  float* qs = smem;                   // [tile][DP]
  float* ks = qs + tile * DP;         // [rows_kv][DP]
  float* vs = ks + rows_kv * DP;      // [rows_kv][DP]
  float* ps = vs + rows_kv * DP;      // per warp [span][kRows]

  const int q0 = blockIdx.x * tile, k0 = q0 - half;
  const int64_t rs = (int64_t)H * Dn;  // stride of t
  const int64_t base = (int64_t)b * T * rs + (int64_t)h * Dn;

  // stage the tile's Q rows and its K/V rows [k0, k0 + rows_kv) that lie
  // in [0, T); the rest stay unset: their scores are masked and the value
  // pass skips them
  const int qhi = min(tile, T - q0);
  const int klo = max(0, -k0), khi = min(rows_kv, T - k0);
  if constexpr (D > 0) {
    static_assert(D % 4 == 0 && ((D / 4) & (D / 4 - 1)) == 0, "a compile-time width is 4 x 2^n");
    constexpr int C4 = D / 4;
    const int c = (threadIdx.x % C4) * 4, rstep = blockDim.x / C4;
    const float* qb = q + base + c;
    for (int r = threadIdx.x / C4; r < qhi; r += rstep)
      cp_async16(qs + r * DP + c, qb + (q0 + r) * rs, 16);
    const float* kb = k + base + c;
    const float* vb = v + base + c;
    for (int r = klo + threadIdx.x / C4; r < khi; r += rstep) {
      const int64_t off = (k0 + r) * rs;
      cp_async16(ks + r * DP + c, kb + off, 16);
      cp_async16(vs + r * DP + c, vb + off, 16);
    }
    cp_async_commit();
    STAMP(0);
    cp_async_wait<0>();
  } else {  // zero the padded columns of every staged row
    for (int i = threadIdx.x; i < qhi * Dr; i += blockDim.x) {
      const int r = i / Dr, c = i - r * Dr;
      qs[r * DP + c] = c < Dn ? q[base + (q0 + r) * rs + c] : 0.f;
    }
    for (int i = klo * Dr + threadIdx.x; i < khi * Dr; i += blockDim.x) {
      const int r = i / Dr, c = i - r * Dr;
      const int64_t off = base + (k0 + r) * rs + c;
      ks[r * DP + c] = c < Dn ? k[off] : 0.f;
      vs[r * DP + c] = c < Dn ? v[off] : 0.f;
    }
    STAMP(0);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;   // the warp's first row in the tile
  if (r0 >= qhi) return;     // no block barrier follows
  STAMP(1);

  // scores: acc[r][s] = q[r0 + r] . k[slot s * 32 + lane of the warp's span]
  float acc[kRows][NS];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[r][s] = 0.f;
  const float* krow[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)  // slots past the staged rows read the last one, masked below
    krow[s] = ks + min(r0 + s * 32 + lane, rows_kv - 1) * DP;
  const float* qw = qs + r0 * DP;
#pragma unroll 4
  for (int c = 0; c < Dr; c += 4) {
    float4 kv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s < ns) kv[s] = *reinterpret_cast<const float4*>(krow[s] + c);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qw + r * DP + c);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s >= ns) continue;
        acc[r][s] = fmaf(qv.x, kv[s].x, acc[r][s]);
        acc[r][s] = fmaf(qv.y, kv[s].y, acc[r][s]);
        acc[r][s] = fmaf(qv.z, kv[s].z, acc[r][s]);
        acc[r][s] = fmaf(qv.w, kv[s].w, acc[r][s]);
      }
    }
  }
  STAMP(2);

  // mask (unset rows included), then softmax along each row over the
  // warp's lanes, the rows' shuffle reductions interleaved
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    m[r] = -INFINITY;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int kp = k0 + r0 + s * 32 + lane;
      const bool allow = s < ns && (kp == qi || (abs(kp - qi) <= half && kp >= 0 && kp < len));
      acc[r][s] = allow ? acc[r][s] * scale : -INFINITY;
      m[r] = fmaxf(m[r], acc[r][s]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
  for (int r = 0; r < kRows; ++r) {  // m[r] is finite: the diagonal is always admitted
    l[r] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      acc[r][s] = expf(acc[r][s] - m[r]);  // exp(-inf) = 0 for masked keys
      l[r] += acc[r][s];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  float inv_l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) inv_l[r] = 1.f / l[r];
  float* pw = ps + warp * span * kRows;  // [span][kRows]
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int j = s * 32 + lane;
    if (s < ns && j < span) {
#pragma unroll
      for (int r4 = 0; r4 < kRows; r4 += 4)
        *reinterpret_cast<float4*>(pw + j * kRows + r4) =
            make_float4(acc[r4][s] * inv_l[r4], acc[r4 + 1][s] * inv_l[r4 + 1],
                        acc[r4 + 2][s] * inv_l[r4 + 2], acc[r4 + 3][s] * inv_l[r4 + 3]);
    }
  }
  __syncwarp();
  STAMP(3);

  // values over the staged keys of the span: lane holds columns d, d + 1
  // of the kRows rows, in passes of 64
  const int jlo = max(0, klo - r0), jhi = min(span, khi - r0);
  for (int c0 = 0; c0 < Dr; c0 += 64) {
    const int d = c0 + 2 * lane;
    if (d >= Dr) break;
    float o[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r][0] = o[r][1] = 0.f;
    const float* vp = vs + r0 * DP + d;
#pragma unroll 4
    for (int j = jlo; j < jhi; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(vp + j * DP);
#pragma unroll
      for (int r4 = 0; r4 < kRows; r4 += 4) {
        const float4 p = *reinterpret_cast<const float4*>(pw + j * kRows + r4);
        o[r4][0] = fmaf(p.x, vv.x, o[r4][0]);
        o[r4][1] = fmaf(p.x, vv.y, o[r4][1]);
        o[r4 + 1][0] = fmaf(p.y, vv.x, o[r4 + 1][0]);
        o[r4 + 1][1] = fmaf(p.y, vv.y, o[r4 + 1][1]);
        o[r4 + 2][0] = fmaf(p.z, vv.x, o[r4 + 2][0]);
        o[r4 + 2][1] = fmaf(p.z, vv.y, o[r4 + 2][1]);
        o[r4 + 3][0] = fmaf(p.w, vv.x, o[r4 + 3][0]);
        o[r4 + 3][1] = fmaf(p.w, vv.y, o[r4 + 3][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= qhi) break;
      float* dst = out + base + (q0 + r0 + r) * rs + d;
      if constexpr (D > 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[r][0], o[r][1]);
      } else {
        if (d < Dn) dst[0] = o[r][0];
        if (d + 1 < Dn) dst[1] = o[r][1];
      }
    }
  }
  STAMP(4);
}

template <int D, int NS>
cudaError_t launch(const float* q, const float* k, const float* v, const int* lengths, float* out,
                   int B, int T, int H, int Dn, int half, int ns, int warps, float scale,
                   size_t smem, cudaStream_t stream) {
  auto kern = banded_attention_kernel<D, NS>;
  static size_t allowed[miotts_smem::kMaxDevices] = {};  // raised for each larger size seen
  const cudaError_t e = miotts_smem::raise_limit(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + warps * kRows - 1) / (warps * kRows), H, B);
  kern<<<grid, warps * 32, smem, stream>>>(q, k, v, lengths, out, T, H, Dn, half, ns, scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/out: [B, T, H, D] f32 contiguous; lengths: [B] int32. `warps` (4
// or 8: 16- or 32-row query tiles) is the plan of
// ops/cuda/banded_attention.py launch_shape. Launches on `stream` and
// returns cudaGetLastError() (0 on success); a window wider than 8 key
// slots a lane or a width that does not fit the 227 KB of shared memory a
// block may have fails here.
extern "C" int miotts_banded_attention_f32(const void* q, const void* k, const void* v,
                                           const void* lengths, void* out, int B, int T, int H,
                                           int D, int half, int warps, float scale,
                                           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1 || D < 1 || half < 0 || warps < 1 ||
      warps * 32 > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int ns = (kRows + 2 * half + 31) / 32;
  const size_t smem = sizeof(float) * (size_t)smem_floats(warps * kRows, D, half);
  if (ns > 8 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  const auto* qf = (const float*)q;
  const auto* kf = (const float*)k;
  const auto* vf = (const float*)v;
  const auto* lf = (const int*)lengths;
  const auto st = (cudaStream_t)stream;
  // the D = 64 instance takes windows of up to 3 key slots a lane
  const cudaError_t e =
      D == 64 && ns <= 3 && aligned
          ? launch<64, 3>(qf, kf, vf, lf, (float*)out, B, T, H, D, half, ns, warps, scale, smem, st)
          : launch<0, 8>(qf, kf, vf, lf, (float*)out, B, T, H, D, half, ns, warps, scale, smem, st);
  return (int)e;
}

#ifdef MIOTTS_STAMPS
// copies the phase sums (cycles) to `host` and zeroes them
extern "C" int miotts_banded_attention_stamps(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}
#endif
