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
//   bf16 after normalization by the global sum and go into the value
//   product with f32 sums; the output [B, KVH*G*HD] is bf16, with the
//   current token's term rounded as decode_attention_xla rounds it.
//   A lane with pos = 0 attends to its current token alone; pos > S reads
//   the whole cache.
//
// What bounds it on the H100: latency. At the 0.1B shape (B 1, KVH 2, G 6,
// HD 64, S 700, pos 699) the call moves ~0.36 MB -- 0.1 us at 3.35 TB/s --
// and does 4 * pos * KVH * G * HD operations, nothing for the tensor
// cores. What costs is the chain of dependent steps a block walks: global
// loads, shared-memory round trips, reductions, barriers.
//
// Design: the cache is split over S across a thread-block cluster of
// kSplit = 8 blocks (the portable cluster size), one cluster per (lane, kv
// head): grid (8, B*KVH). Block `rank` takes rows [rank*R, (rank+1)*R)
// clipped to [0, pos), with R = ceil(S/8) passed by the wrapper, so the
// grid depends on S, B and KVH only and nothing is read from pos on the
// host (the launch can go into a CUDA graph). Each block requests its K
// and V rows, Q and the current token at once with cp.async (16 bytes a
// thread, coalesced rows); V's copy overlaps the score pass.
//
// Each warp takes 32 rows of a 128-row tile. Its scores run on the tensor
// cores with mma.sync.m16n8k16 bf16 -> f32 (Q padded from G to 16 rows;
// bf16 operands, exact products, f32 sums: the reference's rounding) and
// stay in registers, where each thread keeps a running (max, sum); the 4
// lanes that hold a head merge theirs into the warp's pair. Each block
// stores its 32 pairs into every block's shared memory (distributed shared
// memory) and arrives on that block's mbarrier; once a block's barrier has
// seen all 8, it folds the 32 pairs of a head and the current token's
// score into the global max and sum. The bf16 probabilities go from the
// score fragments straight into the A fragments of the value product (V's
// B fragments by ldmatrix.trans), so neither scores nor probabilities
// touch shared memory; a range longer than one tile recomputes its scores
// in this pass. A block sums its 4 warps' f32 partials in order. Block r
// owns the r-th eighth of the G x HD outputs: every block stores its
// partial of that eighth into block r's shared memory (float4 stores,
// each followed by an arrival on block r's second mbarrier), and block r
// sums the 8 partials in rank order (bit-stable from run to run) and adds
// the current token's term. Blocks with an empty range still publish
// (max -inf, sum 0, partial 0). Data only ever moves into a block that is
// waiting for it, so a block may leave once its own barriers are complete;
// one cluster barrier at the start orders the barriers' initialization
// before any remote arrival; the exchanges need no cluster-wide barrier,
// each of which costs a round trip through every block. A warp-per-row
// SIMT form
// would walk the same rows with a chain of shuffles per row; the tensor
// cores take a 16x8x16 product per instruction; wgmma needs 64-row tiles
// and does not fit G <= 8.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 7.4 us a
// call at B 1, S 700 whatever pos (SDPA over the cache prefix: 5.1 us at
// pos 128, 8.1 us at pos 699).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace miotts_async;

constexpr int kSplit = 8;    // blocks of a cluster, each one range of rows
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;     // query heads a kv head (rows of the padded Q)
constexpr int kTile = 128;   // cache rows staged at a time
constexpr int kPad = 8;      // bf16 row padding: conflict-free fragment loads

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarriers in shared memory, each used for one phase (parity 0)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)), "r"(count) : "memory");
}
// one arrival, releasing this thread's earlier writes at cluster scope, on
// the barrier at `bar`'s place in the shared memory of block `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a)
        : "memory");
}

// c += a (16x16, row-major; rows 8-15 zero) * b (16x8, col-major), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// rows [r0, r0 + n) of one head of the cache -> dst [kTile][HD + kPad],
// rows n..kTile-1 zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t row_stride, int r0, int n) {
  constexpr int chunks = HD / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool ok = r < n;
    cp_async16(dst + r * (HD + kPad) + c, src + (ok ? (int64_t)(r0 + r) * row_stride + c : 0),
               ok ? 16 : 0);
  }
}

// the four B fragments (k16 x n8) of rows [k0, k0 + 16) x columns [n0, n0 +
// 16) of a row-major [k][n] bf16 tile whose row k0 + (lane & 15) starts at
// `row`: (b0, b1) for columns n0..n0+7, (b2, b3) for n0+8..n0+15
__device__ __forceinline__ void ldmatrix_b_trans_x4(uint32_t (&b)[4], const __nv_bfloat16* row,
                                                    int lane) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// reductions over groups of W consecutive lanes
template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (m, l) <- the (max, sum of exp(x - max)) of the union of two sets
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;
  l = (m > -INFINITY ? l * expf(m - M) : 0.f) + (m2 > -INFINITY ? l2 * expf(m2 - M) : 0.f);
  m = M;
}

// a warp's scaled scores of tile rows [warp*32, warp*32 + 32): c[j] is the
// n8 block of rows warp*32 + 8j .. +7 (thread: query head gq, rows + cq, +1)
template <int HD>
__device__ __forceinline__ void warp_scores(float (&c)[4][4], const uint32_t (&qa)[HD / 16][2],
                                            const __nv_bfloat16* ks, int warp, int lane, int nt,
                                            float scale) {
  constexpr int HP = HD + kPad;
  const int gq = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const int n0 = warp * 32 + j * 8;
    if (n0 < nt) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* kb = ks + (n0 + gq) * HP + kk * 16 + cq;
        mma_bf16(c[j], qa[kk][0], qa[kk][1], ld32(kb), ld32(kb + 8));
      }
    }
    c[j][0] *= scale;
    c[j][1] *= scale;
  }
}

template <int HD>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_cur,
                        const __nv_bfloat16* __restrict__ v_cur,
                        const __nv_bfloat16* __restrict__ cache_k,
                        const __nv_bfloat16* __restrict__ cache_v,
                        const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int S,
                        int KVH, int G, int R, float scale) {
  constexpr int HP = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kMaxG][HP]
  __nv_bfloat16* ks = qs + kMaxG * HP;                          // [kTile][HP]
  __nv_bfloat16* vs = ks + kTile * HP;                          // [kTile][HP]
  float* recv = reinterpret_cast<float*>(vs + kTile * HP);      // [kSplit][G*HD/8]
  __shared__ __align__(16) __nv_bfloat16 kcs[HD], vcs[HD];      // the current token
  __shared__ __align__(16) float2 wstat[kMaxG][kWarps];         // this block's warps' (max, sum)
  __shared__ __align__(16) float2 stats[kSplit][kMaxG][kWarps];  // every block's, by rank
  __shared__ float m_fin[kMaxG], l_fin[kMaxG], p_cur[kMaxG];
  __shared__ uint64_t bars[2];  // every block's stats arrived; every partial arrived

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;  // b * KVH + n
  const int b = head / KVH, n = head - b * KVH;
  const int P = min(max(pos[b], 0), S);  // used only after the loads below are requested
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, cq = (lane & 3) * 2;  // fragment row and column pair
  const int lo = rank * R;
  const int64_t row_stride = (int64_t)KVH * HD;
  const __nv_bfloat16* kc = cache_k + (int64_t)b * S * row_stride + (int64_t)n * HD;
  const __nv_bfloat16* vc = cache_v + (int64_t)b * S * row_stride + (int64_t)n * HD;
  const int slice = G * HD / kSplit;  // outputs a block sums

  // the barriers that other blocks arrive on; initialized before any
  // block passes the cluster barrier that precedes its first remote access
  if (t == 0) {
    mbar_init(&bars[0], kSplit * 16);         // 16 stores from each block
    mbar_init(&bars[1], kSplit * (slice / 4));  // slice / 4 float4 stores from each
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();

  // Everything that does not depend on pos is requested at once, with
  // cp.async: K, Q and the current token's k/v, then V (in the
  // background) of the range's first tile; rows at or past pos are loaded
  // but weigh 0.
  const int first = min(max(0, min(R, S - lo)), kTile);
  stage_rows<HD>(ks, kc, row_stride, lo, first);
  for (int i = t; i < G * HD / 8; i += kThreads) {
    const int g = i / (HD / 8), d = (i % (HD / 8)) * 8;
    cp_async16(qs + g * HP + d, q + ((int64_t)head * G + g) * HD + d, 16);
  }
  if (t < HD / 8) {
    cp_async16(kcs + 8 * t, k_cur + (int64_t)head * HD + 8 * t, 16);
    cp_async16(vcs + 8 * t, v_cur + (int64_t)head * HD + 8 * t, 16);
  }
  cp_async_commit();
  stage_rows<HD>(vs, vc, row_stride, lo, first);
  cp_async_commit();
  for (int i = G * HP + t; i < kMaxG * HP; i += kThreads) qs[i] = __float2bfloat16(0.f);
  const int nrows = max(0, min(lo + R, P) - lo);  // this block's rows
  const int ntiles = (nrows + kTile - 1) / kTile;

  // pass 1: scores on the tensor cores, each thread's (max, sum) over the
  // values it holds, merged tile by tile
  uint32_t qa[HD / 16][2];  // Q as the A fragments of every k16 step
  float c[4][4];
  float m = -INFINITY, l = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int r0 = tile * kTile, nt = min(kTile, nrows - r0);
    if (tile > 0) {
      __syncthreads();
      stage_rows<HD>(ks, kc, row_stride, lo + r0, nt);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = ld32(qs + gq * HP + kk * 16 + cq);
        qa[kk][1] = ld32(qs + gq * HP + kk * 16 + 8 + cq);
      }
    }
    warp_scores<HD>(c, qa, ks, warp, lane, nt, scale);
    if (gq < G) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (warp * 32 + j * 8 + cq + e < nt) mt = fmaxf(mt, c[j][e]);
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (warp * 32 + j * 8 + cq + e < nt) lt += expf(c[j][e] - mt);
      merge(m, l, mt, lt);
    }
  }
  cp_async_wait<1>();  // Q and the current token, when the range is empty
  __syncthreads();
  // each warp's (max, sum) per head, from the 4 lanes that hold the head
  {
    float mw = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 2));
    const float lw = group_sum<4>(m > -INFINITY ? l * expf(m - mw) : 0.f);
    if ((lane & 3) == 0) wstat[gq][warp] = make_float2(mw, lw);
  }
  __syncthreads();
  cluster_wait();  // every block's barriers are initialized
  {  // this block's 32 pairs into slot `rank` of every block: 16 threads a block
    const int dst = t >> 4, i = t & 15;
    reinterpret_cast<float4*>(cluster.map_shared_rank(&stats[rank][0][0], dst))[i] =
        reinterpret_cast<const float4*>(&wstat[0][0])[i];
    mbar_arrive_remote(&bars[0], dst);
  }
  // head g = t / 16: the current token's score while the pairs arrive, then
  // the global max and sum over the 32 pairs of the cluster (a thread takes
  // two), the terms summed by a fixed butterfly, then the current token's
  {
    const int g = t >> 4, i = t & 15;
    float s = 0.f;
#pragma unroll
    for (int d = i; d < HD; d += 16)
      s = fmaf(__bfloat162float(qs[g * HP + d]), __bfloat162float(kcs[d]), s);
    s = group_sum<16>(s) * scale;
    mbar_wait(&bars[0]);
    const float4 v = *reinterpret_cast<const float4*>(&stats[i >> 1][g][2 * (i & 1)]);
    const float M = fmaxf(group_max<16>(fmaxf(v.x, v.z)), s);
    const float term = (v.x > -INFINITY ? v.y * expf(v.x - M) : 0.f) +
                       (v.z > -INFINITY ? v.w * expf(v.z - M) : 0.f);
    const float L = group_sum<16>(term) + expf(s - M);
    if (i == 0 && g < G) {
      m_fin[g] = M;
      l_fin[g] = L;
      p_cur[g] = expf(s - M) / L;
    }
  }
  __syncthreads();

  // pass 2: bf16 probabilities, straight from the score fragments into the
  // A fragments of the value product (the C fragments of two n8 blocks are
  // the A fragment of one k16 step), times V on the tensor cores
  const float Mg = m_fin[gq & (kMaxG - 1)], Lg = l_fin[gq & (kMaxG - 1)];
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int r0 = tile * kTile, nt = min(kTile, nrows - r0);
    if (ntiles > 1) {  // the registers hold the last tile's scores: restage and recompute
      __syncthreads();
      stage_rows<HD>(ks, kc, row_stride, lo + r0, nt);
      stage_rows<HD>(vs, vc, row_stride, lo + r0, nt);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      warp_scores<HD>(c, qa, ks, warp, lane, nt, scale);
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k16 steps: rows warp*32 + 16h .. +15
      const int k0 = warp * 32 + 16 * h;
      if (k0 >= nt) break;
      float p[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[jj][e] = (gq < G && k0 + 8 * jj + cq + e < nt)
                         ? expf(c[2 * h + jj][e] - Mg) / Lg : 0.f;
      const uint32_t a0 = pack_bf16(p[0][0], p[0][1]), a2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t bv[4];
        ldmatrix_b_trans_x4(bv, vs + (k0 + (lane & 15)) * HP + nn * 16, lane);
        mma_bf16(acc[2 * nn], a0, a2, bv[0], bv[1]);
        mma_bf16(acc[2 * nn + 1], a0, a2, bv[2], bv[3]);
      }
    }
  }

  // the block's partial: the 4 warps' summed in order (in the K tile's
  // space), then each float4 of outputs e = g * HD + d .. + 3 stored into
  // slot `rank` of block e / slice, which owns it
  float* red = reinterpret_cast<float*>(ks);  // [kWarps][kMaxG * HD]
  __syncthreads();
  if (gq < G) {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(red + warp * kMaxG * HD + gq * HD + i * 8 + cq) =
          make_float2(acc[i][0], acc[i][1]);
  }
  __syncthreads();
  for (int e = 4 * t; e < G * HD; e += 4 * kThreads) {
    float4 v = *reinterpret_cast<const float4*>(red + e);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(red + w * kMaxG * HD + e);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, e / slice) + rank * slice +
                               e % slice) = v;
    mbar_arrive_remote(&bars[1], e / slice);
  }
  // once every partial has arrived no block touches this block's shared
  // memory again, so it may leave after its sums
  cp_async_wait<0>();
  mbar_wait(&bars[1]);

  // this block's outputs: the 8 partials in rank order, then the
  // current token's term, rounded as decode_attention_xla rounds it: bf16
  // cache product, bf16 probability times bf16 value, bf16 sum
  for (int i = t; i < slice; i += kThreads) {
    const int e = rank * slice + i, g = e / HD, d = e % HD;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) s += recv[r * slice + i];
    const float att = __bfloat162float(__float2bfloat16(s));
    const float pc = __bfloat162float(__float2bfloat16(p_cur[g]));
    const float cur = __bfloat162float(__float2bfloat16(pc * __bfloat162float(vcs[d])));
    out[(int64_t)head * G * HD + e] = __float2bfloat16(att + cur);
  }
}

size_t smem_bytes(int HD) {
  const size_t HP = HD + kPad;
  return 2 * (kMaxG * HP + 2 * kTile * HP) + 4 * (size_t)kMaxG * HD;
}

template <int HD>
int launch(const void* q, const void* k_cur, const void* v_cur, const void* cache_k,
           const void* cache_v, const void* pos, void* out, int B, int S, int KVH, int G, int R,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  static bool raised = false;  // the dynamic limit, set once
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  decode_attention_kernel<HD><<<dim3(kSplit, B * KVH), kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
      (const __nv_bfloat16*)cache_k, (const __nv_bfloat16*)cache_v, (const int*)pos,
      (__nv_bfloat16*)out, S, KVH, G, R, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes as in the header note; every tensor contiguous, 16-byte aligned.
// Grid (8, B*KVH) in clusters of 8; R = rows a block, with 8 R >= S.
// Requires G <= 8 and HD in {32, 64, 128}. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int miotts_decode_attention_bf16(const void* q, const void* k_cur,
                                            const void* v_cur, const void* cache_k,
                                            const void* cache_v, const void* pos, void* out,
                                            int B, int S, int KVH, int G, int HD, int R,
                                            float scale, void* stream) {
  if (G < 1 || G > kMaxG || R < 1 || (int64_t)R * kSplit < S || B * KVH < 1 ||
      B * KVH > 65535)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch<32>(q, k_cur, v_cur, cache_k, cache_v, pos, out, B, S, KVH, G, R, scale, st);
    case 64: return launch<64>(q, k_cur, v_cur, cache_k, cache_v, pos, out, B, S, KVH, G, R, scale, st);
    case 128: return launch<128>(q, k_cur, v_cur, cache_k, cache_v, pos, out, B, S, KVH, G, R, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
