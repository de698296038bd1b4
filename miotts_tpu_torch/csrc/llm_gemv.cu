// K11: the LLM decode step's bf16 GEMVs with the glue on either side of
// each folded in (bf16 weights, B <= 8 lanes, one card):
//
//   norm_qkv       RMSNorm(x) @ wqkv [D, (H + 2 KVH) HD], then K8's epilogue:
//                  the bias add, RoPE on q and k, q in K2's layout, this
//                  step's k/v and their row of the KV cache at pos
//                  (replaces K7 -> cuBLAS GEMV -> K8)
//   gemv_residual  x <- bf16(x + bf16(act @ w)) in place, K7's residual add
//                  (the attention-out and down projections; replaces a
//                  cuBLAS GEMV and the add of the K7 after it)
//   norm_gateup    RMSNorm(x) @ w_gateup [D, 2F], then K9's
//                  bf16(bf16(silu(gate)) * up) (replaces K7's norm ->
//                  cuBLAS GEMV -> K9)
//   norm_head      RMSNorm(x) @ head^T, head [V, D] (or the tied
//                  embedding), accumulated straight into f32 logits [B, V]
//                  (replaces the last K7 and cuBLAS gemv2T / gemmSN)
//
// Replaces: no Pallas kernel. On the TPU, XLA fused these matmuls with the
// glue around them (miotts_tpu/models/llm.py: rms_norm, _mm, apply_rope, the
// bias and residual adds, silu, the logits head). On the H100 each of the
// port's cuBLAS calls and glue kernels sat at a latency floor (a cuBLAS
// GEMV 4.2-5.9 us, a glue kernel ~2.8 us) against byte bounds of 0.35-1.88
// us, and the head at width > 1 at 2.2x its byte bound.
//
// What bounds them: bytes. A 0.1B step's layer reads wqkv 1.57 MB (0.47 us
// at 3.35 TB/s), wo 1.18 MB (0.35 us), w_gateup 6.29 MB (1.88 us) and w_down
// 3.15 MB (0.94 us); the head 233 MB (69.6 us at V 151 759). The design:
//
// - The product on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate), the B <= 8 lanes as the mma's N = 8 (rows b >= B are zeros).
//   Products of bf16 values are exact in f32, so only the order of the f32
//   sum differs from cuBLAS's.
// - Weights keep their stored layout and bytes; every load is 16 bytes a
//   thread, coalesced. A layer leaf [K, N] (in, out): lane (g, t) of a warp
//   loads rows k + 4t .. k + 4t + 3 at columns 8g .. 8g + 7 of the tile, and
//   the A fragments are those words interleaved with byte permutes (the
//   mma's M is the output column; which physical k sits in which fragment
//   slot is a permutation the x fragment repeats). The head [V, D] (out,
//   in): lane (g, t) loads 8 consecutive d of rows g and g + 8, which are
//   the A fragments as they are.
// - The layer GEMVs read 1.2-6.3 MB each, so a launch has to keep the whole
//   leaf's loads in flight at once: every warp of a CTA's 8 issues all its
//   loads (at most 2 k-steps of 16 rows, 8 registers of 16 bytes) before
//   anything else.
//   Output tiles are 64 columns: wqkv 16 tiles (one head each, so RoPE's
//   pairs stay in one tile), wo and w_down 12, w_gateup 64 (32 gate columns
//   j and the 32 up columns F + j, so silu(gate) * up stays in one tile).
//   K is split over a thread-block cluster (split-K) of 8 CTAs (wqkv, wo,
//   w_down: 128, 96 and 96 CTAs) or 4 (w_gateup: 256 CTAs); each CTA sums
//   its 8 warps' fragments in shared memory and writes them into rank 0's
//   (distributed shared memory), behind one split cluster barrier; rank 0
//   sums the ranks in order and runs the epilogue, the other CTAs leave at
//   once. One launch, no atomics.
// - Each launch is a programmatic dependent launch: the weights do not
//   depend on the previous kernel, so a kernel issues their loads, lets the
//   next kernel launch, and only then waits for the previous kernel's
//   results (griddepcontrol). Every global write and
//   every read of a previous kernel's output comes after that wait.
// - The norm prologue: every CTA recomputes its rows' RMS scale from the
//   whole row (768 values a lane, read once from L2 into shared memory) and
//   normalizes the k rows it needs; the norm weight's columns are staged
//   in shared memory before the wait.
// - The head: 8 warps a CTA, a tile of 16 rows a warp, 1 186 CTAs at V
//   151 759, two CTAs an SM; a warp streams its tile's 24 k-steps in
//   groups of 6 (12 loads of 16 bytes a thread in flight) while the other
//   warps of the SM keep theirs in flight. One design for B = 1-8, since
//   the mma's N is 8 whatever B is.
//
// Arithmetic, with the *_rn intrinsics for every product and sum outside
// the mma, so that nvcc contracts nothing into an FMA:
// - The norm prologue is K7's, operation for operation (each thread its 8
//   values in order, the xor-shuffle tree, the warps' sums in order, times
//   1/D, plus eps, rsqrtf, (x * scale) * weight rounded once to bf16), so
//   the normed row equals K7's bit for bit.
// - The product's f32 sum: the tensor cores' within a k-step of 16 (32 for
//   the head), the k-steps in order within a warp, the warps in order, then
//   the cluster's ranks in order: deterministic, and a lane's result does
//   not depend on the other lanes.
// - norm_qkv rounds the product to bf16 (cuBLAS's bf16 output), then K8's
//   arithmetic: bias add in f32 rounded to bf16; the angle pos * inv_freq[i]
//   as one f32 product; precise cosf/sinf; x0 c - x1 s and x0 s + x1 c,
//   each product and the sum rounded to f32, then to bf16.
// - gemv_residual rounds the product to bf16, then x + y in f32 rounded to
//   bf16 (K7's add).
// - norm_gateup rounds gate and up to bf16, then K9's x / (1 + expf(-x))
//   (IEEE division) rounded to bf16, times up in f32, rounded to bf16.
// - norm_head writes the f32 sum as it is.
// A layer kernel may also write its rounded product (``prod``, null on the
// decode path), so a check can hold the product to cuBLAS's and the
// epilogue to its plain version on the same product.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 r(float v) { return __float2bfloat16_rn(v); }

constexpr int kMaxB = 8;         // lanes: the mma's N
constexpr int kMaxD = 1024;      // the normed row's width
constexpr int kWarps = 8;        // a layer CTA's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSteps = 16 / kWarps;  // k-steps of 16 rows a warp holds in registers
constexpr int kTile = 64;        // output columns a cluster
constexpr int kMaxKc = kWarps * kMaxSteps * 16;  // k rows a CTA: 256
constexpr int kXsLd = kMaxKc + 16;  // bf16; a row's stride is 32 bytes past 128 (no bank conflict)
constexpr int kHeadWarps = 8;
constexpr int kHeadThreads = 32 * kHeadWarps;
constexpr int kHeadGroup = 6;    // k-steps of 32 a head warp loads at once
constexpr int kHeadBlocks = 2;   // head CTAs an SM

enum Epilogue { kQkvRope = 0, kResidual = 1, kSiluGateUp = 2 };


__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the next kernel may launch; wait for the previous one's results (both
// no-ops unless the kernel was launched as a programmatic dependent)
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The norm weight's columns [k0, k1) for shared memory (wsl), one float4
// a thread: constant data, loaded before the wait for the previous kernel
// (``load``) and stored after it (``store``), so the load's latency hides
// behind the wait.
struct StagedWeight {
  float4 v;
  int i;
  __device__ __forceinline__ void load(const float* __restrict__ weight, int k0, int k1) {
    i = threadIdx.x;
    v = i < (k1 - k0) / 4 ? *reinterpret_cast<const float4*>(weight + k0 + 4 * i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(float* wsl, int k0, int k1) const {
    if (i < (k1 - k0) / 4) reinterpret_cast<float4*>(wsl)[i] = v;
  }
};

// RMSNorm of rows x[b] (b < B, D values, row stride x_ld) by the weight
// staged in wsl (``StagedWeight``), as K7 computes it, for the columns [k0,
// k1) (multiples of 8), written as bf16 to xs[b * ld + k - k0]; rows B..7
// are zeros. The raw rows pass through xraw[b * ld_raw + k] (which may be
// xs itself where [k0, k1) is the whole row and ld_raw is ld). warp_sum:
// [kMaxB * 32] floats of shared memory. Ends with a __syncthreads.
template <int THREADS>
__device__ void norm_rows(const bf16* __restrict__ x, long long x_ld, const float* wsl, float eps,
                          int D, int B, int k0, int k1, bf16* xraw, int ld_raw, bf16* xs, int ld,
                          float* warp_sum) {
  constexpr int W = THREADS / 32;
  constexpr int kMaxChunks = (kMaxB * (kMaxD / 256) + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = D / 8, per_row = (nv + 31) / 32;  // K7's warps a row
  const int n_chunks = B * per_row;
  uint4 xr[kMaxChunks];
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = warp + i * W;
    xr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < n_chunks) {
      const int b = c / per_row, tv = (c - b * per_row) * 32 + lane;
      if (tv < nv) xr[i] = *reinterpret_cast<const uint4*>(x + b * x_ld + 8 * tv);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = warp + i * W;
    if (c < n_chunks) {  // warp-uniform
      const int b = c / per_row, tv = (c - b * per_row) * 32 + lane;
      const bf16* xv = reinterpret_cast<const bf16*>(&xr[i]);
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = f(xv[j]);
        ss = __fadd_rn(ss, __fmul_rn(v, v));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
      if (lane == 0) warp_sum[c] = ss;  // c = b * per_row + the row's warp
      if (tv < nv) *reinterpret_cast<uint4*>(xraw + b * ld_raw + 8 * tv) = xr[i];
    }
  }
  __syncthreads();
  const int nvs = (k1 - k0) / 8;
  for (int e = threadIdx.x; e < kMaxB * nvs; e += THREADS) {
    const int b = e / nvs, tv = e - b * nvs, k = k0 + 8 * tv;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (b < B) {
      float total = 0.f;
      for (int w = 0; w < per_row; ++w) total = __fadd_rn(total, warp_sum[b * per_row + w]);
      const float mean = __fmul_rn(total, __fdiv_rn(1.f, (float)D));
      const float scale = rsqrtf(__fadd_rn(mean, eps));
      const uint4 v = *reinterpret_cast<const uint4*>(xraw + b * ld_raw + k);
      const bf16* vs = reinterpret_cast<const bf16*>(&v);
      const float4 wa = reinterpret_cast<const float4*>(wsl)[2 * tv];
      const float4 wb = reinterpret_cast<const float4*>(wsl)[2 * tv + 1];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      bf16* os = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int j = 0; j < 8; ++j) os[j] = r(__fmul_rn(__fmul_rn(f(vs[j]), scale), wv[j]));
    }
    *reinterpret_cast<uint4*>(xs + b * ld + 8 * tv) = o;
  }
  __syncthreads();
}

// rows x[b][k0, k1) as they are (b < B), rows B..7 zeros
template <int THREADS>
__device__ void copy_rows(const bf16* __restrict__ x, long long x_ld, int B, int k0, int k1,
                          bf16* xs, int ld) {
  const int nvs = (k1 - k0) / 8;
  for (int e = threadIdx.x; e < kMaxB * nvs; e += THREADS) {
    const int b = e / nvs, tv = e - b * nvs;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (b < B) o = *reinterpret_cast<const uint4*>(x + b * x_ld + k0 + 8 * tv);
    *reinterpret_cast<uint4*>(xs + b * ld + 8 * tv) = o;
  }
  __syncthreads();
}

struct LayerArgs {
  // the input rows [B, K], row stride x_ld: the residual stream (normed
  // first) or an activation
  const bf16* x;
  long long x_ld;
  const float* norm_w;  // [K] f32, or null: no norm
  float eps;
  const bf16* w;  // [K, ldw]
  long long ldw;
  int K, B, split, steps_cta;
  bf16* prod;  // [B, prod_ld]: the rounded product, or null
  long long prod_ld;
  bf16* out;  // kResidual: x [B, out_ld] updated in place; kSiluGateUp: act [B, out_ld]
  long long out_ld;
  int F;  // kSiluGateUp: the up columns start at F
  // kQkvRope (head_dim 64): the tile is one head
  const bf16* bias;
  const float* inv_freq;
  const int* pos;
  bf16* cache_k;
  bf16* cache_v;
  bf16* q_out;
  bf16* k_out;
  bf16* v_out;
  int H, KVH, S, neox;
};

// where the sum of (lane b, tile column n) lies in a CTA's partial sums:
// lane (g, t)'s accumulator c of n-group j holds column 8g + 2j + c / 2 of
// lane 2t + c % 2
__device__ __forceinline__ int part_index(int b, int n) {
  return (4 * ((n & 7) >> 1) + 2 * (n & 1) + (b & 1)) * 32 + 4 * (n >> 3) + (b >> 1);
}

// the cluster's sum of (lane b, tile column n): its ranks' partial sums,
// gathered in rank 0's shared memory, in rank order
__device__ __forceinline__ float cluster_total(const float* gather, int split, int b, int n) {
  const int idx = part_index(b, n);
  float sum = gather[idx];
  for (int q = 1; q < split; ++q) sum = __fadd_rn(sum, gather[q * kMaxB * kTile + idx]);
  return sum;
}

// split cluster barriers: every thread arrives once a phase
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int EPI>
__global__ void __launch_bounds__(kThreads) layer_gemv_kernel(const LayerArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  // the raw rows (the norm prologue) and then the warps' sums share one buffer
  constexpr int kScratch = kMaxB * kMaxD * 2 > kWarps * kMaxB * kTile * 4
                               ? kMaxB * kMaxD * 2 : kWarps * kMaxB * kTile * 4;
  __shared__ __align__(16) unsigned char scratch[kScratch];
  __shared__ __align__(16) bf16 xs[kMaxB * kXsLd];
  __shared__ __align__(16) float wsl[kMaxKc];
  __shared__ __align__(16) float gather[8 * kMaxB * kTile];  // rank 0's: each rank's sums
  __shared__ float warp_sum[kMaxB * 32];
  bf16* const xraw = reinterpret_cast<bf16*>(scratch);
  float(*const red)[kMaxB * kTile] = reinterpret_cast<float(*)[kMaxB * kTile]>(scratch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / a.split;
  const int s0 = rank * a.steps_cta, s1 = min(s0 + a.steps_cta, a.K / 16);
  const int k0 = 16 * s0, k1 = 16 * max(s1, s0);
  const int col = EPI == kSiluGateUp
                      ? (g < 4 ? tile * 32 + 8 * g : a.F + tile * 32 + 8 * (g - 4))
                      : tile * kTile + 8 * g;
  cluster_arrive_relaxed();  // phase 1: this CTA has started (its shared memory exists)

  // the weights first: they do not depend on the previous kernel
  uint4 wv[kMaxSteps][4];
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) {
    const int s = s0 + warp + i * kWarps;
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[i][q] = make_uint4(0u, 0u, 0u, 0u);
    if (s < s1) {
      const bf16* p = a.w + (long long)(16 * s + 4 * t) * a.ldw + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[i][q] = ldg16(p + q * a.ldw);
    }
  }
  StagedWeight nws;
  if (a.norm_w != nullptr) nws.load(a.norm_w, k0, k1);
  pdl_launch_dependents();
  // rank 0's epilogue operands: thread i's items are i, i + 128, ...; the
  // constants now, the previous kernels' outputs after the wait
  constexpr int kItems = EPI == kResidual ? kMaxB * kTile / kThreads : kMaxB * 32 / kThreads;
  constexpr int kPer = EPI == kResidual ? kTile : 32;  // items a lane
  float pre0[kItems], pre1[kItems], freq[kItems];
  int pos_b[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    pre0[i] = pre1[i] = freq[i] = 0.f;
    pos_b[i] = 0;
    const int item = threadIdx.x + i * kThreads, b = item / kPer, j = item - b * kPer;
    if (EPI == kQkvRope && rank == 0 && b < a.B) {
      const bool rotate = tile < a.H + a.KVH;
      const int l0 = (rotate && !a.neox) ? 2 * j : j;
      const int l1 = l0 + ((rotate && !a.neox) ? 1 : kTile / 2);
      if (a.bias != nullptr) {
        pre0[i] = f(a.bias[tile * kTile + l0]);
        pre1[i] = f(a.bias[tile * kTile + l1]);
      }
      if (rotate) freq[i] = a.inv_freq[j];
    }
  }
  pdl_wait();
  if (a.norm_w != nullptr) nws.store(wsl, k0, k1);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = threadIdx.x + i * kThreads, b = item / kPer, j = item - b * kPer;
    if (rank == 0 && b < a.B) {
      if (EPI == kResidual) pre0[i] = f(a.out[b * a.out_ld + tile * kTile + j]);
      if (EPI == kQkvRope) pos_b[i] = a.pos[b];
    }
  }

  if (a.norm_w != nullptr)
    norm_rows<kThreads>(a.x, a.x_ld, wsl, a.eps, a.K, a.B, k0, k1, xraw, kMaxD, xs, kXsLd,
                        warp_sum);
  else
    copy_rows<kThreads>(a.x, a.x_ld, a.B, k0, k1, xs, kXsLd);

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) {
    const int s = s0 + warp + i * kWarps;
    if (s < s1) {
      // x fragment: k slots 2t, 2t+1 | 2t+8, 2t+9 hold rows 4t .. 4t+3 of the step
      const uint2 xb = *reinterpret_cast<const uint2*>(xs + g * kXsLd + 16 * (s - s0) + 4 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w0 = word(wv[i][0], j), w1 = word(wv[i][1], j);
        const uint32_t w2 = word(wv[i][2], j), w3 = word(wv[i][3], j);
        // row g: column 8g + 2j (low halves); row g + 8: column 8g + 2j + 1
        mma_bf16(acc[j], __byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
                 __byte_perm(w2, w3, 0x5410), __byte_perm(w2, w3, 0x7632), xb.x, xb.y);
      }
    }
  }

  // the CTA's warps in order, into rank 0's gather slot of this rank
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][(4 * j + c) * 32 + lane] = acc[j][c];
  __syncthreads();
  cluster_wait();  // phase 1 done: every CTA of the cluster has started
  float* dst = cluster.map_shared_rank(gather, 0) + rank * kMaxB * kTile;
  for (int idx = threadIdx.x; idx < kMaxB * kTile; idx += kThreads) {
    if (2 * (idx & 3) + ((idx >> 5) & 1) >= a.B) continue;  // the lane b of part_index
    float sum = red[0][idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, red[w][idx]);
    dst[idx] = sum;
  }
  cluster_arrive_release();  // phase 2: this rank's sums are in rank 0
  if (rank != 0) return;
  cluster_wait();

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = threadIdx.x + i * kThreads, b = item / kPer, j = item - b * kPer;
    if (b >= a.B) continue;
    if (EPI == kResidual) {
      const int c = tile * kTile + j;
      const bf16 y = r(cluster_total(gather, a.split, b, j));
      if (a.prod != nullptr) a.prod[b * a.prod_ld + c] = y;
      a.out[b * a.out_ld + c] = r(__fadd_rn(pre0[i], f(y)));
    } else if (EPI == kSiluGateUp) {
      const int c = tile * 32 + j;
      const bf16 gate = r(cluster_total(gather, a.split, b, j));
      const bf16 up = r(cluster_total(gather, a.split, b, 32 + j));
      if (a.prod != nullptr) {
        a.prod[b * a.prod_ld + c] = gate;
        a.prod[b * a.prod_ld + a.F + c] = up;
      }
      const float xv = f(gate);
      const float sg = f(r(__fdiv_rn(xv, __fadd_rn(1.f, expf(-xv)))));
      a.out[b * a.out_ld + c] = r(__fmul_rn(sg, f(up)));
    } else {  // kQkvRope: K8's arithmetic on the tile's head (HD = 64)
      constexpr int HD = kTile, half = HD / 2;
      const int head = tile;
      const bool rotate = head < a.H + a.KVH;
      const long long kv_width = (long long)a.KVH * HD;
      const int l0 = (rotate && !a.neox) ? 2 * j : j;
      const int l1 = l0 + ((rotate && !a.neox) ? 1 : half);
      const int c0 = head * HD + l0, c1 = head * HD + l1;
      bf16 a0 = r(cluster_total(gather, a.split, b, l0));
      bf16 a1 = r(cluster_total(gather, a.split, b, l1));
      if (a.prod != nullptr) {
        a.prod[b * a.prod_ld + c0] = a0;
        a.prod[b * a.prod_ld + c1] = a1;
      }
      if (a.bias != nullptr) {
        a0 = r(__fadd_rn(f(a0), pre0[i]));
        a1 = r(__fadd_rn(f(a1), pre1[i]));
      }
      const int p = pos_b[i];
      bf16 y0 = a0, y1 = a1;
      if (rotate) {
        const float ang = __fmul_rn((float)p, freq[i]);
        const float cs = cosf(ang), sn = sinf(ang);
        const float x0 = f(a0), x1 = f(a1);
        y0 = r(__fsub_rn(__fmul_rn(x0, cs), __fmul_rn(x1, sn)));
        y1 = r(__fadd_rn(__fmul_rn(x0, sn), __fmul_rn(x1, cs)));
      }
      if (head < a.H) {
        bf16* q = a.q_out + (long long)b * a.H * HD;
        q[c0] = y0;
        q[c1] = y1;
      } else {
        const bool is_k = head < a.H + a.KVH;
        const int base = (is_k ? a.H : a.H + a.KVH) * HD;
        bf16* dst = (is_k ? a.k_out : a.v_out) + (long long)b * kv_width;
        dst[c0 - base] = y0;
        dst[c1 - base] = y1;
        if (p >= 0 && p < a.S) {
          bf16* cache = (is_k ? a.cache_k : a.cache_v) + ((long long)b * a.S + p) * kv_width;
          cache[c0 - base] = y0;
          cache[c1 - base] = y1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kHeadThreads, kHeadBlocks) norm_head_kernel(
    const bf16* __restrict__ x, long long x_ld, const float* __restrict__ norm_w, float eps,
    const bf16* __restrict__ head, int V, int D, int B, float* __restrict__ logits) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // [kMaxB][D + 32]
  __shared__ __align__(16) float wsl[kMaxD];
  __shared__ float warp_sum[kMaxB * 32];
  const int ld = D + 32;  // a row's stride is 64 bytes past 128 (no bank conflict)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kHeadWarps + warp) * 16;
  const bf16* ra = head + (long long)min(row0 + g, V - 1) * D + 8 * t;
  const bf16* rb = head + (long long)min(row0 + g + 8, V - 1) * D + 8 * t;
  const int n_steps = D / 32;
  uint4 wa[kHeadGroup], wb[kHeadGroup];
#pragma unroll
  for (int i = 0; i < kHeadGroup; ++i) {
    if (i < n_steps) {
      wa[i] = ldg16(ra + 32 * i);
      wb[i] = ldg16(rb + 32 * i);
    } else {
      wa[i] = wb[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  StagedWeight nws;
  nws.load(norm_w, 0, D);
  pdl_launch_dependents();
  pdl_wait();
  nws.store(wsl, 0, D);
  norm_rows<kHeadThreads>(x, x_ld, wsl, eps, D, B, 0, D, hs, ld, hs, ld, warp_sum);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < n_steps; s0 += kHeadGroup) {
#pragma unroll
    for (int i = 0; i < kHeadGroup; ++i) {
      const int s = s0 + i;
      if (s < n_steps) {
        const uint4 hb = *reinterpret_cast<const uint4*>(hs + g * ld + 32 * s + 8 * t);
        mma_bf16(acc, wa[i].x, wb[i].x, wa[i].y, wb[i].y, hb.x, hb.y);
        mma_bf16(acc, wa[i].z, wb[i].z, wa[i].w, wb[i].w, hb.z, hb.w);
      }
    }
#pragma unroll
    for (int i = 0; i < kHeadGroup; ++i) {
      const int s = s0 + kHeadGroup + i;
      if (s < n_steps) {
        wa[i] = ldg16(ra + 32 * s);
        wb[i] = ldg16(rb + 32 * s);
      }
    }
  }
  const int b0 = 2 * t, b1 = 2 * t + 1, v0 = row0 + g, v1 = row0 + g + 8;
  if (v0 < V) {
    if (b0 < B) logits[(long long)b0 * V + v0] = acc[0];
    if (b1 < B) logits[(long long)b1 * V + v0] = acc[1];
  }
  if (v1 < V) {
    if (b0 < B) logits[(long long)b0 * V + v1] = acc[2];
    if (b1 < B) logits[(long long)b1 * V + v1] = acc[3];
  }
}

template <int EPI>
int launch_layer(const LayerArgs& a, int n_tiles, void* stream) {
  if (a.B < 1 || a.B > kMaxB || a.K < 16 || a.K % 16 || a.split < 1 || a.split > 8 ||
      a.steps_cta < 1 || (a.steps_cta + kWarps - 1) / kWarps > kMaxSteps ||
      (long long)a.split * a.steps_cta * 16 < a.K || n_tiles < 1 ||
      (a.norm_w != nullptr && (a.K > kMaxD || a.K % 8)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tiles * a.split), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = (unsigned)a.split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, layer_gemv_kernel<EPI>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

LayerArgs layer_args(const void* x, long long x_ld, const void* norm_w, float eps, const void* w,
                     long long ldw, int K, int B, int split, int steps_cta, void* prod,
                     long long prod_ld) {
  LayerArgs a = {};
  a.x = (const bf16*)x;
  a.x_ld = x_ld;
  a.norm_w = (const float*)norm_w;
  a.eps = eps;
  a.w = (const bf16*)w;
  a.ldw = ldw;
  a.K = K;
  a.B = B;
  a.split = split;
  a.steps_cta = steps_cta;
  a.prod = (bf16*)prod;
  a.prod_ld = prod_ld;
  return a;
}

}  // namespace

// RMSNorm(x [B, D], row stride x_ld) @ w [D, N] (N = (H + 2 KVH) 64, columns
// q | k | v), then the bias (may be null), RoPE at pos [B] int32 by inv_freq
// [32] f32 (NEOX or adjacent pairs), q_out [B, H 64], k_out/v_out [B, KVH 64]
// and this step's row of cache_k/cache_v [B, S, KVH, 64] (none where pos is
// outside [0, S)). prod [B, N] (may be null): the rounded product.
extern "C" int miotts_norm_qkv_bf16(const void* x, long long x_ld, const void* norm_w, float eps,
                                    const void* w, int D, int N, int split, int steps_cta,
                                    const void* bias, const void* inv_freq, const void* pos,
                                    void* cache_k, void* cache_v, void* q_out, void* k_out,
                                    void* v_out, int B, int H, int KVH, int S, int neox,
                                    void* prod, void* stream) {
  if (H < 1 || KVH < 1 || H % KVH || S < 1 || N != (H + 2 * KVH) * kTile)
    return (int)cudaErrorInvalidValue;
  LayerArgs a = layer_args(x, x_ld, norm_w, eps, w, N, D, B, split, steps_cta, prod, N);
  a.bias = (const bf16*)bias;
  a.inv_freq = (const float*)inv_freq;
  a.pos = (const int*)pos;
  a.cache_k = (bf16*)cache_k;
  a.cache_v = (bf16*)cache_v;
  a.q_out = (bf16*)q_out;
  a.k_out = (bf16*)k_out;
  a.v_out = (bf16*)v_out;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.neox = neox;
  if (norm_w == nullptr) return (int)cudaErrorInvalidValue;
  return launch_layer<kQkvRope>(a, N / kTile, stream);
}

// x [B, N] (row stride x_ld) += act [B, K] (row stride act_ld) @ w [K, N],
// in place, each sum rounded to bf16 as K7's residual add. prod [B, N] (may
// be null): the rounded product.
extern "C" int miotts_gemv_residual_bf16(const void* act, long long act_ld, const void* w, int K,
                                         int N, int split, int steps_cta, void* x, long long x_ld,
                                         int B, void* prod, void* stream) {
  if (N < kTile || N % kTile) return (int)cudaErrorInvalidValue;
  LayerArgs a = layer_args(act, act_ld, nullptr, 0.f, w, N, K, B, split, steps_cta, prod, N);
  a.out = (bf16*)x;
  a.out_ld = x_ld;
  return launch_layer<kResidual>(a, N / kTile, stream);
}

// out [B, F] = silu(gate) * up of RMSNorm(x [B, D]) @ w [D, 2F] (gate at
// columns [0, F), up at [F, 2F)). prod [B, 2F] (may be null): the rounded
// gate|up product.
extern "C" int miotts_norm_gateup_bf16(const void* x, long long x_ld, const void* norm_w,
                                       float eps, const void* w, int D, int F, int split,
                                       int steps_cta, void* out, int B, void* prod,
                                       void* stream) {
  if (F < 32 || F % 32 || norm_w == nullptr) return (int)cudaErrorInvalidValue;
  LayerArgs a = layer_args(x, x_ld, norm_w, eps, w, 2LL * F, D, B, split, steps_cta, prod, 2LL * F);
  a.out = (bf16*)out;
  a.out_ld = F;
  a.F = F;
  return launch_layer<kSiluGateUp>(a, F / 32, stream);
}

// logits [B, V] f32 = RMSNorm(x [B, D]) @ head [V, D]^T, accumulated in f32.
extern "C" int miotts_norm_head_bf16(const void* x, long long x_ld, const void* norm_w, float eps,
                                     const void* head, int V, int D, int B, void* logits,
                                     void* stream) {
  if (B < 1 || B > kMaxB || V < 1 || D < 32 || D % 32 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)V + 16 * kHeadWarps - 1) / (16 * kHeadWarps);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kHeadThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)kMaxB * (D + 32) * sizeof(bf16);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, norm_head_kernel, (const bf16*)x, x_ld, (const float*)norm_w, eps,
                         (const bf16*)head, V, D, B, (float*)logits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
