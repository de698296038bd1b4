// K10 sample_step: one served decode step's sampler and its bookkeeping,
// for every lane of the batch, in two launches (f32 logits):
//
//   select  grid (slices, B): each block takes one slice of a lane's
//           vocabulary, applies the repeat penalty to the ring's tokens in
//           it, and writes the slice's top-k candidates, sorted
//   tail    grid B: each block merges its lane's sorted slice lists into
//           the lane's top-k, then top-p, the Gumbel-max draw (or greedy),
//           the key's draw count, the penalty ring, this step's output
//           token, the lane's count and done flag, and its pos advance
//
// Replaces: no Pallas kernel. On the TPU, XLA fused the batched sampler
// (miotts_tpu/models/sampling.py sample_token_batched) into a few fusions
// around its sort; in PyTorch the same chain (models/sampling.py
// sample_step_plain) is ~100 kernels a step inside a chunk graph: ~7
// passes over the [B, V] logits, torch.topk's radix passes, the
// counter-based hash, a softmax and a cumsum over [B, 256], and the
// bookkeeping of models/llm.py _chunk_body_batched.
//
// What bounds it on the H100: latency. Its bytes are one read of a lane's
// f32 logits (607 KB at V = 151 759, 0.18 us at 3.35 TB/s). The design
// reads them once, spread over 16 blocks a lane (32 past V = 196 608), and
// keeps every later step on chip. A select block holds its slice in
// registers (24 values a thread; scalar coalesced loads, since an odd V
// leaves lane rows 4-byte aligned only) and works on few of them: a floor
// that at least k values reach, the k-th largest of each warp's q largest
// thread maxima (a bitonic sort in shuffles, then a count), keeps a little
// over k candidates in shared memory, whose ranks among each other (a
// count, a few threads a candidate) place the top k. Where more than
// 2 048 reach the floor (many ties), a bisection of the value's
// order-preserving 32-bit key over every value, 2 bits an iteration, each
// a block-wide count, finds the k-th (16 iterations, 16 more on the index
// where values tie there): exact, and slower. The tail merges the sorted
// lists pairwise (each element's place by a binary search in its partner
// list), 4 rounds for 16 slices, in shared memory, and scores one rank a
// thread (block sums and a scan for top-p, a block argmax), the lane's
// scalars loaded by threads of their own while the lists load. Two
// launches and not one cluster: the split lets the select's first block
// snapshot and advance the ring cursor that every lane reads, with no
// atomics and no counter across launches, and the measured time is the
// blocks' own latency, which a cluster would not shorten.
//
// Order. Candidates are ordered by value, descending, ties to the lower
// vocabulary index: a composite 64-bit key (value key << 32 | ~index).
//
// Arithmetic (no fast math; each operation rounded as the plain version's
// PyTorch expression rounds it):
// - penalty: a token of the ring, each one once, where the lane's penalty
//   is not 1: x > 0 ? x / p : x * p.
// - greedy (temp <= 0): rank 0.
// - top-p (0 < top_p < 1): softmax of the kept values (expf(v - v0), their
//   sum, each divided by it) and its running sum in rank order; a rank is
//   kept where (cum - prob) < top_p, rank 0 always. The sums run in
//   another order than ATen's, so only a rank whose cum - prob lies within
//   rounding of top_p may be kept otherwise.
// - draw: argmax over kept ranks r of v_r / max(temp, 1e-6) -
//   logf(-logf(u_r)), ties to the lower rank, u_r the counter-based
//   uniform of (seed, draws, r) that uniform_lanes computes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 24;                     // slice values a thread holds
constexpr int kSliceMax = kThreads * kPerThread;   // 12 288
constexpr int kMinSlices = 16;
constexpr int kMaxSlices = 32;
constexpr int kPool = 256;                         // MAX_TOP_K
constexpr int kCandMax = 2048;                     // a select block's candidates past its floor
constexpr int kEogMax = 64;                        // EOG ids a tail block stages
constexpr int kRing = 64;                          // PENALTY_LAST_N
constexpr u64 kMix = 0x45D9F3BULL;
constexpr u64 kM32 = 0xFFFFFFFFULL;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr u64 kCountMask = (1ULL << 21) - 1;       // three block counts in one u64

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// ranks a lane needs: rank 0 alone when greedy (temp <= 0), else its pool
// min(top_k, K) (K where top_k <= 0)
__device__ __forceinline__ int lane_pool(float temp, int top_k, int K) {
  if (temp <= 0.f) return 1;
  return top_k > 0 ? min(top_k, K) : K;
}

// this lane's value of the warp's 32 values sorted descending (bitonic)
__device__ __forceinline__ unsigned warp_sort_desc(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? max(v, o) : min(v, o);
    }
  return v;
}

// sampling.py _mix32 on int64 values, wrapping as torch's int64 product does
__device__ __forceinline__ long long mix32(long long x) {
  x = (long long)(((u64)((x >> 16) ^ x) * kMix) & kM32);
  x = (long long)(((u64)((x >> 16) ^ x) * kMix) & kM32);
  return (x >> 16) ^ x;
}

// sampling.py _unit: ((hash >> 9) + 0.5) * 2^-23 in f32
__device__ __forceinline__ float unit(long long base, int r) {
  const long long h = mix32((base + r) & (long long)kM32);
  return __fmul_rn(__fadd_rn((float)(h >> 9), 0.5f), 1.1920928955078125e-07f);
}

// the sum over the block of a value of every thread; red holds two slots a
// warp, used in turns, so one barrier a call suffices
__device__ __forceinline__ u64 block_sum(u64 v, u64* red, int& parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  u64* slot = red + parity * kWarps;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += slot[w];
  parity ^= 1;
  return s;
}

// argmax order: a NaN above any number (torch.argmax's), then the value,
// then the lower rank
__device__ __forceinline__ bool better(float a, int ra, float b, int rb) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ra < rb);
  return a > b || (a == b && ra < rb);
}

__global__ void __launch_bounds__(kThreads)
    sample_select_kernel(const float* __restrict__ logits, int V, int slice,
                         const long long* __restrict__ ring, const float* __restrict__ penalty,
                         const float* __restrict__ temp, const int* __restrict__ top_k, int K,
                         u64* __restrict__ cand, int* __restrict__ ring_idx,
                         int* __restrict__ cursor) {
  __shared__ long long ring_s[kRing];
  __shared__ int pen_off[kRing];
  __shared__ int n_pen, n_cand, n_sel;
  __shared__ unsigned tops[kPool];  // each warp's q largest thread maxima
  __shared__ unsigned floor_s;
  __shared__ u64 red[2 * kWarps];
  __shared__ u64 cand_s[kCandMax];
  const int s = blockIdx.x, b = blockIdx.y, t = threadIdx.x, NS = gridDim.x;
  const int lo = s * slice;
  const int n = max(0, min(V - lo, slice));
  const int k = lane_pool(temp[b], top_k[b], K);
  const int ks = min(k, n);
  const float pen = penalty[b];

  if (s == 0 && b == 0 && t == 0) {  // the shared ring cursor: read once, advanced once
    const int c = *ring_idx;
    *cursor = c;
    *ring_idx = c + 1;
  }
  if (t == 0) n_pen = n_cand = n_sel = 0;
  if (t < kRing) ring_s[t] = ring[(long long)b * kRing + t];
  const float* row = logits + (long long)b * V + lo;
  const int nv = n > t ? (n - t + kThreads - 1) / kThreads : 0;  // this thread's values
  float x[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) x[j] = j < nv ? row[t + j * kThreads] : 0.f;
  __syncthreads();
  // the ring's tokens in this slice, each once (presence, not count)
  if (pen != 1.f && t < kRing) {
    const long long tok = ring_s[t];
    bool first = tok >= lo && tok < lo + n;
    for (int m = 0; m < t && first; ++m) first = ring_s[m] != tok;
    if (first) pen_off[atomicAdd(&n_pen, 1)] = (int)(tok - lo);
  }
  __syncthreads();
  for (int m = 0; m < n_pen; ++m) {
    const int off = pen_off[m];
    if (off % kThreads == t) {
      const int jm = off / kThreads;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (j == jm) x[j] = x[j] > 0.f ? __fdiv_rn(x[j], pen) : __fmul_rn(x[j], pen);
    }
  }
  unsigned key[kPerThread];
  unsigned top = 0;  // this thread's largest key (0: no value)
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    key[j] = order_key(x[j]);
    if (j < nv) top = max(top, key[j]);
  }
  u64* list = cand + ((long long)b * NS + s) * K;

  if (ks > 0) {
    // a floor that at least ks values reach: the ks-th largest of the
    // warps' q largest thread maxima, q = ceil(ks / warps) (ks threads
    // hold a value at or above it; a 0 takes every value)
    const int q = (ks + kWarps - 1) / kWarps, nq = kWarps * q;
    const unsigned sorted = warp_sort_desc(top);
    if ((t & 31) < q) tops[(t >> 5) * q + (t & 31)] = sorted;
    __syncthreads();
    if (t < nq) {
      const unsigned v = tops[t];
      int r = 0;
      for (int m = 0; m < nq; ++m) {
        const unsigned u = tops[m];
        r += u > v || (u == v && m < t);
      }
      if (r == ks - 1) floor_s = v;
    }
    __syncthreads();
    const unsigned floor_key = floor_s;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (j < nv && key[j] >= floor_key) {
        const int at = atomicAdd(&n_cand, 1);
        if (at < kCandMax)
          cand_s[at] = ((u64)key[j] << 32) | ~(unsigned)(lo + t + j * kThreads);
      }
    __syncthreads();
    const int C = n_cand;
    if (C <= kCandMax) {
      // each candidate's rank among the others, g threads a candidate
      int g = 1;
      while (g < 32 && g * 2 * C <= kThreads) g *= 2;
      for (int base = 0; base < C * g; base += kThreads) {
        const int e = base + t, i = e / g, h = e % g;
        const u64 c = i < C ? cand_s[i] : 0;
        int r = 0;
        if (i < C)
          for (int m = h; m < C; m += g) r += cand_s[m] > c;
        for (int off = 1; off < g; off <<= 1) r += __shfl_xor_sync(kFull, r, off);
        if (i < C && h == 0 && r < ks) list[r] = c;
      }
    } else {
      // many values at the floor (ties): the bisection over every value.
      // T: the largest value key with at least ks values at or above it
      unsigned T = 0, L = 0;
      int n_ge = n, parity = 0;
      for (int sh = 30; sh >= 0; sh -= 2) {
        const unsigned c1 = T | (1u << sh), c2 = T | (2u << sh), c3 = T | (3u << sh);
        u64 v = 0;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (j < nv)
            v += (u64)(key[j] >= c1) | ((u64)(key[j] >= c2) << 21) | ((u64)(key[j] >= c3) << 42);
        v = block_sum(v, red, parity);
        const int n1 = (int)(v & kCountMask), n2 = (int)((v >> 21) & kCountMask),
                  n3 = (int)(v >> 42);
        if (n3 >= ks) T = c3, n_ge = n3;
        else if (n2 >= ks) T = c2, n_ge = n2;
        else if (n1 >= ks) T = c1, n_ge = n1;
      }
      // values tie at T past ks: L keeps the lowest indices among them (~index)
      if (n_ge > ks) {
        for (int sh = 30; sh >= 0; sh -= 2) {
          const unsigned c1 = L | (1u << sh), c2 = L | (2u << sh), c3 = L | (3u << sh);
          u64 v = 0;
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            if (j < nv) {
              const unsigned li = ~(unsigned)(lo + t + j * kThreads);
              const bool gt = key[j] > T, eq = key[j] == T;
              v += (u64)(gt || (eq && li >= c1)) | ((u64)(gt || (eq && li >= c2)) << 21) |
                   ((u64)(gt || (eq && li >= c3)) << 42);
            }
          v = block_sum(v, red, parity);
          const int n1 = (int)(v & kCountMask), n2 = (int)((v >> 21) & kCountMask),
                    n3 = (int)(v >> 42);
          if (n3 >= ks) L = c3;
          else if (n2 >= ks) L = c2;
          else if (n1 >= ks) L = c1;
        }
      }
      u64* sel = cand_s;  // its candidates are read no more
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (j < nv) {
          const unsigned li = ~(unsigned)(lo + t + j * kThreads);
          if (key[j] > T || (key[j] == T && li >= L))
            sel[atomicAdd(&n_sel, 1)] = ((u64)key[j] << 32) | li;
        }
      __syncthreads();
      // rank sort, descending, two threads an element
      const int i = t >> 1, h = t & 1;
      const u64 c = i < ks ? sel[i] : 0;
      int r = 0;
      if (i < ks)
        for (int m = h; m < ks; m += 2) r += sel[m] > c;
      r += __shfl_xor_sync(kFull, r, 1);
      if (i < ks && h == 0) list[r] = c;
    }
  }
  // past ks the sentinel 0, below every candidate
  for (int e = ks + t; e < k; e += kThreads) list[e] = 0;
}

__global__ void __launch_bounds__(kThreads)
    sample_tail_kernel(const u64* __restrict__ cand, int NS, int K,
                       const float* __restrict__ temp, const int* __restrict__ top_k,
                       const float* __restrict__ top_p, long long* __restrict__ key,
                       long long* __restrict__ ring, const int* __restrict__ cursor,
                       const long long* __restrict__ eog, int n_eog,
                       const int* __restrict__ rem, unsigned char* __restrict__ done,
                       int* __restrict__ count, long long* __restrict__ out, long long out_ld,
                       long long* __restrict__ tok_out, int* __restrict__ adv) {
  extern __shared__ u64 buf[];  // two buffers of NS lists of k
  // the lane's scalars, loaded by threads of their own while the lists load
  __shared__ long long key_s[2], eog_s[kEogMax];
  __shared__ float top_p_s;
  __shared__ int cursor_s, count_s, rem_s, done_s;
  __shared__ float part_s[kWarps];
  __shared__ float best_s[kWarps];
  __shared__ int rank_s[kWarps];
  const int b = blockIdx.x, t = threadIdx.x;
  const float tv = temp[b];
  const int k = lane_pool(tv, top_k[b], K);
  if (t >= 32 && t < 32 + kEogMax && t - 32 < n_eog) eog_s[t - 32] = eog[t - 32];
  switch (t) {
    case 96: key_s[0] = key[2 * b]; break;
    case 97: key_s[1] = key[2 * b + 1]; break;
    case 98: top_p_s = top_p[b]; break;
    case 99: cursor_s = *cursor; break;
    case 100: count_s = count[b]; break;
    case 101: rem_s = rem[b]; break;
    case 102: done_s = done[b]; break;
    default: break;
  }
  u64* src = buf;
  u64* dst = buf + NS * k;
  const u64* lists = cand + (long long)b * NS * K;
  for (int e = t; e < NS * k; e += kThreads) src[e] = lists[(e / k) * K + e % k];
  __syncthreads();
  // pairwise merges, each list kept to its first k: an element's place in
  // the merged list is its own plus the partner's elements above it
  for (int m = NS; m > 1; m >>= 1) {
    for (int e = t; e < m * k; e += kThreads) {
      const int li = e / k, p = e - li * k;
      const u64 c = src[e];
      const u64* other = src + (li ^ 1) * k;
      int a = 0, z = k;
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (other[mid] > c) a = mid + 1;
        else z = mid;
      }
      if (p + a < k) dst[(li >> 1) * k + p + a] = c;
    }
    __syncthreads();
    u64* tmp = src;
    src = dst;
    dst = tmp;
  }
  // one rank a thread (ranks past k, and threads past the pool, hold none)
  const int lane = t & 31, warp = t >> 5;
  int choice = 0;
  if (!(tv <= 0.f)) {
    const float tp = top_p_s;
    const bool p_on = tp > 0.f && tp < 1.f;
    const float tc = tv < 1e-6f ? 1e-6f : tv;  // torch.clamp(min=1e-6)
    const bool in = t < k;
    const float v = in ? key_value((unsigned)(src[t] >> 32)) : -INFINITY;
    bool keep = in;
    if (p_on) {
      // softmax over the ranks and its running sum in rank order
      const float e = expf(__fsub_rn(v, key_value((unsigned)(src[0] >> 32))));
      float w = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) w = __fadd_rn(w, __shfl_xor_sync(kFull, w, off));
      if (lane == 0) part_s[warp] = w;
      __syncthreads();
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) sum = __fadd_rn(sum, part_s[i]);
      const float pr = __fdiv_rn(e, sum);
      float cum = pr;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, cum, off);
        if (lane >= off) cum = __fadd_rn(cum, y);
      }
      __syncthreads();  // every sum read: part_s takes the warps' totals
      if (lane == 31) part_s[warp] = cum;
      __syncthreads();
      float before = 0.f;
      for (int i = 0; i < warp; ++i) before = __fadd_rn(before, part_s[i]);
      cum = __fadd_rn(before, cum);
      keep = in && (t == 0 || __fsub_rn(cum, pr) < tp);
    }
    float best = -INFINITY;
    int br = kThreads;
    if (keep) {
      const long long base = mix32((mix32(key_s[0]) + key_s[1]) & (long long)kM32);
      best = __fsub_rn(__fdiv_rn(v, tc), logf(-logf(unit(base, t))));
      br = t;
    } else if (in) {
      br = t;  // -inf, at its rank
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int orr = __shfl_xor_sync(kFull, br, off);
      if (better(ob, orr, best, br)) best = ob, br = orr;
    }
    if (lane == 0) best_s[warp] = best, rank_s[warp] = br;
    __syncthreads();
    if (t == 0) {
      best = best_s[0], br = rank_s[0];
      for (int i = 1; i < kWarps; ++i)
        if (better(best_s[i], rank_s[i], best, br)) best = best_s[i], br = rank_s[i];
      choice = br;
    }
  }
  if (t != 0) return;
  const long long tok = (long long)(unsigned)~(unsigned)src[choice];
  key[2 * b + 1] = key_s[1] + 1;
  const int col = ((cursor_s % kRing) + kRing) % kRing;
  ring[(long long)b * kRing + col] = tok;
  const bool was_done = done_s != 0;
  out[(long long)b * out_ld] = was_done ? 0 : tok;
  const int cnt = count_s + (was_done ? 0 : 1);
  count[b] = cnt;
  bool eos = false;
  for (int e = 0; e < n_eog; ++e) eos = eos || tok == (e < kEogMax ? eog_s[e] : eog[e]);
  const bool now_done = was_done || eos || cnt >= rem_s;
  done[b] = now_done ? 1 : 0;
  adv[b] = now_done ? 0 : 1;
  tok_out[b] = tok;
}

}  // namespace

// logits [B, V] f32; ring [B, 64] int64 (-1 empty); penalty, temp, top_p
// [B] f32, top_k [B] int32; key [B, 2] int64; ring_idx [] int32; eog
// [n_eog] int64; rem, count [B] int32; done [B] bool; out [B] int64 at row
// stride out_ld; tok_out [B] int64, adv [B] int32. scratch: B * 32 *
// min(V, 256) u64 candidates, then one int32 (the cursor's snapshot).
// Requires V <= 32 * 12 288.
extern "C" int miotts_sample_step(const void* logits, int B, int V, const void* ring,
                                  const void* penalty, const void* temp, const void* top_k,
                                  const void* top_p, void* key, void* ring_idx, const void* eog,
                                  int n_eog, const void* rem, void* done, void* count, void* out,
                                  long long out_ld, void* tok_out, void* adv, void* scratch,
                                  void* stream) {
  if (B < 1 || B > 65535 || V < 1 || V > kMaxSlices * kSliceMax || n_eog < 0)
    return (int)cudaErrorInvalidValue;
  // the select's blocks a lane: the least power of two from 16 whose
  // slices hold at most kSliceMax values
  int slices = kMinSlices;
  while ((long long)slices * kSliceMax < V) slices *= 2;
  const int slice = (V + slices - 1) / slices;
  const int K = V < kPool ? V : kPool;
  u64* cand = (u64*)scratch;
  int* cursor = (int*)(cand + (size_t)B * kMaxSlices * K);
  const size_t smem = 2 * (size_t)slices * K * sizeof(u64);
  static size_t allowed[miotts_smem::kMaxDevices];
  cudaError_t e = miotts_smem::raise_limit(sample_tail_kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const auto st = (cudaStream_t)stream;
  sample_select_kernel<<<dim3(slices, B), kThreads, 0, st>>>(
      (const float*)logits, V, slice, (const long long*)ring, (const float*)penalty,
      (const float*)temp, (const int*)top_k, K, cand, (int*)ring_idx, cursor);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sample_tail_kernel<<<B, kThreads, smem, st>>>(
      cand, slices, K, (const float*)temp, (const int*)top_k, (const float*)top_p,
      (long long*)key, (long long*)ring, cursor, (const long long*)eog, n_eog, (const int*)rem,
      (unsigned char*)done, (int*)count, (long long*)out, out_ld, (long long*)tok_out, (int*)adv);
  return (int)cudaGetLastError();
}
