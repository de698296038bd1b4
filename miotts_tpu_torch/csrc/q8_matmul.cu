// Kernel K3: activation (bf16 or f32) times Q8_0 weights, dequantized in the
// tile, f32 out, in ONE launch.
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
// What bounds it on the H100: bytes. At decode (T = 1..8) it streams the
// weights, ~1.125 bytes per weight (int8 plus a 4-byte scale per 32), with
// T FMAs per weight, far below the card's ~295 FLOP/byte balance point.
// The 0.1B logits head (768 x 151 808) is 116.6 MB of int8 and 14.6 MB of
// scales: at 3.35 TB/s no kernel takes it in less than ~39 us. A layer
// leaf is 0.7-3.5 MB (0.2-1.1 us), so there the time is latency: the
// launch, one trip to memory and the reduction of the sums.
//
// Two paths, each one launch; ops/cuda/q8_matmul.py launch_shape picks one
// from the shapes alone (never from data, so a CUDA graph can capture it):
//
// 1. The GEMV (T <= 8, K N <= 16 M, N % 16 == 0: every layer leaf at
//    decode). A block owns 16 columns and the whole K range; its 256
//    threads split K into runs of 4 rows of one Q8_0 block, each row one
//    16-byte load of q, each run one 64-byte load of scales, every load of
//    a thread requested before it uses any. The sums meet in a fixed
//    order through shared memory. No shared staging of the weights, no
//    cluster: 48-256 blocks at the 0.1B leaves.
//    The ring below with K split over clusters, 132-256 blocks, was
//    measured at the leaves first (clock64 stamps and plan sweeps on the
//    card, PERF.md): issuing its stages cost ~600 cycles each, and the
//    cluster barrier and combine ~2 000 cycles, on a critical path of
//    ~5-9 us; the GEMV takes 3.4-4.6 us.
// 2. The ring (the logits head, and T > 8). A block owns 128 columns and
//    TT rows of x (1, 2, 4 or 8; larger T is tiled over grid.y), and one
//    range of whole Q8_0 blocks along K. The weight tiles, one Q8_0 block
//    (32 rows x 128 int8 and 128 scales) a stage, stream through an 8-stage
//    cp.async ring in shared memory in 16-byte copies (4-byte copies when
//    N % 16 != 0), 7 stages in flight; the x tile is copied with the first
//    stage and rounded to bf16 once it has arrived. Thread (row group g,
//    column group c) takes 4 columns of 4 rows of each stage (a warp reads
//    whole 128-byte lines) and one float4 of scales. When the tiles leave
//    SMs idle, K is split over grid.z and the splits of a column tile form
//    a thread-block cluster (<= 8 blocks, the portable size; up to 16 with
//    the non-portable attribute when the x tile needs it): each block
//    stores the slices of its partial [TT, 128] sums into the shared
//    memory of the ranks that own them (distributed shared memory), and
//    after one cluster barrier rank r adds the partials of ranks 0, 1, ...
//    in that order for its slice. No second launch, no scratch tensor, no
//    atomics: results are bit-stable from run to run.
// Both dequantize with cheap instructions: a byte permutation and a
// subtraction make the exact float, one pack instruction rounds two
// weights to bf16. No tensor cores: at decode T is 1..8, and prefill only
// needs to be right (a tensor-core prefill path is queued in ROADMAP.md).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, at T = 1
// (PERF.md keeps the runs): the leaves wqkv, wo, w_gateup and w_down in
// 3.43, 3.42, 4.40 and 4.61 us on the GEMV, against 4.16, 4.38, 4.47 and
// 5.84 us for cuBLAS's bf16 GEMV on twice the bytes (the one-path design
// before this one: 9.1-9.5 us); the head in 58.9 us on the ring (2.2 TB/s,
// 67% of the roofline; bf16 cuBLAS 81.1 us; before: 75.8 us).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace miotts_async;

constexpr int kQBlock = 32;
constexpr int kThreads = 256;
constexpr int kTN = 128;              // columns of a ring block
constexpr int kStages = 8;            // cp.async ring depth, in Q8_0 blocks
constexpr int kRingBytes = kStages * (kQBlock * kTN + 4 * kTN);
constexpr int kMaxCluster = 16;       // > 8 needs the non-portable attribute
constexpr int kMaxSmem = 227 * 1024;  // opt-in shared memory of one block on sm_90

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared bytes of one block (ops/cuda/q8_matmul.py smem_bytes): the ring,
// the raw x tile, the bf16-rounded x tile, the row groups' sums, and the
// slices of the cluster's partials this block receives.
__host__ inline size_t smem_bytes(int tt, int per, int x_bytes) {
  const size_t span = (size_t)per * kQBlock;
  return (size_t)kRingBytes + align16((size_t)tt * span * x_bytes) +
         4 * ((size_t)tt * span + 1024 * (size_t)tt + (size_t)tt * kTN + kMaxCluster);
}

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

// Split cluster barrier: arrive, later wait. The first arrival is relaxed
// (it only marks this block as started); the second releases this
// thread's distributed-shared-memory stores, and its wait acquires the
// others'.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a copy of `vec` (16 or 4) bytes, zero-filled past `valid` (0 or vec)
__device__ __forceinline__ void copy_async(void* dst, const void* src, int valid, int vec) {
  if (vec == 16)
    cp_async16(dst, src, valid);
  else
    cp_async4(dst, src, valid);
}

// The ring path: grid (ceil(N / 128), ceil(T / TT), Z) in clusters of
// (1, 1, Z); block (bx, by, bz) sums the Q8_0 blocks [bz * per, bz * per +
// per) for rows [by * TT, by * TT + TT) and columns [bx * 128, +128). xvec and qvec
// are the copy widths of x and q (16 when the rows are 16-byte aligned,
// else 4).
template <int TT, bool XF32>
__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, float* __restrict__ out, int T, int K, int N,
                 int per, int xvec, int qvec) {
  constexpr int TN = kTN;
  constexpr int kCG = TN / 4;             // column groups of 4
  constexpr int kRG = kThreads / kCG;     // row groups
  constexpr int kRows = kQBlock / kRG;    // rows of a Q8_0 block a thread takes
  constexpr int kXB = XF32 ? 4 : 2;       // bytes of one x value
  extern __shared__ __align__(16) unsigned char smem[];
  const int span = per * kQBlock;
  int8_t* qs = reinterpret_cast<int8_t*>(smem);                             // [kStages][32][TN]
  float* ss = reinterpret_cast<float*>(smem + kStages * kQBlock * TN);      // [kStages][TN]
  unsigned char* xr = smem + kRingBytes;                                    // [TT][span] raw
  float* xs = reinterpret_cast<float*>(xr + align16((size_t)TT * span * kXB));  // [TT][span]
  float* red = xs + TT * span;                                              // [kRG][TT][TN]
  float* recv = red + kRG * TT * TN;  // [Z][slice]: the cluster's partials of this block's slice

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN, t0 = blockIdx.y * TT;
  const int kb0 = blockIdx.z * per;
  const int nb = min(per, K / kQBlock - kb0);  // >= 1: the plan leaves no split empty
  const int Z = gridDim.z;
  if (Z > 1) cluster_arrive_relaxed();  // waited for before the first remote store

  auto stage = [&](int i) {  // Q8_0 block kb0 + i into ring slot i % kStages
    const int slot = i % kStages;
    int8_t* dq = qs + slot * kQBlock * TN;
    const int8_t* gq = q + (int64_t)(kb0 + i) * kQBlock * N + n0;
    const int lpr = qvec == 16 ? __ffs(TN / 16) - 1 : __ffs(TN / 4) - 1;  // log2 copies a row
    for (int c = tid; c < kQBlock << lpr; c += kThreads) {
      const int r = c >> lpr, col = (c & ((1 << lpr) - 1)) * qvec;
      const bool ok = n0 + col < N;
      copy_async(dq + r * TN + col, ok ? gq + (int64_t)r * N + col : q, ok ? qvec : 0, qvec);
    }
    const float* gs = s + (int64_t)(kb0 + i) * N + n0;
    for (int c = tid; c < TN / 4; c += kThreads) {
      const bool ok = n0 + 4 * c < N;
      cp_async16(ss + slot * TN + 4 * c, ok ? gs + 4 * c : s, ok ? 16 : 0);
    }
  };

  {  // the x tile rows [t0, t0 + TT) x [kb0 * 32, +nb * 32), zero past T
    const int row_bytes = nb * kQBlock * kXB;
    const int per_row = row_bytes / xvec;
    const unsigned char* xb = static_cast<const unsigned char*>(x);
    for (int c = tid; c < TT * per_row; c += kThreads) {
      const int t = c / per_row, off = (c - t * per_row) * xvec;
      const bool ok = t0 + t < T;
      copy_async(xr + t * span * kXB + off,
                 ok ? xb + ((int64_t)(t0 + t) * K + kb0 * kQBlock) * kXB + off : xb,
                 ok ? xvec : 0, xvec);
    }
  }
  stage(0);
  cp_async_commit();
#pragma unroll 1
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < nb) stage(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // x and stage 0 have arrived
  __syncthreads();
  for (int i = tid; i < TT * span; i += kThreads) {
    if (XF32)
      xs[i] = bf16_round(reinterpret_cast<const float*>(xr)[i]);
    else
      xs[i] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(xr)[i]);
  }

  const int cgi = tid % kCG, rg = tid / kCG;
  float acc[TT][4];
#pragma unroll
  for (int t = 0; t < TT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int i = 0; i < nb; ++i) {
    cp_async_wait<kStages - 2>();  // stage i has arrived (this thread's copies)
    __syncthreads();               // ... and every thread's; slot (i - 1) is free
    if (i + kStages - 1 < nb) stage(i + kStages - 1);
    cp_async_commit();
    const int slot = i % kStages;
    const float4 sc = *reinterpret_cast<const float4*>(ss + slot * TN + 4 * cgi);
    const int8_t* qt = qs + slot * kQBlock * TN + 4 * cgi;
    const float* xk = xs + i * kQBlock + rg * kRows;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float f[4];
      int8x4_to_float(*reinterpret_cast<const uint32_t*>(qt + (rg * kRows + rr) * TN), f);
      const float2 w01 = __bfloat1622float2(__floats2bfloat162_rn(f[0] * sc.x, f[1] * sc.y));
      const float2 w23 = __bfloat1622float2(__floats2bfloat162_rn(f[2] * sc.z, f[3] * sc.w));
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float xv = xk[t * span + rr];
        acc[t][0] = fmaf(xv, w01.x, acc[t][0]);
        acc[t][1] = fmaf(xv, w01.y, acc[t][1]);
        acc[t][2] = fmaf(xv, w23.x, acc[t][2]);
        acc[t][3] = fmaf(xv, w23.y, acc[t][3]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain

#pragma unroll
  for (int t = 0; t < TT; ++t)
    *reinterpret_cast<float4*>(red + (rg * TT + t) * TN + 4 * cgi) =
        make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  __syncthreads();
  // this block's partial: the row groups' sums in order 0, 1, ... With K
  // split, element i goes to the rank that owns its slice, as row `rank` of
  // that block's recv, by a store to distributed shared memory.
  const int slice = (TT * TN + Z - 1) / Z;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = Z == 1 ? 0 : (int)cluster.block_rank();
  if (Z > 1) cluster_wait();  // every block of the cluster has started
  for (int i = tid; i < TT * TN; i += kThreads) {
    float sum = 0.f;
#pragma unroll 8
    for (int g = 0; g < kRG; ++g) sum += red[g * TT * TN + i];
    if (Z == 1) {
      const int t = i / TN, n = n0 + i - t * TN;
      if (t0 + t < T && n < N) out[(int64_t)(t0 + t) * N + n] = sum;
    } else {
      const int owner = i / slice;
      cluster.map_shared_rank(recv, owner)[rank * slice + i - owner * slice] = sum;
    }
  }
  if (Z == 1) return;

  // the cluster barrier (release/acquire): every partial has arrived, and
  // no block touches another's shared memory after it. Rank r sums its
  // slice over ranks 0, 1, ... in order.
  cluster_arrive();
  cluster_wait();
  const int i0 = rank * slice, i1 = min(TT * TN, i0 + slice);
  for (int i = i0 + tid; i < i1; i += kThreads) {
    float sum = 0.f;
    for (int z = 0; z < Z; ++z) sum += recv[z * slice + i - i0];
    const int t = i / TN, n = n0 + i - t * TN;
    if (t0 + t < T && n < N) out[(int64_t)(t0 + t) * N + n] = sum;
  }
}

// The decode path (T <= 8, a layer leaf): a GEMV in one launch, no
// cluster. grid (ceil(N / 16), ceil(T / TT)); block (bx, by) owns 16
// columns, rows [by * TT, +TT) of x and the whole K range. Thread l (of
// 256) takes runs of 4 consecutive rows of one Q8_0 block, k = 4 l + 1024 m:
// for each run one float4 x4 of scales, and for each row one 16-byte load
// of q (16 columns) and TT values of x, all requested before any is used.
// The 256 row lanes' sums meet in a fixed order through shared memory: 16
// groups of 16 lanes, then the groups (warp shuffles were slower, PERF.md).
constexpr int kRun = 4;  // rows of one Q8_0 block a thread takes at a time

template <int TT, bool XF32>
__global__ void __launch_bounds__(kThreads)
q8_gemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, float* __restrict__ out, int T, int K, int N) {
  __shared__ float tr[kThreads][17];  // a row lane's 16 sums (padded against bank conflicts)
  __shared__ float grp[16][16];       // a group of 16 lanes' sums
  const int tid = threadIdx.x;
  const int n = blockIdx.x * 16;
  const int t0 = blockIdx.y * TT;
  float acc[TT][16];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[t][c] = 0.f;
  for (int k0 = tid * kRun; k0 < K; k0 += kThreads * kRun) {
    float4 sc[4];
    uint4 w[kRun];
    float xv[kRun][TT];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sc[c] = __ldg(reinterpret_cast<const float4*>(s + (int64_t)(k0 / kQBlock) * N + n + 4 * c));
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      w[r] = __ldg(reinterpret_cast<const uint4*>(q + (int64_t)(k0 + r) * N + n));
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const int64_t xi = (int64_t)(t0 + t) * K + k0 + r;
        xv[r][t] = t0 + t >= T ? 0.f
                   : XF32 ? bf16_round(__ldg(static_cast<const float*>(x) + xi))
                          : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[xi]);
      }
    }
    const float* scf = reinterpret_cast<const float*>(sc);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const uint32_t ww[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        float f[4];
        int8x4_to_float(ww[qd], f);
        const float2 a = __bfloat1622float2(
            __floats2bfloat162_rn(f[0] * scf[4 * qd], f[1] * scf[4 * qd + 1]));
        const float2 b = __bfloat1622float2(
            __floats2bfloat162_rn(f[2] * scf[4 * qd + 2], f[3] * scf[4 * qd + 3]));
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          acc[t][4 * qd + 0] = fmaf(xv[r][t], a.x, acc[t][4 * qd + 0]);
          acc[t][4 * qd + 1] = fmaf(xv[r][t], a.y, acc[t][4 * qd + 1]);
          acc[t][4 * qd + 2] = fmaf(xv[r][t], b.x, acc[t][4 * qd + 2]);
          acc[t][4 * qd + 3] = fmaf(xv[r][t], b.y, acc[t][4 * qd + 3]);
        }
      }
    }
  }
  // the 256 row lanes' sums, one row of x at a time, through shared
  // memory: 16 groups of 16 lanes, then the 16 groups, each in order
#pragma unroll
  for (int t = 0; t < TT; ++t) {
#pragma unroll
    for (int c = 0; c < 16; ++c) tr[tid][c] = acc[t][c];
    __syncthreads();
    {
      const int c = tid & 15, gi = tid >> 4;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) sum += tr[gi * 16 + j][c];
      grp[gi][c] = sum;
    }
    __syncthreads();
    if (tid < 16 && t0 + t < T) {
      float sum = 0.f;
#pragma unroll
      for (int gi = 0; gi < 16; ++gi) sum += grp[gi][tid];
      out[(int64_t)(t0 + t) * N + n + tid] = sum;
    }
  }
}

template <int TT, bool XF32>
cudaError_t launch_gemv(const void* x, const int8_t* q, const float* s, float* out, int T, int K,
                        int N, cudaStream_t stream) {
  const dim3 grid(N / 16, (T + TT - 1) / TT);
  q8_gemv_kernel<TT, XF32><<<grid, kThreads, 0, stream>>>(x, q, s, out, T, K, N);
  return cudaGetLastError();
}

template <int TT, bool XF32>
cudaError_t launch(const void* x, const int8_t* q, const float* s, float* out, int T, int K, int N,
                   int z, int per, int xvec, int qvec, size_t smem, cudaStream_t stream) {
  auto kern = q8_matmul_kernel<TT, XF32>;
  static size_t allowed = 48 * 1024;  // raised once for each larger size seen
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  if (z > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTN - 1) / kTN, (T + TT - 1) / TT, z);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, q, s, out, T, K, N, per, xvec, qvec);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x [T, K] (bf16, or f32 when x_f32 != 0), q [K, N] int8, s [K/32, N] f32,
// out [T, N] f32; all contiguous, x and q 4-byte and s 16-byte aligned.
// The ring path's plan (ops/cuda/q8_matmul.py launch_shape): row tile tt
// in {1, 2, 4, 8}, z K splits of `per` Q8_0 blocks each (one cluster, none
// empty, z <= 16). Requires K % 32 == 0 and N % 4 == 0.
// Launches once on `stream` and returns the CUDA error of the launch (0 on
// success); a plan whose shared memory exceeds 227 KB fails here.
extern "C" int miotts_q8_matmul(const void* x, int x_f32, const void* q, const void* s, void* out,
                                int T, int K, int N, int tt, int z, int per, void* stream) {
  const int nkb = K / kQBlock;
  if (T < 1 || K < kQBlock || K % kQBlock || N < 4 || N % 4 || z < 1 || z > kMaxCluster ||
      per < 1 || (z - 1) * per >= nkb || z * per < nkb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(tt, per, x_f32 ? 4 : 2);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 ? 4 : 16;
  const int qvec = (reinterpret_cast<uintptr_t>(q) % 16 || N % 16) ? 4 : 16;
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(s);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tt * 2 + (x_f32 ? 1 : 0)) {
    case 2: return (int)launch<1, false>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 3: return (int)launch<1, true>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 4: return (int)launch<2, false>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 5: return (int)launch<2, true>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 8: return (int)launch<4, false>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 9: return (int)launch<4, true>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 16: return (int)launch<8, false>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    case 17: return (int)launch<8, true>(x, qp, sp, op, T, K, N, z, per, xvec, qvec, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The decode path (the plan's kind 1): x [T, K] with T <= tt, tt in {1, 2,
// 4, 8}; N % 16 == 0, q and s 16-byte aligned; operands otherwise as
// miotts_q8_matmul. One launch, no cluster.
extern "C" int miotts_q8_gemv(const void* x, int x_f32, const void* q, const void* s, void* out,
                              int T, int K, int N, int tt, void* stream) {
  if (T < 1 || T > tt || K < kQBlock || K % kQBlock || N < 16 || N % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(s) % 16)
    return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(s);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tt * 2 + (x_f32 ? 1 : 0)) {
    case 2: return (int)launch_gemv<1, false>(x, qp, sp, op, T, K, N, st);
    case 3: return (int)launch_gemv<1, true>(x, qp, sp, op, T, K, N, st);
    case 4: return (int)launch_gemv<2, false>(x, qp, sp, op, T, K, N, st);
    case 5: return (int)launch_gemv<2, true>(x, qp, sp, op, T, K, N, st);
    case 8: return (int)launch_gemv<4, false>(x, qp, sp, op, T, K, N, st);
    case 9: return (int)launch_gemv<4, true>(x, qp, sp, op, T, K, N, st);
    case 16: return (int)launch_gemv<8, false>(x, qp, sp, op, T, K, N, st);
    case 17: return (int)launch_gemv<8, true>(x, qp, sp, op, T, K, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
