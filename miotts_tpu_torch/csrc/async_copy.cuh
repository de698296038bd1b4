// cp.async (Ampere and later): 16-byte copies from device to shared memory
// that run behind the issuing thread, grouped and waited for by group.
// Used by K2 (decode_attention.cu), K3 (q8_matmul.cu), K4 (conv1d.cu) and K6
// (resblock.cu, through conv_gemm.cuh).

#pragma once

#include <cuda_runtime.h>

namespace miotts_async {

// copy 16 bytes from gmem to smem, of which the first src_bytes are read
// and the rest zero-filled (src_bytes = 0 writes 16 zero bytes; gmem must
// still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// the same for 4 bytes (for sources only 4-byte aligned); src_bytes 0 or 4
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace miotts_async
