// A kernel's dynamic shared-memory limit, raised on the device it launches
// on. cudaFuncSetAttribute applies to the current device only, so each
// kernel keeps the limit it has set for each device: a process that
// launches on several cards (a mesh's ranks on distinct devices) raises it
// on each. Used by K1 (banded_attention.cu), K2 (decode_attention.cu), K3
// (q8_matmul.cu), K4 (conv1d.cu) and K6 (resblock.cu).

#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

namespace miotts_smem {

constexpr int kMaxDevices = 64;

// Raises `kern`'s limit on the current device to `smem` bytes where
// `allowed` (this kernel's limit for each device, 0 before the first
// launch there) is below it.
template <typename Kern>
inline cudaError_t raise_limit(Kern kern, size_t smem, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& limit = allowed[dev];
  if (limit == 0) limit = 48 * 1024;  // the limit without the attribute
  if (smem > limit) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    limit = smem;
  }
  return cudaSuccess;
}

}  // namespace miotts_smem
