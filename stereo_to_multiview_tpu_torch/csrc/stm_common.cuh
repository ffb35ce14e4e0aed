// Shared definitions of the port's CUDA kernels (plain C interface,
// loaded with ctypes; every entry point returns cudaGetLastError()).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define STM_API extern "C" __attribute__((visibility("default")))

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the 48 KB default (Hopper allows up to 227 KB a block).
template <typename K>
static inline cudaError_t stm_smem_cap(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
