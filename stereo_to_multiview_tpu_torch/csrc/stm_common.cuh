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

// Four consecutive values of T (u8, int16 or float32) stored as one
// aligned word of 4, 8 or 16 bytes.
template <typename T> struct StmVec4;
template <> struct StmVec4<uint8_t> { typedef uchar4 V; };
template <> struct StmVec4<int16_t> { typedef short4 V; };
template <> struct StmVec4<float> { typedef float4 V; };

template <typename T>
__device__ __forceinline__ void stm_store4(T* dst, const T (&v)[4]) {
  typename StmVec4<T>::V q;
  q.x = v[0];
  q.y = v[1];
  q.z = v[2];
  q.w = v[3];
  *reinterpret_cast<typename StmVec4<T>::V*>(dst) = q;
}

// Asynchronous copies from device memory into shared memory (cp.async):
// a thread issues them, groups them with stm_cp_commit(), and
// stm_cp_wait<N>() returns once at most N of its latest groups are still
// in flight.  The copied bytes are then visible to the issuing thread;
// other threads need a barrier as well.
__device__ __forceinline__ unsigned stm_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void stm_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   stm_smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void stm_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   stm_smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void stm_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void stm_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
