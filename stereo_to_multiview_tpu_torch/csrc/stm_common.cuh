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

// Tensor copies from device memory into shared memory (the Tensor Memory
// Accelerator, `cp.async.bulk.tensor`) of a box of a tensor map (a
// CUtensorMap kernel parameter, made on the host): one thread arms an
// mbarrier with the bytes it expects (stm_bar_expect), then issues the
// copy, which completes on that barrier; every thread waits for the
// barrier's phase (stm_bar_wait) and then sees the bytes.  Box elements
// outside the tensor arrive as zeros and count as bytes.  No register or
// load instruction holds a copy in flight.
__device__ __forceinline__ void stm_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   stm_smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After stm_bar_init, before any thread or copy uses the barriers.
__device__ __forceinline__ void stm_bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses (and those a
// barrier made visible to it) against later tensor copies.
__device__ __forceinline__ void stm_async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void stm_bar_expect(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          stm_smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival on the barrier (release: this thread's earlier accesses
// happen before the phase completes for its waiters).
__device__ __forceinline__ void stm_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   stm_smem_addr(bar))
               : "memory");
}

// The box of a 3D tensor map at element coordinates (c0, c1, c2) into dst
// (128-byte aligned), completing on bar.
__device__ __forceinline__ void stm_tensor_load_3d(void* dst, const void* map,
                                                   int c0, int c1, int c2,
                                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(stm_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(stm_smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes from src into dst (both 16-byte aligned, bytes
// a multiple of 16) by a bulk copy (`cp.async.bulk`, no tensor map),
// completing on bar as stm_tensor_load_3d's copies do.
__device__ __forceinline__ void stm_bulk_load(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(stm_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(stm_smem_addr(bar))
      : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void stm_bar_wait(uint64_t* bar,
                                             unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(stm_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
