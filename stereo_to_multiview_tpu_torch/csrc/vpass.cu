// B5: the two vertical passes of the cross aggregation (passes 2 and 3).
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py `_vv_kernel`
// (reached via `_band_pass_vv` from `band_aggregate_q`): pass 2 sums the
// int32 pass-1 volume over [y - UP, y + DOWN) and rescales by s2; pass 3
// does the same to pass 2's result and rescales by s3.  The order of the
// aggregation is H, V, V, H.
//
// Bound on the H100: memory.  Fused, the two passes would read and write
// 1.06 GB each per eye at 1080p/D=128 (~0.63 ms).  This first version
// runs the window-sum kernel twice with an int32 scratch volume between
// the launches, so it moves twice that.  Design: the same column-prefix
// scheme as the horizontal pass (window.cuh) with the line = one image
// column and pos = rows: a block takes 64 rows of one column, a warp
// reads 32 consecutive d of one pixel (128 contiguous bytes), so no
// transposed copy of the volume is needed.  Keeping pass 2's column strip
// in shared memory for pass 3 (one launch) is left for a later version.

#include "window.cuh"

#define VP_TILE 64

__global__ void vpass_kernel(const int32_t* __restrict__ in,
                             const int* __restrict__ an,
                             const int* __restrict__ ap,
                             int32_t* __restrict__ out, int H, int W, int D,
                             int reach, int shift) {
  extern __shared__ int32_t smem[];
  const long long wd = (long long)W * D;
  window_pass<int32_t, false>(in, Strides{D, wd}, an, ap, Strides{1, W},
                              out, Strides{D, wd}, nullptr, Strides{0, 0},
                              H, D, reach, shift, 0, blockIdx.x,
                              blockIdx.y * VP_TILE, VP_TILE, smem,
                              smem + 2 * VP_TILE, nullptr, nullptr);
}

// in, scratch, out: (H, W, D) i32 contiguous; up/down (H, W) i32.
STM_API int stm_vv_pass(const void* in, const void* up, const void* down,
                        void* scratch, void* out, int H, int W, int D,
                        int reach, int s2, int s3, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || D > 1024 || reach < 0 || s2 < 0 ||
      s2 > 30 || s3 < 0 || s3 > 30)
    return (int)cudaErrorInvalidValue;
  const int threads = (D + 31) / 32 * 32;
  const size_t smem = window_smem(VP_TILE, reach, D, threads, false);
  cudaError_t err = stm_smem_cap(vpass_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(W, (H + VP_TILE - 1) / VP_TILE);
  cudaStream_t s = (cudaStream_t)stream;
  vpass_kernel<<<grid, threads, smem, s>>>(
      (const int32_t*)in, (const int*)up, (const int*)down,
      (int32_t*)scratch, H, W, D, reach, s2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpass_kernel<<<grid, threads, smem, s>>>(
      (const int32_t*)scratch, (const int*)up, (const int*)down,
      (int32_t*)out, H, W, D, reach, s3);
  return (int)cudaGetLastError();
}
