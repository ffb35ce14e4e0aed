// B7: left-right cross-check labels and occlusion hits.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/postkern.py
// `_dcc_kernel_xm` (reached via `dcc_occl_kern`), in its two modes:
//   hits   (dibr_occl): hit_r[j] = any x with clamp(x + trunc(dl(x))) == j,
//                       hit_l[j] = any x with clamp(x - trunc(dr(x))) == j;
//   labels (dr_dcc):    mm_l(x) = |dl(x) - dr(clamp(x + trunc(dl(x))))|
//                       > thresh (mm_r likewise with x - trunc(dr(x)));
//                       label = mm ? (hit ? 1 : 2) : 0.
// Disparities truncate toward zero; every lookup column clamps into the
// row, so a writer past the border lands on the edge column.
//
// Bound on the H100: memory, and little of it (two 8.3 MB float planes
// in, two 2 MB u8 planes out at 1080p: ~6 us).  Design: the TPU kernel
// loops over the block's disparity values because it cannot scatter; here
// one block takes one row, scatters both eyes' hits into shared memory
// (a store of 1 is idempotent, so colliding writers need no atomics),
// then reads the row back for the labels.

#include "stm_common.cuh"

#define DCC_THREADS 256

__device__ __forceinline__ int clamp_col(long long v, int W) {
  return (int)(v < 0 ? 0 : v > W - 1 ? W - 1 : v);
}

template <bool LABELS>
__global__ void __launch_bounds__(DCC_THREADS)
dcc_row_kernel(const float* __restrict__ dl, const float* __restrict__ dr,
               uint8_t* __restrict__ out_l, uint8_t* __restrict__ out_r,
               int W, float thresh) {
  extern __shared__ uint8_t hit[];            // hit_l[W], hit_r[W]
  uint8_t* hit_l = hit;
  uint8_t* hit_r = hit + W;
  const size_t row = (size_t)blockIdx.x * W;
  const float* rl = dl + row;
  const float* rr = dr + row;
  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) hit[i] = 0;
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    hit_r[clamp_col(x + (long long)rl[x], W)] = 1;
    hit_l[clamp_col(x - (long long)rr[x], W)] = 1;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    if (!LABELS) {
      out_l[row + x] = hit_l[x];
      out_r[row + x] = hit_r[x];
    } else {
      const float a = rl[x];
      const float b = rr[x];
      const bool mm_l = fabsf(a - rr[clamp_col(x + (long long)a, W)]) > thresh;
      const bool mm_r = fabsf(b - rl[clamp_col(x - (long long)b, W)]) > thresh;
      out_l[row + x] = mm_l ? (hit_l[x] ? 1 : 2) : 0;
      out_r[row + x] = mm_r ? (hit_r[x] ? 1 : 2) : 0;
    }
  }
}

// dl, dr: (H, W) f32; out_l, out_r: (H, W) u8.  labels != 0: dr_dcc
// labels; labels == 0: dibr_occl hits (thresh unused).
STM_API int stm_dcc(const void* dl, const void* dr, void* out_l, void* out_r,
                    int H, int W, float thresh, int labels, void* stream) {
  if (H <= 0 || W <= 0 || 2 * (size_t)W > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)W;
  cudaStream_t s = (cudaStream_t)stream;
  if (labels)
    dcc_row_kernel<true><<<H, DCC_THREADS, smem, s>>>(
        (const float*)dl, (const float*)dr, (uint8_t*)out_l, (uint8_t*)out_r,
        W, thresh);
  else
    dcc_row_kernel<false><<<H, DCC_THREADS, smem, s>>>(
        (const float*)dl, (const float*)dr, (uint8_t*)out_l, (uint8_t*)out_r,
        W, thresh);
  return (int)cudaGetLastError();
}
