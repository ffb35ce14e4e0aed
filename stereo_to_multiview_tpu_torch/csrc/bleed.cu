// B11: bleed filter of an occlusion map, fused with its conversion to a
// float mask.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/postkern.py
// `_bleed_kernel` (reached via `filter_bleed_mask_kern`).
//
// cnt = number of non-zero values in the (2r+1)^2 neighbourhood, read
// with the reference's edge rule (a negative coordinate mirrors, s -> -s;
// one past the end maps to n - 1 - offset);
// v = float(cnt) > thresh ? 1 : occl;  mask = (v == 1) ? 1.0f : 0.0f.
//
// Bound on the H100: memory (2 MB u8 in, 8 MB f32 out at 1080p: ~3 us).
// Design: one thread per pixel; the 3 x 3 neighbourhood (r = 1 on the
// main path) comes through L1, since neighbouring threads share it.

#include "stm_common.cuh"

#define BLEED_TX 128

__device__ __forceinline__ int bleed_index(int i, int off, int n) {
  int s = i + off;
  if (s < 0) s = -s;
  return s > n - 1 ? n - 1 - off : s;
}

__global__ void __launch_bounds__(BLEED_TX)
bleed_mask_kernel(const uint8_t* __restrict__ occl, float* __restrict__ mask,
                  int H, int W, int r, float thresh) {
  const int x = blockIdx.x * BLEED_TX + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  int cnt = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const uint8_t* row = occl + (size_t)bleed_index(y, dy, H) * W;
    for (int dx = -r; dx <= r; ++dx) cnt += row[bleed_index(x, dx, W)] > 0;
  }
  const uint8_t v = (float)cnt > thresh ? 1 : occl[(size_t)y * W + x];
  mask[(size_t)y * W + x] = v == 1 ? 1.0f : 0.0f;
}

// occl: (H, W) u8; mask: (H, W) f32; r < min(H, W).
STM_API int stm_bleed_mask(const void* occl, void* mask, int H, int W, int r,
                           float thresh, void* stream) {
  if (H <= 0 || W <= 0 || r < 0 || r >= H || r >= W)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + BLEED_TX - 1) / BLEED_TX, H);
  bleed_mask_kernel<<<grid, BLEED_TX, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)occl, (float*)mask, H, W, r, thresh);
  return (int)cudaGetLastError();
}
