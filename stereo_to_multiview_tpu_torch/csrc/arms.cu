// B1: cross-based support arms (UP, DOWN, LEFT, RIGHT).
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/postkern.py
// `_arms_kernel` (reached via `_arms_vertical` from `cross_arms_kern` and
// `cross_arms_kern_lr`; the TPU runs LEFT/RIGHT as UP/DOWN of the
// transposed image).
//
// For each pixel and direction, walk k = 1..usd:
//   arm += [pixel k lies in the image and no color test failed at j < k]
// A step fails within lsd when max_c |I(k) - I(0)| > lcd or
// max_c |I(k) - I(k-1)| > lcd, beyond lsd when max_c |I(k) - I(0)| > ucd
// (compared in float32).  The arm is written before the color test, a
// quirk of the reference kept here: a color failure at distance k gives
// arm k, the border at distance k gives k - 1.
//
// Bound on the H100: at 1080p the kernel reads 6 MB and writes 33 MB
// (~12 us at 3.35 TB/s); the walk costs at most 4 x 34 steps of ~16
// integer operations a pixel (~4.5 G, ~67 us at the float32 rate), so
// operations bound it.  Design: one thread per (pixel, direction) walks
// only as far as the first failure or the border, so the work is what
// the content needs; neighbouring threads are neighbouring x, so both the
// vertical and the horizontal walks read consecutive pixels (L1 serves
// the reuse between threads).

#include "stm_common.cuh"

#define ARMS_THREADS 128

__device__ __forceinline__ int maxdiff3(const uint8_t* a, const uint8_t* b) {
  return max(max(abs((int)a[0] - (int)b[0]), abs((int)a[1] - (int)b[1])),
             abs((int)a[2] - (int)b[2]));
}

__global__ void __launch_bounds__(ARMS_THREADS)
cross_arms_kernel(const uint8_t* __restrict__ img, int* __restrict__ arms,
                  int H, int W, float ucd, float lcd, int usd, int lsd) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int dir = blockIdx.z;                 // 0 UP, 1 DOWN, 2 LEFT, 3 RIGHT
  if (x >= W) return;
  const int border = dir == 0 ? y : dir == 1 ? H - 1 - y
                   : dir == 2 ? x : W - 1 - x;
  const long long step =
      3LL * (dir == 0 ? -(long long)W : dir == 1 ? (long long)W
             : dir == 2 ? -1 : 1);
  const uint8_t* anchor = img + ((size_t)y * W + x) * 3;
  const uint8_t* prev = anchor;
  const int kmax = min(usd, border);
  int arm = 0;
  for (int k = 1; k <= kmax; ++k) {
    arm = k;                                  // in the image, alive before k
    const uint8_t* cur = anchor + step * k;
    const float ac = (float)maxdiff3(cur, anchor);
    const bool fail = k <= lsd
        ? (ac > lcd || (float)maxdiff3(cur, prev) > lcd)
        : ac > ucd;
    if (fail) break;
    prev = cur;
  }
  arms[((size_t)dir * H + y) * W + x] = arm;
}

// img: (H, W, 3) u8 contiguous; arms: (4, H, W) i32.
STM_API int stm_cross_arms(const void* img, void* arms, int H, int W,
                           float ucd, float lcd, int usd, int lsd,
                           void* stream) {
  if (H <= 0 || W <= 0 || usd < 0 || lsd < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + ARMS_THREADS - 1) / ARMS_THREADS, H, 4);
  cross_arms_kernel<<<grid, ARMS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (int*)arms, H, W, ucd, lcd, usd, lsd);
  return (int)cudaGetLastError();
}
