// B10: bilateral filter of a float32 disparity map.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/postkern.py
// `_bilat_kernel` (reached via `filter_bilateral_kern`).
//
// out = sum w * s / sum w over the (2r+1)^2 clamp-to-edge taps s, with
//   t = floor(|center - s|),  w = sk[dy][dx] * (exp(-(t * t) * inv_2var)
//   * lut_scale),
// taps in the TPU kernel's order (dx outer, dy inner).  Every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn: no contracted
// multiply-add) and the quotient is IEEE (__fdiv_rn), so the result is
// bit-equal to the plain PyTorch version, which evaluates the same
// expression one elementwise op at a time; it feeds trunc() in the
// occlusion test, where one ulp can move a pixel.
//
// Bound on the H100: operations.  At 1080p, r = 7: 8 MB in and out
// (~5 us), but 225 taps of ~10 float operations and one expf a pixel
// (~4.7 G, ~70 us at the float32 rate).  Design: one thread per pixel,
// the taps' spatial weights in shared memory, the neighbourhood read
// through L1 (neighbouring threads read neighbouring columns).

#include "stm_common.cuh"

#define BILAT_MAX_R 8
#define BILAT_TX 32
#define BILAT_TY 8

struct BilatTaps {
  float w[(2 * BILAT_MAX_R + 1) * (2 * BILAT_MAX_R + 1)];
};

__global__ void __launch_bounds__(BILAT_TX * BILAT_TY)
bilateral_kernel(const float* __restrict__ in, float* __restrict__ out,
                 BilatTaps taps, int H, int W, int r, float inv_2var,
                 float lut_scale) {
  __shared__ float sk[sizeof(BilatTaps) / sizeof(float)];
  const int k = 2 * r + 1;
  const int tid = threadIdx.y * BILAT_TX + threadIdx.x;
  for (int i = tid; i < k * k; i += BILAT_TX * BILAT_TY) sk[i] = taps.w[i];
  __syncthreads();
  const int x = blockIdx.x * BILAT_TX + threadIdx.x;
  const int y = blockIdx.y * BILAT_TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const float a = in[(size_t)y * W + x];
  float num = 0.0f, den = 0.0f;
  for (int dx = -r; dx <= r; ++dx) {
    const int xs = min(max(x + dx, 0), W - 1);
    for (int dy = -r; dy <= r; ++dy) {
      const int ys = min(max(y + dy, 0), H - 1);
      const float s = in[(size_t)ys * W + xs];
      const float t = floorf(fabsf(__fsub_rn(a, s)));
      const float rw =
          __fmul_rn(expf(__fmul_rn(-__fmul_rn(t, t), inv_2var)), lut_scale);
      const float wgt = __fmul_rn(sk[(dy + r) * k + (dx + r)], rw);
      num = __fadd_rn(num, __fmul_rn(wgt, s));
      den = __fadd_rn(den, wgt);
    }
  }
  out[(size_t)y * W + x] = __fdiv_rn(num, den);
}

// in, out: (H, W) f32; sk: host array of the (2r+1)^2 spatial weights
// (row dy, column dx), r <= 8.
STM_API int stm_bilateral(const void* in, void* out, const float* sk, int H,
                          int W, int r, float inv_2var, float lut_scale,
                          void* stream) {
  if (H <= 0 || W <= 0 || r < 0 || r > BILAT_MAX_R || sk == nullptr)
    return (int)cudaErrorInvalidValue;
  BilatTaps taps;
  for (int i = 0; i < (2 * r + 1) * (2 * r + 1); ++i) taps.w[i] = sk[i];
  dim3 block(BILAT_TX, BILAT_TY);
  dim3 grid((W + BILAT_TX - 1) / BILAT_TX, (H + BILAT_TY - 1) / BILAT_TY);
  bilateral_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, taps, H, W, r, inv_2var, lut_scale);
  return (int)cudaGetLastError();
}
