// G2: the rescales of the low-resolution disparity route
// (`process_frame_lowres`): both eyes' u8 images scaled down bilinearly
// in one launch (the upstream's `tx_scale_bilinear_kernel`,
// d_tx_scale.cu:30-52), and both eyes' float32 disparities scaled back up
// and multiplied by 1 / disp_scale in one launch (`tx_disp_scale_kernel`,
// d_tx_scale.cu:8-27).
//
// Replaces the JAX package's XLA glue stereo_to_multiview_tpu/ops/
// scale.py:76 `tx_scale_bilinear` and :91 `tx_disp_scale` (no Pallas
// body: on the TPU two matmuls with mostly-zero weight matrices), which
// the port ran as ~14 torch launches and 6 host-to-device tap copies an
// eye and direction (`ops/scale.lerp_axis`).
//
// The plain versions' arithmetic, to the last bit: an axis' sample of
// output i is s = clamp(i / n_out * n_in, 0, n_in - 1) in float32 (IEEE
// division, then multiply), its taps floor(s) and floor(s) + 1 (clamped
// to n_in - 1) with the weight w = s - floor(s); x first, then y, each
// lerp a0 * (1 - w) + a1 * w with every product and sum rounded on its
// own (__fmul_rn / __fadd_rn: nvcc would contract them); a u8 output
// truncated, a disparity times the float32 scale.  Where the input
// already has the output's shape both axes are skipped (the plain
// versions' identity).  The taps are computed here from the indices, so
// no tap array is copied to the device.
//
// Bound on the H100, bytes: at 1080p down, 12.4 MB read and 3.1 MB
// written; up, 4.1 MB read and 16.6 MB written: 0.0108 ms a frame at
// 3.35 TB/s.  Design: one thread an output pixel (its channels
// unrolled), a block 256 pixels of one output row, the eye from blockIdx.z;
// a warp's four samples a channel fall into two input rows a few cache
// lines wide, and its stores are consecutive.

#include "stm_common.cuh"

#define SCALE_THREADS 256

struct ScaleTap {
  int i0, i1;
  float w;
};

// The taps of output index i on an axis of n_in inputs and n_out outputs.
__device__ __forceinline__ ScaleTap scale_tap(int i, int n_out, int n_in) {
  float s = __fmul_rn(__fdiv_rn((float)i, (float)n_out), (float)n_in);
  s = fminf(fmaxf(s, 0.0f), (float)(n_in - 1));
  const float f = floorf(s);
  ScaleTap t;
  t.i0 = (int)f;
  t.i1 = min(t.i0 + 1, n_in - 1);
  t.w = __fsub_rn(s, f);
  return t;
}

__device__ __forceinline__ float scale_lerp(float a0, float a1, float w) {
  return __fadd_rn(__fmul_rn(a0, __fsub_rn(1.0f, w)), __fmul_rn(a1, w));
}

__device__ __forceinline__ float scale_load(const uint8_t* p) {
  return (float)*p;
}

__device__ __forceinline__ float scale_load(const float* p) { return *p; }

// Output pixel (y, x) of one eye, C channels: the bilinear sample of
// src (H, W, C), C <= 4, at the taps of y and x, or src's own pixel
// where `ident`; the channel loops unrolled, so v stays in registers.
template <typename T>
__device__ __forceinline__ void scale_pixel(const T* __restrict__ src,
                                            int H, int W, int C,
                                            int Ho, int Wo, int y, int x,
                                            bool ident, float (&v)[4]) {
  if (ident) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < C) v[c] = scale_load(src + ((size_t)y * W + x) * C + c);
    return;
  }
  const ScaleTap ty = scale_tap(y, Ho, H), tx = scale_tap(x, Wo, W);
  const T* r0 = src + (size_t)ty.i0 * W * C;
  const T* r1 = src + (size_t)ty.i1 * W * C;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= C) break;
    const float top = scale_lerp(scale_load(r0 + (size_t)tx.i0 * C + c),
                                 scale_load(r0 + (size_t)tx.i1 * C + c),
                                 tx.w);
    const float bottom = scale_lerp(scale_load(r1 + (size_t)tx.i0 * C + c),
                                    scale_load(r1 + (size_t)tx.i1 * C + c),
                                    tx.w);
    v[c] = scale_lerp(top, bottom, ty.w);
  }
}

// The images, (H, W, C) u8 an eye, C <= 4 -> (Ho, Wo, C) u8.
__global__ void __launch_bounds__(SCALE_THREADS)
tx_scale_bilinear_kernel(const uint8_t* __restrict__ src_l,
                         const uint8_t* __restrict__ src_r,
                         uint8_t* __restrict__ dst_l,
                         uint8_t* __restrict__ dst_r, int H, int W, int C,
                         int Ho, int Wo, bool ident) {
  const int x = blockIdx.x * SCALE_THREADS + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= Wo) return;
  const bool right = blockIdx.z != 0;
  float v[4];
  scale_pixel(right ? src_r : src_l, H, W, C, Ho, Wo, y, x, ident, v);
  uint8_t* out = (right ? dst_r : dst_l) + ((size_t)y * Wo + x) * C;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < C) out[c] = (uint8_t)__float2uint_rz(v[c]);
}

// The disparities, (H, W) float32 an eye -> (Ho, Wo) float32 times scale.
__global__ void __launch_bounds__(SCALE_THREADS)
tx_disp_scale_kernel(const float* __restrict__ src_l,
                     const float* __restrict__ src_r,
                     float* __restrict__ dst_l, float* __restrict__ dst_r,
                     int H, int W, int Ho, int Wo, float scale, bool ident) {
  const int x = blockIdx.x * SCALE_THREADS + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= Wo) return;
  const bool right = blockIdx.z != 0;
  float v[4];
  scale_pixel(right ? src_r : src_l, H, W, 1, Ho, Wo, y, x, ident, v);
  (right ? dst_r : dst_l)[(size_t)y * Wo + x] = __fmul_rn(v[0], scale);
}

static bool scale_shape_ok(int H, int W, int Ho, int Wo) {
  return H > 0 && W > 0 && Ho > 0 && Wo > 0 && Ho <= 65535;
}

// src_*: (H, W, C) u8, dst_*: (Ho, Wo, C) u8, both eyes in one launch.
STM_API int stm_tx_scale_u8(const void* src_l, const void* src_r,
                            void* dst_l, void* dst_r, int H, int W, int C,
                            int Ho, int Wo, void* stream) {
  if (!scale_shape_ok(H, W, Ho, Wo) || C < 1 || C > 4)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Wo + SCALE_THREADS - 1) / SCALE_THREADS, Ho, 2);
  tx_scale_bilinear_kernel<<<grid, SCALE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src_l, (const uint8_t*)src_r, (uint8_t*)dst_l,
      (uint8_t*)dst_r, H, W, C, Ho, Wo, H == Ho && W == Wo);
  return (int)cudaGetLastError();
}

// src_*: (H, W) f32, dst_*: (Ho, Wo) f32, both eyes in one launch; scale:
// the float32 factor the resampled values are multiplied by.
STM_API int stm_tx_disp_scale(const void* src_l, const void* src_r,
                              void* dst_l, void* dst_r, int H, int W, int Ho,
                              int Wo, float scale, void* stream) {
  if (!scale_shape_ok(H, W, Ho, Wo)) return (int)cudaErrorInvalidValue;
  dim3 grid((Wo + SCALE_THREADS - 1) / SCALE_THREADS, Ho, 2);
  tx_disp_scale_kernel<<<grid, SCALE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src_l, (const float*)src_r, (float*)dst_l, (float*)dst_r,
      H, W, Ho, Wo, scale, H == Ho && W == Wo);
  return (int)cudaGetLastError();
}
