// B12: every intermediate view, warped from both eyes, masked and merged.
// B14: the same two warps of every view, floored, without mask and merge.
// B19/B20: B14's warps bounded to each view's static offset range.
//
// B12 replaces the TPU kernel stereo_to_multiview_tpu/ops/warpkern.py
// `_warp_merge_views_xm_kernel` (reached via
// `dibr_warp_merge_views_kern_xm`); B14 replaces `_warp_views_xm_kernel`
// (reached via `dibr_warp_views_kern_xm`), the unfused synthesis taken
// when the output resolution differs from the input's, bleed_radius != 1
// or there is no intermediate view to merge in the fused way.
//
// For view v with shifts sl = shifts_l[v] (= -shift), sr = shifts_r[v]
// (= 1 - shift):
//   from_l = warp(img_l, mask_r, disp_r, sl),  from_r = warp(img_r,
//   mask_l, disp_l, sr),
//   warp(I, M, D, s)(x) = u8(u8(w0 * I(x0) + w1 * I(x0 + 1)) * M(x)) with
//   c = clamp(x + D(x) * s, 0, W - 1), x0 = floor(c),
//   w0 = max(1 - |c - x0|, 0), w1 = max(1 - |c - (x0 + 1)|, 0), and the
//   second sample clamped to column W - 1;
//   out = u8(u8((1 - m) * from_l) + u8(m * from_r)), m = feathered.
// u8() truncates toward zero (through a 64-bit integer, as PyTorch's
// float -> uint8 cast does).  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn): the port follows the JAX package's unfused
// synthesis, whose lerp rounds both products, and not the TPU kernel's
// contracted multiply-add.
//
// Bound on the H100: memory, and little of it (at 1080p, 8 views: 12 MB
// of images and 41 MB of float planes in, 37 MB out, ~27 us).  Design:
// one thread per (view, pixel) computes both warps and the merge, so the
// float warp volumes of the unfused chain never reach device memory; the
// TPU kernel's loop over the block's disparity offsets (it cannot gather)
// becomes a direct read of the two samples.
//
// B14 writes those float volumes, because the unfused chain's mask
// multiply and merge follow it: va[v] = u8(lerp(img_l, disp_r, sl)) and
// vb[v] = u8(lerp(img_r, disp_l, sr)) as float32, (nv, H, W, 3) each.  Its
// bound is its output: 2 x 149 MB written at 1080p and 6 views against 28
// MB read (~0.1 ms).  Same design, one thread per (view, pixel); the
// sampling code is B12's own (`make_lerp`, `lerp_u8`), so the two cannot
// drift apart.
//
// The shifts (and B19's bounds) reach a kernel by value, WARP_MAX_VIEWS
// views at a time: an entry point takes any number of views and launches
// its kernel once for each group of at most that many.

#include "stm_common.cuh"

#define WARP_TX 128
#define WARP_MAX_VIEWS 32

struct WarpShifts {
  float l[WARP_MAX_VIEWS];
  float r[WARP_MAX_VIEWS];
};

__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)(long long)v;
}

// The per-pixel part of warp(I, M, D, s): the two weights, the two sample
// columns and the mask value; `lerp_u8` is the truncated lerp of one
// channel, `sample` the masked sample.
struct Lerp {
  float w0, w1, m;
  int i0, i1;
};

__device__ __forceinline__ Lerp make_lerp(int x, float d, float s, float m,
                                          int W) {
  float c = __fadd_rn((float)x, __fmul_rn(d, s));
  c = fminf(fmaxf(c, 0.0f), (float)(W - 1));
  const float x0 = floorf(c);
  Lerp l;
  l.w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, x0))), 0.0f);
  l.w1 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, __fadd_rn(x0, 1.0f)))),
               0.0f);
  l.i0 = (int)x0;
  l.i1 = min(l.i0 + 1, W - 1);
  l.m = m;
  return l;
}

__device__ __forceinline__ uint8_t lerp_u8(const uint8_t* row, const Lerp& l,
                                           int ch) {
  return to_u8(__fadd_rn(__fmul_rn(l.w0, (float)row[l.i0 * 3 + ch]),
                         __fmul_rn(l.w1, (float)row[l.i1 * 3 + ch])));
}

__device__ __forceinline__ uint8_t sample(const uint8_t* row, const Lerp& l,
                                          int ch) {
  return to_u8(__fmul_rn((float)lerp_u8(row, l, ch), l.m));
}

__global__ void __launch_bounds__(WARP_TX)
warp_merge_kernel(const uint8_t* __restrict__ img_l,
                  const uint8_t* __restrict__ img_r,
                  const float* __restrict__ disp_l,
                  const float* __restrict__ disp_r,
                  const float* __restrict__ mask_l,
                  const float* __restrict__ mask_r,
                  const float* __restrict__ feather, WarpShifts shifts,
                  uint8_t* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * WARP_TX + threadIdx.x;
  const int y = blockIdx.y;
  const int v = blockIdx.z;
  if (x >= W) return;
  const size_t i = (size_t)y * W + x;
  const Lerp from_l = make_lerp(x, disp_r[i], shifts.l[v], mask_r[i], W);
  const Lerp from_r = make_lerp(x, disp_l[i], shifts.r[v], mask_l[i], W);
  const float m = feather[i];
  const float m_b = __fsub_rn(1.0f, m);
  const uint8_t* row_l = img_l + (size_t)y * W * 3;
  const uint8_t* row_r = img_r + (size_t)y * W * 3;
  uint8_t* o = out + (((size_t)v * H + y) * W + x) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const uint8_t b = to_u8(__fmul_rn(m_b, (float)sample(row_l, from_l, ch)));
    const uint8_t a = to_u8(__fmul_rn(m, (float)sample(row_r, from_r, ch)));
    o[ch] = (uint8_t)(b + a);
  }
}

// img_l, img_r: (H, W, 3) u8; disp_*, mask_*, feather: (H, W) f32;
// shifts_l, shifts_r: host arrays of nv floats; out: (nv, H, W, 3) u8.
STM_API int stm_warp_merge(const void* img_l, const void* img_r,
                           const void* disp_l, const void* disp_r,
                           const void* mask_l, const void* mask_r,
                           const void* feather, const float* shifts_l,
                           const float* shifts_r, void* out, int H, int W,
                           int nv, void* stream) {
  if (H <= 0 || W <= 0 || nv <= 0 || shifts_l == nullptr ||
      shifts_r == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t view = (size_t)H * W * 3;
  for (int v0 = 0; v0 < nv; v0 += WARP_MAX_VIEWS) {
    const int n = min(nv - v0, WARP_MAX_VIEWS);
    WarpShifts s;
    for (int v = 0; v < n; ++v) {
      s.l[v] = shifts_l[v0 + v];
      s.r[v] = shifts_r[v0 + v];
    }
    dim3 grid((W + WARP_TX - 1) / WARP_TX, H, n);
    warp_merge_kernel<<<grid, WARP_TX, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img_l, (const uint8_t*)img_r, (const float*)disp_l,
        (const float*)disp_r, (const float*)mask_l, (const float*)mask_r,
        (const float*)feather, s, (uint8_t*)out + v0 * view, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

__global__ void __launch_bounds__(WARP_TX)
warp_views_kernel(const uint8_t* __restrict__ img_l,
                  const uint8_t* __restrict__ img_r,
                  const float* __restrict__ disp_l,
                  const float* __restrict__ disp_r, WarpShifts shifts,
                  float* __restrict__ va, float* __restrict__ vb, int H,
                  int W) {
  const int x = blockIdx.x * WARP_TX + threadIdx.x;
  const int y = blockIdx.y;
  const int v = blockIdx.z;
  if (x >= W) return;
  const size_t i = (size_t)y * W + x;
  const Lerp from_l = make_lerp(x, disp_r[i], shifts.l[v], 1.0f, W);
  const Lerp from_r = make_lerp(x, disp_l[i], shifts.r[v], 1.0f, W);
  const uint8_t* row_l = img_l + (size_t)y * W * 3;
  const uint8_t* row_r = img_r + (size_t)y * W * 3;
  const size_t o = (((size_t)v * H + y) * W + x) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    va[o + ch] = (float)lerp_u8(row_l, from_l, ch);
    vb[o + ch] = (float)lerp_u8(row_r, from_r, ch);
  }
}

// img_l, img_r: (H, W, 3) u8; disp_l, disp_r: (H, W) f32; shifts_l,
// shifts_r: host arrays of nv floats; va, vb: (nv, H, W, 3) f32.
STM_API int stm_warp_views(const void* img_l, const void* img_r,
                           const void* disp_l, const void* disp_r,
                           const float* shifts_l, const float* shifts_r,
                           void* va, void* vb, int H, int W, int nv,
                           void* stream) {
  if (H <= 0 || W <= 0 || nv <= 0 || shifts_l == nullptr ||
      shifts_r == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t view = (size_t)H * W * 3;
  for (int v0 = 0; v0 < nv; v0 += WARP_MAX_VIEWS) {
    const int n = min(nv - v0, WARP_MAX_VIEWS);
    WarpShifts s;
    for (int v = 0; v < n; ++v) {
      s.l[v] = shifts_l[v0 + v];
      s.r[v] = shifts_r[v0 + v];
    }
    dim3 grid((W + WARP_TX - 1) / WARP_TX, H, n);
    warp_views_kernel<<<grid, WARP_TX, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img_l, (const uint8_t*)img_r, (const float*)disp_l,
        (const float*)disp_r, s, (float*)va + v0 * view,
        (float*)vb + v0 * view, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// B19 replaces the TPU kernel stereo_to_multiview_tpu/ops/warpkern.py
// `_warp_views_kernel` (reached via `dibr_warp_views_kern`) and B20, the
// same entry with one view, `_warp_kernel` (via `dibr_warp_pair_kern`).
// Those kernels walk a static range of sample offsets [lo, hi] a view,
// lo/hi = floor/ceil of the disparity range [-zd, D - zd] times the shift,
// and select the one matching floor(c) - x: a pixel whose offset lies
// outside its view's range selects nothing and comes out 0.  So here:
// B14's value where lo <= floor(c) - x <= hi, else 0 (+0.0: the u8 sample
// times 0).  Same bound and design as B14 (one thread per view and pixel,
// the shared `make_lerp` / `lerp_u8`), the range test added.

struct WarpBounds {
  int lo_l[WARP_MAX_VIEWS], hi_l[WARP_MAX_VIEWS];
  int lo_r[WARP_MAX_VIEWS], hi_r[WARP_MAX_VIEWS];
};

__device__ __forceinline__ bool in_range(const Lerp& l, int x, int lo,
                                         int hi) {
  const int k = l.i0 - x;
  return k >= lo && k <= hi;
}

__global__ void __launch_bounds__(WARP_TX)
warp_views_bounded_kernel(const uint8_t* __restrict__ img_l,
                          const uint8_t* __restrict__ img_r,
                          const float* __restrict__ disp_l,
                          const float* __restrict__ disp_r,
                          WarpShifts shifts, WarpBounds b,
                          float* __restrict__ va, float* __restrict__ vb,
                          int H, int W) {
  const int x = blockIdx.x * WARP_TX + threadIdx.x;
  const int y = blockIdx.y;
  const int v = blockIdx.z;
  if (x >= W) return;
  const size_t i = (size_t)y * W + x;
  const Lerp from_l = make_lerp(x, disp_r[i], shifts.l[v], 1.0f, W);
  const Lerp from_r = make_lerp(x, disp_l[i], shifts.r[v], 1.0f, W);
  const bool keep_l = in_range(from_l, x, b.lo_l[v], b.hi_l[v]);
  const bool keep_r = in_range(from_r, x, b.lo_r[v], b.hi_r[v]);
  const uint8_t* row_l = img_l + (size_t)y * W * 3;
  const uint8_t* row_r = img_r + (size_t)y * W * 3;
  const size_t o = (((size_t)v * H + y) * W + x) * 3;
  // The samples are read whatever the range test says, as B14 reads them,
  // and a 0/1 factor masks them: reading them only where kept measured
  // 1.65x B14's time.
  const float m_l = keep_l ? 1.0f : 0.0f;
  const float m_r = keep_r ? 1.0f : 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    va[o + ch] = __fmul_rn((float)lerp_u8(row_l, from_l, ch), m_l);
    vb[o + ch] = __fmul_rn((float)lerp_u8(row_r, from_r, ch), m_r);
  }
}

// As stm_warp_views, plus bounds_l, bounds_r: host arrays of nv (lo, hi)
// int pairs, the offset range of each view's two warps.
STM_API int stm_warp_views_bounded(const void* img_l, const void* img_r,
                                   const void* disp_l, const void* disp_r,
                                   const float* shifts_l,
                                   const float* shifts_r,
                                   const int* bounds_l, const int* bounds_r,
                                   void* va, void* vb, int H, int W, int nv,
                                   void* stream) {
  if (H <= 0 || W <= 0 || nv <= 0 || shifts_l == nullptr ||
      shifts_r == nullptr || bounds_l == nullptr || bounds_r == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t view = (size_t)H * W * 3;
  for (int v0 = 0; v0 < nv; v0 += WARP_MAX_VIEWS) {
    const int n = min(nv - v0, WARP_MAX_VIEWS);
    WarpShifts s;
    WarpBounds b;
    for (int v = 0; v < n; ++v) {
      const int u = v0 + v;
      s.l[v] = shifts_l[u];
      s.r[v] = shifts_r[u];
      b.lo_l[v] = bounds_l[2 * u];
      b.hi_l[v] = bounds_l[2 * u + 1];
      b.lo_r[v] = bounds_r[2 * u];
      b.hi_r[v] = bounds_r[2 * u + 1];
    }
    dim3 grid((W + WARP_TX - 1) / WARP_TX, H, n);
    warp_views_bounded_kernel<<<grid, WARP_TX, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img_l, (const uint8_t*)img_r, (const float*)disp_l,
        (const float*)disp_r, s, b, (float*)va + v0 * view,
        (float*)vb + v0 * view, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
