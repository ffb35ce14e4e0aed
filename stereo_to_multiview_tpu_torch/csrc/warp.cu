// B12: every intermediate view, warped from both eyes, masked and merged;
// in its interlace mode only the interlaced frame's subpixels (below).
// B14: the same two warps of every view, floored, without mask and merge.
// B19/B20: B14's warps bounded to each view's static offset range.
//
// B12 replaces the TPU kernel stereo_to_multiview_tpu/ops/warpkern.py
// `_warp_merge_views_xm_kernel` (reached via
// `dibr_warp_merge_views_kern_xm`); B14 replaces `_warp_views_xm_kernel`
// (reached via `dibr_warp_views_kern_xm`), the JAX band engine's unfused
// synthesis, taken when the output resolution differs from the input's,
// bleed_radius != 1 or there is no intermediate view to merge in the
// fused way; in the port it serves the entry `warp_views` only.
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
// Bound on the H100: the images and the five float planes read once and
// the views written once (1080p, 6 views: 12 MB of images and 41 MB of
// float planes in, 37 MB out, ~27 us; 4K, 14 views: 166 MB), or the
// float32 operations of the merges (about 160 a pixel and view, below).
// Design (`stm_warp_merge`, below the interlace mode, whose conversion-free
// merge it shares): a block takes a segment of up to 1024 pixels of one
// row, stages both images' rows in shared memory (the samples' gathers
// then read shared memory; rows too wide for it are read from device
// memory), reads the five planes once a pixel (4 pixels a thread, in
// registers, 80 of them so that three blocks share an SM; a pixel whose
// feather and one mask make its merge one sample's lerp computes that
// lerp alone, the others the conversion-free merge where their masks lie
// in range), and loops over all views in one launch, the shifts read from
// a device array; each view's segment is staged in shared memory (two
// buffers, one barrier a view) and stored 16 bytes at a time, the bytes
// before the first and after the last 16-byte boundary one at a time.
//
// B14 writes those float volumes, because the unfused chain's mask
// multiply and merge follow it: va[v] = u8(lerp(img_l, disp_r, sl)) and
// vb[v] = u8(lerp(img_r, disp_l, sr)) as float32, (nv, H, W, 3) each.  Its
// bound is its output: 2 x 149 MB written at 1080p and 6 views against 28
// MB read (~0.1 ms).  One thread per (view, pixel); the sampling code is
// B12's own (`make_lerp`, `lerp_u8`), so the two cannot drift apart.  Its
// shifts reach the kernel by value, WARP_MAX_VIEWS views at a time: the
// entry point takes any number of views and launches its kernel once for
// each group of at most that many.  B19/B20 (the bounded warps, at the
// end of this file) and B12 (view stack and interlace mode) read theirs
// from a device array in one launch.

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

// The merge of one channel: u8(u8((1 - m) * from_l) + u8(m * from_r)),
// m_b = 1 - m.
__device__ __forceinline__ uint8_t merge_u8(const uint8_t* row_l,
                                            const uint8_t* row_r,
                                            const Lerp& from_l,
                                            const Lerp& from_r, float m,
                                            float m_b, int ch) {
  const uint8_t b = to_u8(__fmul_rn(m_b, (float)sample(row_l, from_l, ch)));
  const uint8_t a = to_u8(__fmul_rn(m, (float)sample(row_r, from_r, ch)));
  return (uint8_t)(b + a);
}

// B12's interlace mode (`stm_warp_merge_interlace`): the merged views and
// the slanted-lenticular interlace in one kernel that writes only the
// interlaced frame.  It computes the JAX chain `synthesize_interlace`
// (stereo_to_multiview_tpu/models/pipeline.py:296): the TPU kernel above
// followed by `mux_multiview_t`, which keeps 1/V of the views it reads
// (and, at a resampled output, `mux_multiview`, which first resamples
// every view).  Output subpixel (Y, X, ch) takes view
//   v = (3 X + yv(Y) + 2 - ch) mod V,
//   yv(Y) = trunc(((Y mod y_mod) + 1) * V * inv_y)  (float32, left to
//   right), as `mux_view_pattern` defines it;
// view 0 is img_r, view V - 1 img_l, and view v in between is the merge
// above (`merge_u8`) at shifts sl[v - 1], sr[v - 1], read from a device
// array of V - 2 each (any V in one launch).  At identity resolution that
// value is the output.  At a resampled output it is the selected view's
// u8 value at the four input points of the per-axis tables (i0, i1, w)
// (the host's float32 `samp_coords`), lerped x first and y second as
// `lerp_axis` does, a0 * (1 - w) + a1 * w with 1 - w in float32 and every
// product and sum rounded on its own, then stored truncated to u8.
//
// Bound on the H100: the two images and the five (H, W) float32 planes
// read once and the output written once (1080p: 54 + 6 MB, 0.018 ms;
// 1080p to 2160x3840: 54 + 25 MB, 0.024 ms), or at a resampled output the
// four merges a subpixel as float32 operations without contraction.  The
// chain it replaces wrote all V - 2 views (37 MB at 1080p, 348 MB at 4K)
// and read them back.  Design: a block takes 512 consecutive pixels of
// the flat output (1536 bytes, so its first byte is 16-byte aligned at
// any width), thread t pixels t, t + 128, t + 256, t + 384 (coalesced
// plane loads, each pixel's planes loaded once for its three subpixels'
// views); the block stages its bytes in shared memory and stores them as
// 16-byte words, the frame's last block its tail byte by byte.  The
// gathers stay in the pixel's row within the disparity's reach of x,
// which L1 and L2 hold (12 MB of images at 1080p).
//
// Conversions between int and float run at 16 a clock on a SM against
// 128 float adds or multiplies, and the merge above takes some 18 a
// value, so the merge here takes none: floor and truncation of a value
// 0 <= v < 2^23 are v + 2^23 rounded toward zero (its low mantissa bits
// hold the integer), and a byte b becomes a float as the bits of 2^23 + b
// minus 2^23.  Every such value lies in that range where the masks lie in
// [0, 1] and the feather in [0, 1 + 2^-8] (B11 and G1 give nothing else),
// and the results are then the merge's own.  The test runs once a pixel
// (all four input points at a resampled output); a passing pixel computes
// its merges in one straight line, with no branch between them (views 0
// and V - 1 merged too, their source pixel selected after), so their
// loads overlap; a failing one takes the merge above (`merge_u8`), exact
// for any float.

#define WMI_TX 128
#define WMI_PX 4
#define WMI_BLOCK (WMI_TX * WMI_PX)
#define F2P23 8388608.0f            // 2^23
#define F2P23_BITS 0x4B000000

// v + 2^23 rounded toward zero: for 0 <= v < 2^23 its low 23 bits hold
// floor(v).
__device__ __forceinline__ float magic(float v) {
  return __fadd_rz(v, F2P23);
}

// floor(v) for 0 <= v < 2^23, as a float.
__device__ __forceinline__ float floor_nn(float v) {
  return __fsub_rn(magic(v), F2P23);
}

// An integer 0 <= i < 2^23 as a float.
__device__ __forceinline__ float int_f(int i) {
  return __fsub_rn(__int_as_float(F2P23_BITS + i), F2P23);
}

// The low byte of an integer-valued float 0 <= v < 2^23.
__device__ __forceinline__ uint8_t byte_of(float v) {
  return (uint8_t)(__float_as_int(magic(v)) & 0xFF);
}

struct MergeSrc {
  const uint8_t* img_l;
  const uint8_t* img_r;
  const float* disp_l;
  const float* disp_r;
  const float* mask_l;
  const float* mask_r;
  const float* feather;
  const float* shifts;   // sl[0 .. V - 3], then sr[0 .. V - 3]
  int H, W, V;
};

// One input pixel's rows and planes, loaded once for every view read
// there; `fast` where its masks lie in the ranges above.
struct MergePx {
  const uint8_t* row_l;
  const uint8_t* row_r;
  float dl, dr, ml, mr, m, m_b, xf;
  int x;
  bool fast;
};

__device__ __forceinline__ MergePx load_px(const MergeSrc& s, int y, int x) {
  MergePx p;
  p.row_l = s.img_l + (size_t)y * s.W * 3;
  p.row_r = s.img_r + (size_t)y * s.W * 3;
  p.x = x;
  p.xf = int_f(x);
  p.dl = p.dr = p.ml = p.mr = p.m = p.m_b = 0.0f;
  p.fast = true;
  if (s.V > 2) {
    const size_t i = (size_t)y * s.W + x;
    p.dl = s.disp_l[i];
    p.dr = s.disp_r[i];
    p.ml = s.mask_l[i];
    p.mr = s.mask_r[i];
    p.m = s.feather[i];
    p.m_b = __fsub_rn(1.0f, p.m);
    p.fast = p.ml >= 0.0f && p.ml <= 1.0f && p.mr >= 0.0f && p.mr <= 1.0f &&
             p.m >= 0.0f && p.m <= 1.00390625f;
  }
  return p;
}

// `make_lerp`'s weights and columns, without conversions; c lies in
// [0, W - 1] after the clamp, so floor(c) is `magic`'s.
struct FastLerp {
  float w0, w1;
  int i0, i1;
};

__device__ __forceinline__ FastLerp fast_lerp(float xf, float d, float s,
                                              int W) {
  float c = __fadd_rn(xf, __fmul_rn(d, s));
  c = fminf(fmaxf(c, 0.0f), int_f(W - 1));
  const float t = magic(c);
  const float x0 = __fsub_rn(t, F2P23);
  FastLerp l;
  l.w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, x0))), 0.0f);
  l.w1 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, __fadd_rn(x0, 1.0f)))),
               0.0f);
  l.i0 = __float_as_int(t) - F2P23_BITS;
  l.i1 = min(l.i0 + 1, W - 1);
  return l;
}

__device__ __forceinline__ float byte_f(uint8_t b) {
  return int_f((int)b);
}

// `lerp_u8` as a float: w0 a + w1 b lies in [0, 256) (weights in [0, 1],
// their sum within two ulps of 1).
__device__ __forceinline__ float lerp_f(const uint8_t* row, const FastLerp& l,
                                        int ch) {
  return floor_nn(__fadd_rn(__fmul_rn(l.w0, byte_f(row[l.i0 * 3 + ch])),
                            __fmul_rn(l.w1, byte_f(row[l.i1 * 3 + ch]))));
}

// `merge_u8` as an integer-valued float in [0, 256), without conversions,
// where the masks lie in [0, 1] and the feather m in [0, 1 + 2^-8].
__device__ __forceinline__ float merge_fast(const uint8_t* row_l,
                                            const uint8_t* row_r,
                                            const FastLerp& fl,
                                            const FastLerp& fr, float ml,
                                            float mr, float m, float m_b,
                                            int ch) {
  // u8((1 - m) * from_l): a product in (-1, 0) truncates to 0
  const float b = floor_nn(fmaxf(
      __fmul_rn(m_b, floor_nn(__fmul_rn(lerp_f(row_l, fl, ch), mr))),
      0.0f));
  const float a =
      floor_nn(__fmul_rn(m, floor_nn(__fmul_rn(lerp_f(row_r, fr, ch), ml))));
  const float t = __fadd_rn(b, a);
  return t >= 256.0f ? __fsub_rn(t, 256.0f) : t;    // the u8 sum wraps
}

// A subpixel's view and, for an intermediate view, its two shifts.
struct ViewSel {
  int v;
  float sl, sr;
};

__device__ __forceinline__ ViewSel select_view(const MergeSrc& s, int v) {
  ViewSel vs{v, 0.0f, 0.0f};
  if (v > 0 && v < s.V - 1) {
    vs.sl = s.shifts[v - 1];
    vs.sr = s.shifts[s.V - 2 + v - 1];
  }
  return vs;
}

// View vs.v's value at the pixel, channel ch, exact for any masks: a
// source pixel, or the merge above (`merge_u8`).
__device__ __forceinline__ uint8_t view_u8(const MergeSrc& s,
                                           const MergePx& p,
                                           const ViewSel& vs, int ch) {
  if (vs.v == 0) return p.row_r[p.x * 3 + ch];
  if (vs.v == s.V - 1) return p.row_l[p.x * 3 + ch];
  const Lerp from_l = make_lerp(p.x, p.dr, vs.sl, p.mr, s.W);
  const Lerp from_r = make_lerp(p.x, p.dl, vs.sr, p.ml, s.W);
  return merge_u8(p.row_l, p.row_r, from_l, from_r, p.m, p.m_b, ch);
}

// The same as an integer-valued float in [0, 256), without branches or
// conversions, where the pixel's masks lie in the ranges above: the merge
// is computed for every view (for views 0 and V - 1 at shifts 0, whose
// samples stay in the row) and the source pixel selected after it.
__device__ __forceinline__ float view_fast(const MergeSrc& s,
                                           const MergePx& p,
                                           const ViewSel& vs, int ch) {
  const FastLerp fl = fast_lerp(p.xf, p.dr, vs.sl, s.W);
  const FastLerp fr = fast_lerp(p.xf, p.dl, vs.sr, s.W);
  const float t = merge_fast(p.row_l, p.row_r, fl, fr, p.ml, p.mr, p.m,
                             p.m_b, ch);
  const uint8_t* src = vs.v == 0 ? p.row_r : p.row_l;
  const float pix = byte_f(src[p.x * 3 + ch]);
  return vs.v == 0 || vs.v == s.V - 1 ? pix : t;
}

__device__ __forceinline__ float lerp2(float a0, float a1, float w,
                                       float w_b) {
  return __fadd_rn(__fmul_rn(a0, w_b), __fmul_rn(a1, w));
}

__global__ void __launch_bounds__(WMI_TX)
warp_merge_interlace_kernel(MergeSrc s, const int* __restrict__ yi0,
                            const int* __restrict__ yi1,
                            const float* __restrict__ wy,
                            const int* __restrict__ xi0,
                            const int* __restrict__ xi1,
                            const float* __restrict__ wx, int y_mod,
                            float inv_y, uint8_t* __restrict__ out,
                            int rows, int cols) {
  __shared__ __align__(16) uint8_t stage[WMI_BLOCK * 3];
  const int p0 = blockIdx.x * WMI_BLOCK;
  const int n = min(WMI_BLOCK, rows * cols - p0);
  const float fv = int_f(s.V);
  // this thread's first pixel; each next one lies WMI_TX further
  int Y = (p0 + (int)threadIdx.x) / cols;
  int X = p0 + (int)threadIdx.x - Y * cols;
  int ym = Y % y_mod;
  for (int k = 0; k < WMI_PX; ++k) {
    const int j = threadIdx.x + k * WMI_TX;
    if (j < n) {
      // trunc((ym + 1) * V * inv_y), a value >= 0
      const int yv = __float_as_int(magic(__fmul_rn(
                         __fmul_rn(__fadd_rn(int_f(ym), 1.0f), fv), inv_y))) -
                     F2P23_BITS;
      const int v0 = (3 * X + yv + 2) % s.V;
      ViewSel vs[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        vs[ch] = select_view(s, v0 - ch < 0 ? v0 - ch + s.V : v0 - ch);
      uint8_t* o = stage + j * 3;
      if (xi0 == nullptr) {
        const MergePx px = load_px(s, Y, X);
        if (px.fast) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            o[ch] = byte_of(view_fast(s, px, vs[ch], ch));
        } else {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) o[ch] = view_u8(s, px, vs[ch], ch);
        }
      } else {
        const int ya = yi0[Y], yb = yi1[Y], xa = xi0[X], xb = xi1[X];
        const MergePx q[4] = {load_px(s, ya, xa), load_px(s, ya, xb),
                              load_px(s, yb, xa), load_px(s, yb, xb)};
        const float fx = wx[X], fy = wy[Y];
        const float fx_b = __fsub_rn(1.0f, fx), fy_b = __fsub_rn(1.0f, fy);
        float val[4][3];
        if (q[0].fast && q[1].fast && q[2].fast && q[3].fast) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              val[c][ch] = view_fast(s, q[c], vs[ch], ch);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              val[c][ch] = byte_f(view_u8(s, q[c], vs[ch], ch));
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float top = lerp2(val[0][ch], val[1][ch], fx, fx_b);
          const float bot = lerp2(val[2][ch], val[3][ch], fx, fx_b);
          // in [0, 256): truncated as `mux_multiview`'s u8 store
          o[ch] = byte_of(lerp2(top, bot, fy, fy_b));
        }
      }
    }
    X += WMI_TX;
    while (X >= cols) {
      X -= cols;
      ++Y;
      if (++ym == y_mod) ym = 0;
    }
  }
  __syncthreads();
  const int nb = n * 3;
  const int words = nb / 16;
  uint8_t* dst = out + (size_t)p0 * 3;
  for (int i = threadIdx.x; i < words; i += WMI_TX)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
  for (int i = words * 16 + threadIdx.x; i < nb; i += WMI_TX) dst[i] = stage[i];
}

// img_l, img_r: (H, W, 3) u8; disp_*, mask_*, feather: (H, W) f32;
// shifts: 2 (V - 2) f32 on the device (unused at V = 2); yi0, yi1, wy:
// rows entries and xi0, xi1, wx: cols entries (int32, f32) on the device,
// or all null at identity resolution (rows, cols) = (H, W); out: (rows,
// cols, 3) u8, 16-byte aligned.
STM_API int stm_warp_merge_interlace(
    const void* img_l, const void* img_r, const void* disp_l,
    const void* disp_r, const void* mask_l, const void* mask_r,
    const void* feather, const void* shifts, const void* yi0,
    const void* yi1, const void* wy, const void* xi0, const void* xi1,
    const void* wx, void* out, int H, int W, int V, int y_mod, int rows,
    int cols, float inv_y, void* stream) {
  if (H <= 0 || W <= 0 || V < 2 || y_mod <= 0 || rows <= 0 || cols <= 0 ||
      (V > 2 && shifts == nullptr) || ((uintptr_t)out & 15) != 0 ||
      W >= (1 << 23) || V >= (1 << 20) ||
      (long long)rows * cols > (1LL << 31) - WMI_BLOCK)
    return (int)cudaErrorInvalidValue;
  const bool identity = xi0 == nullptr;
  if (identity ? (rows != H || cols != W || yi0 || yi1 || wy || xi1 || wx)
               : !(yi0 && yi1 && wy && xi1 && wx))
    return (int)cudaErrorInvalidValue;
  MergeSrc s{(const uint8_t*)img_l, (const uint8_t*)img_r,
             (const float*)disp_l,  (const float*)disp_r,
             (const float*)mask_l,  (const float*)mask_r,
             (const float*)feather, (const float*)shifts,
             H, W, V};
  const int blocks = (int)(((long long)rows * cols + WMI_BLOCK - 1) /
                          WMI_BLOCK);
  warp_merge_interlace_kernel<<<blocks, WMI_TX, 0, (cudaStream_t)stream>>>(
      s, (const int*)yi0, (const int*)yi1, (const float*)wy,
      (const int*)xi0, (const int*)xi1, (const float*)wx, y_mod, inv_y,
      (uint8_t*)out, rows, cols);
  return (int)cudaGetLastError();
}

// B12's view stack (`stm_warp_merge`): every intermediate view's merge
// (`merge_u8`, or `merge_fast` where the pixel's masks lie in range, or
// one sample's lerp where the feather and a mask make the merge that), at
// shifts sl[v], sr[v] of a device array, into (nv, H, W, 3) u8.
#define WMV_TX 256
#define WMV_PX 4
#define WMV_SEG (WMV_TX * WMV_PX)
#define WMV_OBUF (3 * WMV_SEG + 16)   // a view's staged segment, aligned
enum { WMV_EXACT = 0, WMV_FAST = 1, WMV_ONE = 2 };

// Shared memory of a block: both rows (3W bytes, padded to 16) when
// staged, then two view buffers.
__host__ __device__ inline int wmv_row_pad(int W) {
  return (3 * W + 15) & ~15;
}

__device__ void wmv_copy_row(uint8_t* dst, const uint8_t* src, int n) {
  if (((uintptr_t)src & 15) == 0) {
    for (int i = threadIdx.x; i < n / 16; i += WMV_TX)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    for (int i = n / 16 * 16 + threadIdx.x; i < n; i += WMV_TX)
      dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += WMV_TX) dst[i] = src[i];
  }
}

template <bool STAGE>
__global__ void __launch_bounds__(WMV_TX, 3)
warp_merge_views_kernel(MergeSrc s, uint8_t* __restrict__ out, int nv) {
  extern __shared__ __align__(16) uint8_t wmv_sm[];
  const int W = s.W, y = blockIdx.y, rb = 3 * W;
  const int seg0 = blockIdx.x * WMV_SEG;
  const int npx = min(WMV_SEG, W - seg0);
  const uint8_t* row_l = s.img_l + (size_t)y * rb;
  const uint8_t* row_r = s.img_r + (size_t)y * rb;
  uint8_t* obuf = wmv_sm;
  if (STAGE) {
    const int rp = wmv_row_pad(W);
    wmv_copy_row(wmv_sm, row_l, rb);
    wmv_copy_row(wmv_sm + rp, row_r, rb);
    row_l = wmv_sm;
    row_r = wmv_sm + rp;
    obuf = wmv_sm + 2 * rp;
    __syncthreads();
  }
  // the pixels' planes, read once for every view, and each pixel's kind:
  // WMV_ONE where the merge is one eye's sample alone (feather 0 and mask_r
  // 1: the left image's lerp; feather 1 and mask_l 1: the right image's;
  // the other term is u8(0 * a byte) = 0 and the mask's product exact),
  // WMV_FAST where the masks lie in range (`merge_fast`), else WMV_EXACT
  float dl[WMV_PX], dr[WMV_PX], ml[WMV_PX], mr[WMV_PX], m[WMV_PX],
      m_b[WMV_PX];
  int kind[WMV_PX];
#pragma unroll
  for (int k = 0; k < WMV_PX; ++k) {
    const int j = threadIdx.x + k * WMV_TX;
    kind[k] = WMV_EXACT;
    if (j < npx) {
      const size_t i = (size_t)y * W + seg0 + j;
      dl[k] = s.disp_l[i];
      dr[k] = s.disp_r[i];
      ml[k] = s.mask_l[i];
      mr[k] = s.mask_r[i];
      m[k] = s.feather[i];
      m_b[k] = __fsub_rn(1.0f, m[k]);
      if ((m[k] == 0.0f && mr[k] == 1.0f) || (m[k] == 1.0f && ml[k] == 1.0f))
        kind[k] = WMV_ONE;
      else if (ml[k] >= 0.0f && ml[k] <= 1.0f && mr[k] >= 0.0f &&
               mr[k] <= 1.0f && m[k] >= 0.0f && m[k] <= 1.00390625f)
        kind[k] = WMV_FAST;
    }
  }
  const int nb = 3 * npx;
  for (int v = 0; v < nv; ++v) {
    const float sl = __ldg(s.shifts + v), sr = __ldg(s.shifts + nv + v);
    uint8_t* dst = out + ((size_t)v * s.H + y) * rb + (size_t)seg0 * 3;
    // byte b of the segment sits at ob[off + b], so ob's 16-byte words
    // fall on dst's
    const int off = (int)((uintptr_t)dst & 15);
    uint8_t* ob = obuf + (v & 1) * WMV_OBUF + off;
#pragma unroll
    for (int k = 0; k < WMV_PX; ++k) {
      const int j = threadIdx.x + k * WMV_TX;
      if (j >= npx) continue;
      const int x = seg0 + j;
      uint8_t* o = ob + 3 * j;
      if (kind[k] == WMV_ONE) {
        const bool left = m[k] == 0.0f;
        const FastLerp fo = fast_lerp(int_f(x), left ? dr[k] : dl[k],
                                      left ? sl : sr, W);
        const uint8_t* row = left ? row_l : row_r;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) o[ch] = byte_of(lerp_f(row, fo, ch));
      } else if (kind[k] == WMV_FAST) {
        const float xf = int_f(x);
        const FastLerp fl = fast_lerp(xf, dr[k], sl, W);
        const FastLerp fr = fast_lerp(xf, dl[k], sr, W);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          o[ch] = byte_of(merge_fast(row_l, row_r, fl, fr, ml[k], mr[k],
                                     m[k], m_b[k], ch));
      } else {
        const Lerp from_l = make_lerp(x, dr[k], sl, mr[k], W);
        const Lerp from_r = make_lerp(x, dl[k], sr, ml[k], W);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          o[ch] = merge_u8(row_l, row_r, from_l, from_r, m[k], m_b[k], ch);
      }
    }
    // the buffer written; the other one's stores (view v - 1) are done by
    // every thread before it is written again (view v + 1)
    __syncthreads();
    const int head = min((16 - off) & 15, nb);
    const int words = (nb - head) >> 4;
    for (int i = threadIdx.x; i < words; i += WMV_TX)
      reinterpret_cast<uint4*>(dst + head)[i] =
          reinterpret_cast<const uint4*>(ob + head)[i];
    for (int i = threadIdx.x; i < head; i += WMV_TX) dst[i] = ob[i];
    for (int i = head + 16 * words + threadIdx.x; i < nb; i += WMV_TX)
      dst[i] = ob[i];
  }
}

// img_l, img_r: (H, W, 3) u8; disp_*, mask_*, feather: (H, W) f32;
// shifts: 2 nv f32 on the device, sl[0 .. nv - 1] then sr[0 .. nv - 1];
// out: (nv, H, W, 3) u8, any alignment.  One launch for every view.
STM_API int stm_warp_merge(const void* img_l, const void* img_r,
                           const void* disp_l, const void* disp_r,
                           const void* mask_l, const void* mask_r,
                           const void* feather, const void* shifts, void* out,
                           int H, int W, int nv, void* stream) {
  if (H <= 0 || W <= 0 || nv <= 0 || shifts == nullptr || H > 65535 ||
      W >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  MergeSrc s{(const uint8_t*)img_l, (const uint8_t*)img_r,
             (const float*)disp_l,  (const float*)disp_r,
             (const float*)mask_l,  (const float*)mask_r,
             (const float*)feather, (const float*)shifts,
             H, W, nv + 2};
  dim3 grid((W + WMV_SEG - 1) / WMV_SEG, H);
  const size_t staged = 2 * (size_t)wmv_row_pad(W) + 2 * WMV_OBUF;
  cudaStream_t st = (cudaStream_t)stream;
  if (staged <= 227 * 1024) {
    cudaError_t err = stm_smem_cap(warp_merge_views_kernel<true>, staged);
    if (err != cudaSuccess) return (int)err;
    warp_merge_views_kernel<true><<<grid, WMV_TX, staged, st>>>(
        s, (uint8_t*)out, nv);
  } else {
    // rows too wide for shared memory: the gathers read device memory
    warp_merge_views_kernel<false><<<grid, WMV_TX, 2 * WMV_OBUF, st>>>(
        s, (uint8_t*)out, nv);
  }
  return (int)cudaGetLastError();
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
// B14's value where lo <= floor(c) - x <= hi, else +0.0 (the value the
// u8 sample times 0 gave, a lerp being never negative).
//
// Bound on the H100: B14's, its output (1080p, 6 views: 28 MB in, 299 MB
// out, 0.098 ms; 4K, 14 views: 116 MB in, 2.79 GB out, 0.87 ms).  Design
// (`stm_warp_views_bounded`, B12's view stack without mask and merge): a
// block takes a segment of up to 1024 pixels of one row and stages both
// images' rows in shared memory (`wmv_copy_row`); rows too wide for it,
// and blocks of one view, whose staged bytes would each be read once, read
// device memory, 4 blocks an SM.  Thread t owns pixels 4t .. 4t + 3 and
// reads their two disparities once, 16 bytes at a time where the plane's
// row allows.  The block loops over every view in one launch (over a
// group of them where one block a segment would fill less than twice the
// card's block slots: 38 views of 200 rows take 4 groups), shifts and
// (lo, hi) bounds read from device arrays; a sample is the conversion-free
// lerp of B12 (`fast_lerp`, `lerp_f`: the same floor, weights and
// truncation as `make_lerp` / `lerp_u8`, as floats), +0.0 where its offset
// leaves the range (a staged block skips those gathers).  Each view's two
// (segment, 3) float32 outputs are staged in shared memory (two buffers,
// one barrier a view), a thread's 12 values an eye as three 16-byte words,
// and stored as 16-byte words, one warp instruction 512 contiguous bytes;
// a segment's tail, and a segment whose first value is not 16-byte
// aligned, go 4 bytes at a time.

#define WVB_TX 256
#define WVB_PX 4
#define WVB_SEG (WVB_TX * WVB_PX)
#define WVB_OBUF (3 * WVB_SEG)        // floats of one eye's staged segment
static_assert(WVB_TX == WMV_TX, "wmv_copy_row strides by WMV_TX threads");

// A thread's n <= 4 consecutive values of a float plane, 16 bytes at once
// where they are 4 and aligned; the others 0.
__device__ __forceinline__ void wvb_load4(const float* p, int n,
                                          float (&v)[WVB_PX]) {
  if (n == WVB_PX && ((uintptr_t)p & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < WVB_PX; ++k) v[k] = k < n ? __ldg(p + k) : 0.0f;
}

// An image warp's three channels at pixel x: the lerp where
// floor(c) - x lies in [lo, hi], else +0.0.  With SKIP (rows in shared
// memory) the gathers out of range are skipped; without (rows in device
// memory) every sample is gathered and +0.0 selected, since a branch
// around each pixel's gathers keeps them from overlapping those of the
// thread's other pixels.
template <bool SKIP>
__device__ __forceinline__ void wvb_sample(const uint8_t* row, int x, float d,
                                           float s, int lo, int hi, int W,
                                           float* o) {
  const FastLerp l = fast_lerp(int_f(x), d, s, W);
  const int k = l.i0 - x;
  const bool keep = k >= lo && k <= hi;
  if (!SKIP) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = keep ? lerp_f(row, l, ch) : 0.0f;
  } else if (keep) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = lerp_f(row, l, ch);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = 0.0f;
  }
}

// `nf` staged floats to dst: 16-byte words from an aligned dst, the tail
// and an unaligned dst 4 bytes at a time.
__device__ __forceinline__ void wvb_store(float* __restrict__ dst,
                                          const float* src, int nf) {
  int i0 = 0;
  if (((uintptr_t)dst & 15) == 0) {
    const int words = nf >> 2;
    for (int i = threadIdx.x; i < words; i += WVB_TX)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    i0 = words << 2;
  }
  for (int i = i0 + threadIdx.x; i < nf; i += WVB_TX) dst[i] = src[i];
}

// Staged, a block's rows and buffers leave room for 3 blocks an SM at
// 1080p and 4K; unstaged, its 48 KB of buffers for 4 (64 registers).
template <bool STAGE>
__global__ void __launch_bounds__(WVB_TX, STAGE ? 3 : 4)
warp_views_bounded_kernel(const uint8_t* __restrict__ img_l,
                          const uint8_t* __restrict__ img_r,
                          const float* __restrict__ disp_l,
                          const float* __restrict__ disp_r,
                          const float* __restrict__ shifts,
                          const int4* __restrict__ bounds,
                          float* __restrict__ va, float* __restrict__ vb,
                          int H, int W, int nv, int vpb) {
  extern __shared__ __align__(16) uint8_t wvb_sm[];
  const int y = blockIdx.y, rb = 3 * W;
  const int seg0 = blockIdx.x * WVB_SEG;
  const int npx = min(WVB_SEG, W - seg0);
  const uint8_t* row_l = img_l + (size_t)y * rb;
  const uint8_t* row_r = img_r + (size_t)y * rb;
  float* obuf = reinterpret_cast<float*>(wvb_sm);
  if (STAGE) {
    const int rp = wmv_row_pad(W);
    wmv_copy_row(wvb_sm, row_l, rb);
    wmv_copy_row(wvb_sm + rp, row_r, rb);
    row_l = wvb_sm;
    row_r = wvb_sm + rp;
    obuf = reinterpret_cast<float*>(wvb_sm + 2 * rp);
    __syncthreads();
  }
  const int j0 = WVB_PX * threadIdx.x;
  const int n = max(0, min(WVB_PX, npx - j0));   // this thread's pixels
  const size_t i0 = (size_t)y * W + seg0 + j0;
  float dl[WVB_PX], dr[WVB_PX];
  wvb_load4(disp_l + i0, n, dl);
  wvb_load4(disp_r + i0, n, dr);
  const int nf = 3 * npx;
  const int v1 = min(nv, (int)(blockIdx.z + 1) * vpb);
  for (int v = blockIdx.z * vpb; v < v1; ++v) {
    const float sl = __ldg(shifts + v), sr = __ldg(shifts + nv + v);
    const int4 b = __ldg(bounds + v);              // lo_l, hi_l, lo_r, hi_r
    float oa[3 * WVB_PX], ob[3 * WVB_PX];
#pragma unroll
    for (int k = 0; k < WVB_PX; ++k) {
      const int x = seg0 + j0 + k;
      if (k < n) {
        wvb_sample<STAGE>(row_l, x, dr[k], sl, b.x, b.y, W, oa + 3 * k);
        wvb_sample<STAGE>(row_r, x, dl[k], sr, b.z, b.w, W, ob + 3 * k);
      } else {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) oa[3 * k + ch] = ob[3 * k + ch] = 0.0f;
      }
    }
    // the buffers of view v & 1; the other pair's stores (view v - 1) are
    // done by every thread before it is written again (view v + 1)
    float* sa = obuf + (v & 1) * 2 * WVB_OBUF;
    float* sb = sa + WVB_OBUF;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      reinterpret_cast<float4*>(sa + 3 * j0)[q] =
          make_float4(oa[4 * q], oa[4 * q + 1], oa[4 * q + 2], oa[4 * q + 3]);
      reinterpret_cast<float4*>(sb + 3 * j0)[q] =
          make_float4(ob[4 * q], ob[4 * q + 1], ob[4 * q + 2], ob[4 * q + 3]);
    }
    __syncthreads();
    const size_t o = (((size_t)v * H + y) * W + seg0) * 3;
    wvb_store(va + o, sa, nf);
    wvb_store(vb + o, sb, nf);
  }
}

// img_l, img_r: (H, W, 3) u8; disp_l, disp_r: (H, W) f32; shifts: 2 nv
// f32 on the device, shifts_l[0 .. nv - 1] then shifts_r; bounds: nv int4
// (lo_l, hi_l, lo_r, hi_r) on the device, 16-byte aligned, the offset
// range of each view's two warps (INT_MIN, INT_MAX: unbounded); va, vb:
// (nv, H, W, 3) f32.  One launch for every view.
STM_API int stm_warp_views_bounded(const void* img_l, const void* img_r,
                                   const void* disp_l, const void* disp_r,
                                   const void* shifts, const void* bounds,
                                   void* va, void* vb, int H, int W, int nv,
                                   void* stream) {
  if (H <= 0 || W <= 0 || nv <= 0 || shifts == nullptr ||
      bounds == nullptr || ((uintptr_t)bounds & 15) != 0 || H > 65535 ||
      W >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  // the views split over blocks where one block a segment and row would
  // fill less than twice the card's block slots (3 an SM)
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int segs = (W + WVB_SEG - 1) / WVB_SEG;
  const long long blocks = (long long)segs * H;
  long long groups = (2LL * 3 * sms + blocks - 1) / blocks;
  groups = groups < nv ? groups : nv;
  const int vpb = (int)((nv + groups - 1) / groups);
  dim3 grid(segs, H, (nv + vpb - 1) / vpb);
  const size_t obufs = 4 * WVB_OBUF * sizeof(float);
  const size_t staged = 2 * (size_t)wmv_row_pad(W) + obufs;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *il = (const uint8_t*)img_l, *ir = (const uint8_t*)img_r;
  const float *dl = (const float*)disp_l, *dr = (const float*)disp_r;
  const float* sh = (const float*)shifts;
  const int4* bd = (const int4*)bounds;
  if (vpb > 1 && staged <= 227 * 1024) {
    err = stm_smem_cap(warp_views_bounded_kernel<true>, staged);
    if (err != cudaSuccess) return (int)err;
    warp_views_bounded_kernel<true><<<grid, WVB_TX, staged, st>>>(
        il, ir, dl, dr, sh, bd, (float*)va, (float*)vb, H, W, nv, vpb);
  } else {
    // one view a block (a staged byte would be read once) or rows too
    // wide for shared memory: the gathers read device memory
    warp_views_bounded_kernel<false><<<grid, WVB_TX, obufs, st>>>(
        il, ir, dl, dr, sh, bd, (float*)va, (float*)vb, H, W, nv, vpb);
  }
  return (int)cudaGetLastError();
}
