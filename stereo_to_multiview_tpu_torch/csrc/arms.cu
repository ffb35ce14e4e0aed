// B1: cross-based support arms (UP, DOWN, LEFT, RIGHT) of one or two
// images in one launch.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/postkern.py
// `_arms_kernel` (reached via `_arms_vertical` from `cross_arms_kern` and
// `cross_arms_kern_lr`; the TPU runs LEFT/RIGHT as UP/DOWN of the
// transposed image, and both eyes side by side).
//
// For each pixel and direction, walk k = 1..usd:
//   arm += [pixel k lies in the image and no color test failed at j < k]
// A step fails within lsd when max_c |I(k) - I(0)| > lcd or
// max_c |I(k) - I(k-1)| > lcd, beyond lsd when max_c |I(k) - I(0)| > ucd,
// the reference's float32 compare (d_ca_cross.cu:41-69).  The differences
// are integers a in 0..255, so a > t equals a >= c with the integer
// c = clamp(floor(t) + 1, 0, 256) (256 for a NaN t: never fails; 0 for
// t < 0: always fails), which the host computes from the float32 t
// without rounding it.  (The TPU kernel compares with bf16(t), which
// rounds 5.99 up to 6: the port follows the reference.)  The arm is
// written before the color test, a quirk of the reference kept here: a
// color failure at distance k gives arm k, the border at distance k gives
// k - 1.
//
// Bound on the H100: at 1080p an eye reads 6 MB and writes 33 MB (~12 us
// at 3.35 TB/s); the walks take ~14 integer operations a step, ~4.5 G an
// eye (~67 us at the float32 rate), so operations bound it.  Design: a
// block stages a 32 x 64 tile of one eye as packed u32 pixels (b | g << 8
// | r << 16) in shared memory, with the cross-shaped halo the walks
// reach: the tile's columns widened by min(usd, H - 1) rows up and down,
// its rows widened by min(usd, W - 1) columns left and right.  A thread
// owns 8 pixels of one column and walks all four arms of each from
// shared memory, stopping at the first failure; a warp holds 32
// neighbouring columns of one row, so every step reads 32 consecutive
// words.  The step test takes the byte-wise absolute differences of the
// packed pixels (__vabsdiffu4, one instruction) and tests all three
// bytes against c at once by carries into their top bits (`arms_fail`:
// an add and a LOP3 where c is in 1..128, as the presets' are; the
// byte-wise maximum, __vmaxu4, takes six instructions on sm_90).  The
// test of a step against the previous pixel depends on no anchor: the
// staging does it once a pixel and keeps it as two edge bits in the
// word's top byte, so a step within lsd is one difference against the
// anchor too.  The walks take two steps an iteration.  Both eyes run in
// one launch (blockIdx.z).
//
// Halo-shard mode (`row0`, `global_h`): the image is a row shard of a
// frame of global_h rows, extended by halo rows, whose row y is the
// frame's row g = y + row0 (row0 = 0 and global_h = H without it: one
// code path).  A vertical step k is in bounds where 0 <= g -+ k <=
// global_h - 1, the same test as the plain version: for UP the steps
// k in [max(1, g - global_h + 1), g], for DOWN [max(1, -g),
// global_h - 1 - g].  The walk runs to the first failure K or to
// kmax = min(usd, the interval's end), and the arm is the number of
// in-bounds steps up to there: max(0, min(K, kmax) - start + 1), which
// is the walk itself where the interval starts at 1 (every row of the
// frame).  Steps past the image's rows read its edge row, as the
// plain version's clamped shifts do; the staged edge bits are taken
// between the clamped pixel and its clamped neighbour, so a step
// between two reads of one edge row never fails on them.

#include "stm_common.cuh"

#define ARMS_THREADS 256
#define ARMS_TW 64
#define ARMS_TH 32
#define ARMS_PPT (ARMS_TH * ARMS_TW / ARMS_THREADS)

struct ArmsEyes {
  const uint8_t* img[2];
  int* arms[2];
};

__device__ __forceinline__ uint32_t arms_pack(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
}

// The step test "some channel difference >= c" on the byte-wise absolute
// differences d (top byte 0), for c in 0..256, as carries in the bytes:
// t = (d & lo) + k, fail iff (t | (d & o)) & (d | a) has a bit 7 set.
//   c in [1, 128]: lo = o = a = ~0, k = (128 - c) x 3 bytes: b + 128 - c
//                  has bit 7 iff b >= c where b < 128, a byte b >= 128
//                  (>= c) has it in d, and its carry only reaches a byte
//                  when the test has already failed;
//   c in [129, 255]: lo = 0x7f7f7f, o = a = 0, k = (256 - c) x 3 bytes:
//                  bit 7 of d and of (b & 127) + 256 - c;
//   c = 0: every byte passes (k = 0x808080, o = 0, a = ~0);
//   c = 256: none (lo = k = o = a = 0).
struct ArmsTest {
  uint32_t lo, k, o, a;
};

static ArmsTest arms_test(int c) {
  ArmsTest t;
  if (c >= 1 && c <= 128) {
    t.lo = t.o = t.a = 0xFFFFFFFFu;
    t.k = (uint32_t)(128 - c) * 0x010101u;
  } else if (c >= 129 && c <= 255) {
    t.lo = 0x7F7F7Fu;
    t.o = t.a = 0u;
    t.k = (uint32_t)(256 - c) * 0x010101u;
  } else if (c == 0) {
    t.lo = 0x7F7F7Fu;
    t.k = 0x808080u;
    t.o = 0u;
    t.a = 0xFFFFFFFFu;
  } else {
    t.lo = t.k = t.o = t.a = 0u;
  }
  return t;
}

// Bit 7 of each of the three low bytes of d set where that byte is >= c
// (more bits may be set); SMALL: c in [1, 128], one add and one LOP3.
template <bool SMALL>
__device__ __forceinline__ uint32_t arms_fail(uint32_t d, const ArmsTest& t) {
  if (SMALL) return (d + t.k) | d;
  return (((d & t.lo) + t.k) | (d & t.o)) & (d | t.a);
}

#define ARMS_CH 0x808080u          // the channels' test bits
#define ARMS_EDGE_NEXT 0x80000000u // top byte: the step to the next row
#define ARMS_EDGE_PREV 0x40000000u // (column) fails, to the previous one

// Does the step to staged word c fail against the anchor anc (top byte
// 0)?  Within lsd (edge: the walk's edge bit) the channels against lcd,
// or the step from the previous pixel, whose test the staging did (its
// edge bit in c's top byte); beyond lsd (edge = 0) against ucd.  The
// carries of the three channels stop below bit 24.
template <bool SMALL>
__device__ __forceinline__ bool arms_step_fails(uint32_t c, uint32_t anc,
                                                const ArmsTest& t,
                                                uint32_t edge) {
  const uint32_t d = __vabsdiffu4(c, anc);
  if (SMALL) return (((d + t.k) | d) & (ARMS_CH | edge)) != 0u;
  return ((arms_fail<false>(d, t) & ARMS_CH) | (d & edge)) != 0u;
}

// The arm from the anchor at s (its staged word) along stride: kmax the
// border reach, the first k1 = min(lsd, kmax) steps against lcd and the
// edge bit `edge`, the rest against ucd; two steps an iteration.
template <bool SMALL>
__device__ __forceinline__ int arms_walk(const uint32_t* s, int stride,
                                         int kmax, int k1, uint32_t edge,
                                         const ArmsTest& tl,
                                         const ArmsTest& tu) {
  const uint32_t anc = *s & 0xFFFFFFu;
  int k = 1;
  for (; k < k1; k += 2) {
    const uint32_t c1 = s[k * stride], c2 = s[(k + 1) * stride];
    if (arms_step_fails<SMALL>(c1, anc, tl, edge)) return k;
    if (arms_step_fails<SMALL>(c2, anc, tl, edge)) return k + 1;
  }
  if (k == k1) {
    if (arms_step_fails<SMALL>(s[k * stride], anc, tl, edge)) return k;
    ++k;
  }
  for (; k < kmax; k += 2) {
    const uint32_t c1 = s[k * stride], c2 = s[(k + 1) * stride];
    if (arms_step_fails<SMALL>(c1, anc, tu, 0u)) return k;
    if (arms_step_fails<SMALL>(c2, anc, tu, 0u)) return k + 1;
  }
  if (k == kmax && arms_step_fails<SMALL>(s[k * stride], anc, tu, 0u))
    return k;
  return kmax;
}

// The staged word of pixel (y, x) (clamped): b | g << 8 | r << 16 and the
// edge bits of its steps to the next and the previous pixel along
// (dy, dx), tested against lcd; each neighbour's coordinates are clamped
// from the unclamped ones, so past an edge both read the edge pixel.
template <bool SMALL>
__device__ __forceinline__ uint32_t arms_stage(const uint8_t* img, int H,
                                               int W, int y, int x, int dy,
                                               int dx, const ArmsTest& tl) {
  const int yn = min(max(y + dy, 0), H - 1), xn = min(max(x + dx, 0), W - 1);
  const int yp = min(max(y - dy, 0), H - 1), xp = min(max(x - dx, 0), W - 1);
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  const uint32_t c = arms_pack(img + ((size_t)y * W + x) * 3);
  const uint32_t n = arms_pack(img + ((size_t)yn * W + xn) * 3);
  const uint32_t p = arms_pack(img + ((size_t)yp * W + xp) * 3);
  uint32_t w = c;
  if (arms_fail<SMALL>(__vabsdiffu4(c, n), tl) & ARMS_CH) w |= ARMS_EDGE_NEXT;
  if (arms_fail<SMALL>(__vabsdiffu4(c, p), tl) & ARMS_CH) w |= ARMS_EDGE_PREV;
  return w;
}

template <bool SMALL>
__global__ void __launch_bounds__(ARMS_THREADS)
cross_arms_kernel(ArmsEyes eyes, int H, int W, ArmsTest tu, ArmsTest tl,
                  int usd, int lsd, int rv, int rh, int row0, int gh) {
  extern __shared__ uint32_t arms_smem[];
  const uint8_t* __restrict__ img = eyes.img[blockIdx.z];
  int* __restrict__ arms = eyes.arms[blockIdx.z];
  const int x0 = blockIdx.x * ARMS_TW;
  const int y0 = blockIdx.y * ARMS_TH;
  const int hw = ARMS_TW + 2 * rh;          // the horizontal strip's width
  uint32_t* vs = arms_smem;                 // (TH + 2 rv) x TW
  uint32_t* hs = arms_smem + (ARMS_TH + 2 * rv) * ARMS_TW;   // TH x hw

  // stage the cross; reads outside the image clamp (the walks reach
  // them only in the halo-shard mode, where the plain version clamps too)
  const int nv = (ARMS_TH + 2 * rv) * ARMS_TW;
  for (int i = threadIdx.x; i < nv; i += ARMS_THREADS)
    vs[i] = arms_stage<SMALL>(img, H, W, y0 - rv + i / ARMS_TW,
                              x0 + i % ARMS_TW, 1, 0, tl);
  const int nh = ARMS_TH * hw;
  for (int i = threadIdx.x; i < nh; i += ARMS_THREADS)
    hs[i] = arms_stage<SMALL>(img, H, W, y0 + i / hw, x0 - rh + i % hw, 0,
                              1, tl);
  __syncthreads();

  const int tx = threadIdx.x % ARMS_TW;
  const int x = x0 + tx;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  for (int i = 0; i < ARMS_PPT; ++i) {
    const int ty = threadIdx.x / ARMS_TW + i * (ARMS_THREADS / ARMS_TW);
    const int y = y0 + ty;
    if (y >= H) break;
    const uint32_t* v = vs + (rv + ty) * ARMS_TW + tx;
    const uint32_t* h = hs + ty * hw + rh + tx;
    int* o = arms + (size_t)y * W + x;
    // UP and LEFT step from pixel k - 1 to k = the next pixel's edge
    // (k to k + 1) seen from k; DOWN and RIGHT the previous one's.  The
    // vertical steps in bounds: UP [max(1, g - gh + 1), g], DOWN
    // [max(1, -g), gh - 1 - g] (g the frame's row)
    const int g = y + row0;
    int kmax = max(min(usd, g), 0);
    int k0 = max(1, g - gh + 1);
    o[0] = max(arms_walk<SMALL>(v, -ARMS_TW, kmax, min(lsd, kmax),
                                ARMS_EDGE_NEXT, tl, tu) - k0 + 1, 0);
    kmax = max(min(usd, gh - 1 - g), 0);
    k0 = max(1, -g);
    o[plane] = max(arms_walk<SMALL>(v, ARMS_TW, kmax, min(lsd, kmax),
                                    ARMS_EDGE_PREV, tl, tu) - k0 + 1, 0);
    kmax = min(usd, x);
    o[2 * plane] = arms_walk<SMALL>(h, -1, kmax, min(lsd, kmax),
                                    ARMS_EDGE_NEXT, tl, tu);
    kmax = min(usd, W - 1 - x);
    o[3 * plane] = arms_walk<SMALL>(h, 1, kmax, min(lsd, kmax),
                                    ARMS_EDGE_PREV, tl, tu);
  }
}

// The shared memory a block stages at these shapes, in bytes.
static size_t arms_smem_bytes(int rv, int rh) {
  return ((size_t)(ARMS_TH + 2 * rv) * ARMS_TW +
          (size_t)ARMS_TH * (ARMS_TW + 2 * rh)) * sizeof(uint32_t);
}

// img_l, img_r: (H, W, 3) u8 contiguous; arms_l, arms_r: (4, H, W) i32;
// n_eyes 1 (img_l alone) or 2.  cu, cl: the integer thresholds of ucd and
// lcd (a step fails where a channel difference is >= c, c in 0..256).
// row0, global_h: the halo-shard mode (0 and H without it).
STM_API int stm_cross_arms(const void* img_l, const void* img_r,
                           void* arms_l, void* arms_r, int n_eyes, int H,
                           int W, int cu, int cl, int usd, int lsd, int row0,
                           int global_h, void* stream) {
  if (H <= 0 || W <= 0 || usd < 0 || lsd < 0 || n_eyes < 1 || n_eyes > 2 ||
      cu < 0 || cu > 256 || cl < 0 || cl > 256 || global_h <= 0 ||
      (H + ARMS_TH - 1) / ARMS_TH > 65535)
    return (int)cudaErrorInvalidValue;
  // the vertical reach: the longest in-bounds walk of any row, UP from
  // the last row (g = H - 1 + row0) or DOWN from the first (g = row0)
  const int reach = max(H - 1 + row0, global_h - 1 - row0);
  const int rv = max(min(usd, reach), 0), rh = min(usd, W - 1);
  const size_t smem = arms_smem_bytes(rv, rh);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const bool small = cu >= 1 && cu <= 128 && cl >= 1 && cl <= 128;
  auto kernel = small ? cross_arms_kernel<true> : cross_arms_kernel<false>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ArmsEyes eyes;
  eyes.img[0] = (const uint8_t*)img_l;
  eyes.img[1] = (const uint8_t*)img_r;
  eyes.arms[0] = (int*)arms_l;
  eyes.arms[1] = (int*)arms_r;
  dim3 grid((W + ARMS_TW - 1) / ARMS_TW, (H + ARMS_TH - 1) / ARMS_TH,
            n_eyes);
  kernel<<<grid, ARMS_THREADS, smem, (cudaStream_t)stream>>>(
      eyes, H, W, arms_test(cu), arms_test(cl), usd, lsd, rv, rh, row0,
      global_h);
  return (int)cudaGetLastError();
}
