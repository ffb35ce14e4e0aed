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
// (~5 us), against 225 taps a pixel of six float32 operations that the
// exactness keeps apart (a subtraction, the floor, two products, two
// sums): 2.8 G, each issued on its own.
//
// Design.  The range weight is a function of the integer t alone: each
// block builds rw(t) for t < 128 in shared memory with the very
// expression above (so the table is bit-equal to it by construction),
// replicated once a lane ([t][lane]: every lookup is free of bank
// conflicts).  The index is floor(|a - s|) by one float add rounded down,
// __fadd_rd(u, 2^23) = 2^23 + floor(u) for 0 <= u < 2^23, read off as the
// bits of the sum minus those of 2^23: an add at the FP32 rate where
// floorf and a float-to-int conversion issue at the conversion units'
// rate (16 a clock per SM).  A u of 2^23 or
// more, an infinity or a NaN gives an index of 2^23 or more and takes the
// direct expression, as does every t >= 128.  A block whose tile (halo
// included) is finite and spans less than 128 cannot reach either, since
// |a - s| rounds to at most max - min: it runs the taps without the check
// and its branch (on the main path disparities lie in [-64, 64)).  The
// block's tile and its clamped 2r halo are staged in shared memory once;
// each thread takes 4 vertically adjacent pixels, so one column of 4 + 2r
// samples serves all four, each keeping its own dx-outer, dy-inner order.
// No --use_fast_math and no FTZ (kernels.py): denormal weights stay as
// torch.exp gives them.

#include <climits>

#include "stm_common.cuh"

#define BILAT_MAX_R 8
#define BILAT_TX 32                 // threads of a block row (one warp)
#define BILAT_TY 8
#define BILAT_RY 4                  // vertically adjacent pixels a thread
#define BILAT_T 128                 // entries of the range-weight table
#define BILAT_BIAS 0x4B000000u      // the bits of 2^23

struct BilatTaps {
  float w[(2 * BILAT_MAX_R + 1) * (2 * BILAT_MAX_R + 1)];
};

// The range weight of one tap, directly.
__device__ __forceinline__ float bilat_rw(float t, float inv_2var,
                                          float lut_scale) {
  return __fmul_rn(expf(__fmul_rn(-__fmul_rn(t, t), inv_2var)), lut_scale);
}

__device__ __noinline__ float bilat_direct(float u, float inv_2var,
                                           float lut_scale) {
  return bilat_rw(floorf(u), inv_2var, lut_scale);
}

// The bits of a float as an int that orders as the floats do (not NaN),
// and back: the map is its own inverse.
__device__ __forceinline__ int bilat_flip(int i) {
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

// The taps of a thread's BILAT_RY pixels, dx outer, dy inner for each.
// TABLE_ONLY: every |a - s| of the tile is below BILAT_T (no branch).
template <int R, bool TABLE_ONLY>
__device__ __forceinline__ void bilat_taps(
    const float* __restrict__ tile, const float* __restrict__ sk,
    const float* __restrict__ lut, int tx, int r0,
    const float (&a)[BILAT_RY], float (&num)[BILAT_RY],
    float (&den)[BILAT_RY], float inv_2var, float lut_scale) {
  constexpr int K = 2 * R + 1;
  constexpr int TW = BILAT_TX + 2 * R;
#pragma unroll 1
  for (int c = 0; c < K; ++c) {                     // dx = c - R
    float skc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) skc[j] = sk[j * K + c];
    const float* col = tile + r0 * TW + tx + c;
#pragma unroll
    for (int jj = 0; jj < BILAT_RY + 2 * R; ++jj) { // sample rows
      const float s = col[jj * TW];
#pragma unroll
      for (int i = 0; i < BILAT_RY; ++i) {
        const int j = jj - i;                       // dy = j - R
        if (j < 0 || j >= K) continue;
        const float u = fabsf(__fsub_rn(a[i], s));
        const unsigned t =
            __float_as_uint(__fadd_rd(u, 8388608.0f)) - BILAT_BIAS;
        const float rw = TABLE_ONLY || t < BILAT_T
                             ? lut[t * BILAT_TX]
                             : bilat_direct(u, inv_2var, lut_scale);
        const float wgt = __fmul_rn(skc[j], rw);
        num[i] = __fadd_rn(num[i], __fmul_rn(wgt, s));
        den[i] = __fadd_rn(den[i], wgt);
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(BILAT_TX * BILAT_TY)
bilateral_kernel(const float* __restrict__ in, float* __restrict__ out,
                 BilatTaps taps, int H, int W, float inv_2var,
                 float lut_scale) {
  constexpr int K = 2 * R + 1;
  constexpr int TH = BILAT_TY * BILAT_RY + 2 * R;   // staged rows
  constexpr int TW = BILAT_TX + 2 * R;              // staged columns
  constexpr int NT = BILAT_TX * BILAT_TY;
  __shared__ float tile[TH * TW];
  __shared__ float table[BILAT_T * BILAT_TX];       // [t][lane]
  __shared__ float rw0[BILAT_T];
  __shared__ float sk[K * K];
  __shared__ int tile_lo, tile_hi, tile_bad;
  const int tid = threadIdx.y * BILAT_TX + threadIdx.x;
  const int bx = blockIdx.x * BILAT_TX;
  const int by = blockIdx.y * BILAT_TY * BILAT_RY;
  if (tid == 0) {
    tile_lo = INT_MAX;
    tile_hi = INT_MIN;
    tile_bad = 0;
  }
  for (int i = tid; i < K * K; i += NT) sk[i] = taps.w[i];
  for (int i = tid; i < BILAT_T; i += NT)
    rw0[i] = bilat_rw((float)i, inv_2var, lut_scale);
  float lo = INFINITY, hi = -INFINITY;
  bool bad = false;
  for (int i = tid; i < TH * TW; i += NT) {
    const int ys = min(max(by + i / TW - R, 0), H - 1);
    const int xs = min(max(bx + i % TW - R, 0), W - 1);
    const float v = in[(size_t)ys * W + xs];
    tile[i] = v;
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
    bad |= !isfinite(v);
  }
  __syncthreads();
  atomicMin(&tile_lo, bilat_flip(__float_as_int(lo)));
  atomicMax(&tile_hi, bilat_flip(__float_as_int(hi)));
  if (bad) tile_bad = 1;
  for (int i = tid; i < BILAT_T * BILAT_TX; i += NT) table[i] = rw0[i >> 5];
  __syncthreads();
  // |__fsub_rn(a, s)| <= __fsub_rn(max, min) for every pair of the tile
  // (rounding is monotone): below BILAT_T, every index is in the table
  const bool table_only =
      tile_bad == 0 &&
      __fsub_rn(__int_as_float(bilat_flip(tile_hi)),
                __int_as_float(bilat_flip(tile_lo))) <
          (float)BILAT_T;

  const int tx = threadIdx.x, r0 = threadIdx.y * BILAT_RY;
  float a[BILAT_RY], num[BILAT_RY], den[BILAT_RY];
#pragma unroll
  for (int i = 0; i < BILAT_RY; ++i) {
    a[i] = tile[(r0 + i + R) * TW + tx + R];
    num[i] = 0.0f;
    den[i] = 0.0f;
  }
  if (table_only)
    bilat_taps<R, true>(tile, sk, table + tx, tx, r0, a, num, den, inv_2var,
                        lut_scale);
  else
    bilat_taps<R, false>(tile, sk, table + tx, tx, r0, a, num, den,
                         inv_2var, lut_scale);
  const int x = bx + tx;
#pragma unroll
  for (int i = 0; i < BILAT_RY; ++i) {
    const int y = by + r0 + i;
    if (x < W && y < H) out[(size_t)y * W + x] = __fdiv_rn(num[i], den[i]);
  }
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
  const dim3 block(BILAT_TX, BILAT_TY);
  const dim3 grid((W + BILAT_TX - 1) / BILAT_TX,
                  (H + BILAT_TY * BILAT_RY - 1) / (BILAT_TY * BILAT_RY));
  const cudaStream_t s = (cudaStream_t)stream;
  const float* src = (const float*)in;
  float* dst = (float*)out;
#define BILAT_CASE(RR)                                                   \
  case RR:                                                               \
    bilateral_kernel<RR><<<grid, block, 0, s>>>(src, dst, taps, H, W,    \
                                                inv_2var, lut_scale);    \
    break;
  switch (r) {
    BILAT_CASE(0)
    BILAT_CASE(1)
    BILAT_CASE(2)
    BILAT_CASE(3)
    BILAT_CASE(4)
    BILAT_CASE(5)
    BILAT_CASE(6)
    BILAT_CASE(7)
    BILAT_CASE(8)
  }
#undef BILAT_CASE
  return (int)cudaGetLastError();
}
