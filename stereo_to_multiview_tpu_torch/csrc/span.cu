// B15: window sums of a float volume along one axis, in bf16 terms.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py `_res_kernel`
// in mode "float" (reached via `band_span_sum_h` / `band_span_sum_v`, and
// through them `dr_irv_band` / `dr_irv_band_lr`).
//
// vol is (H, W, D) float32; the summed axis is x (the H pass) or y (the V
// pass), the other image axis indexes independent lines, d is innermost.
//   out[p] = sum over j in [max(p - an, 0), min(p + ap + incl, n)) of t[j]
//   t = recombination of nsplit successive bf16 remainders of vol:
//       r = x; t = bf16(r); r -= bf16(r); t += bf16(r); ...   (each
//       bf16() rounds to nearest even, every add rounded on its own)
// with an, ap the (H, W) arms of p clamped to [0, max_arm].  The TPU kernel
// takes the same terms into banded 0/1 bf16 matrix products on the MXU;
// here each window is summed in float32 from +0.0 in ascending position
// order, no FMA, so the plain PyTorch version that adds the shifted
// planes in the same order is bit-equal; prefix differences only where
// they give the same bits (below; a 1920-long float prefix of fractions
// loses the last bits of a short window).
//
// Bound on the H100: bytes.  At 1080p/D=128 with both eyes stacked (2160
// lines) the call reads and writes 2.12 GB each, ~1.27 ms at 3.35 TB/s;
// the adds (window length x elements, ~18 G at usd = 34) take ~0.55 ms at
// the card's 33.4 T float32 adds a second.
//
// A block takes TN <= 256 positions of one line for 32 consecutive d (one
// warp's lanes, so every load and store is 128 contiguous bytes in either
// pass) and stages them with a halo of max_arm + 1 either side in shared
// memory (42.8 KB at usd = 34: five blocks, 40 warps an SM), splitting
// each element into its bf16 terms once as it is staged.  Then one of two
// ways, both bit-equal to the ascending sum:
//  - Where every staged term of the block is an integer of magnitude at
//    most 2^15 (the IRV one-hot of `dr_irv_band`, small-integer volumes),
//    every partial sum in any order is an exact integer below 2^24, so the
//    order cannot show: the block scans its rows into prefixes in place
//    (a chunk of rows a warp, then the chunks' offsets) and each output is
//    one difference.  One term past the bound, or any fraction, infinity
//    or NaN, sends the block the other way.
//  - Else each window is summed term by term.  The first version read one
//    staged element from shared memory for every add; here a thread owns
//    K = SPAN_K = 4 consecutive positions of its d (2 and 8 were slower
//    on the card, PERF.md): it walks j upward once over the union of
//    their K windows, reads each staged element once into a register and
//    adds it to every accumulator whose window holds j, each accumulator
//    still from +0.0 in ascending order.  The walk has three parts: the ragged starts
//    [lo_min, lo_max) with one compare a term, the span that every window
//    holds [lo_max, hi_min) with none, and the ragged ends [hi_min,
//    hi_max); windows that do not all overlap take one loop with both
//    compares.  The window bounds depend on the position only, so a warp's
//    lanes share them and never diverge.
// What bounds it now: the term-by-term walk by its instruction rate (the adds
// and the compares at the ragged ends); the prefix blocks by their two
// extra passes over the staged rows beside the bytes.

#include <cuda_bf16.h>

#include "stm_common.cuh"

#define SPAN_LANES 32      // d a block
#define SPAN_WARPS 8
#define SPAN_TN_MAX 256    // positions along the summed axis a block
#define SPAN_LOADS 8       // staged rows a thread loads at once
#define SPAN_MAX_ARM 64
#define SPAN_INT_MAX 32768.0f  // integer terms up to this take prefixes
#define SPAN_K 4           // consecutive positions a thread sums

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The float32 recombination of x's nsplit bf16 terms.
__device__ __forceinline__ float split_terms(float x, int nsplit) {
  float part = bf16_rn(x);
  float t = part;
  float r = x;
  for (int k = 1; k < nsplit; ++k) {
    r = __fsub_rn(r, part);
    part = bf16_rn(r);
    t = __fadd_rn(t, part);
  }
  return t;
}

// n positions along the summed axis at element stride sn; line o starts at
// element o * so; the arm of (line o, position p) is at o * ao + p * ap_.
// A block: TN positions (a multiple of SPAN_K) of line blockIdx.y from
// blockIdx.x * TN on, d from blockIdx.z * 32 on.
__global__ void __launch_bounds__(SPAN_LANES * SPAN_WARPS)
span_sum_kernel(const float* __restrict__ vol, const int* __restrict__ arm_neg,
                const int* __restrict__ arm_pos, float* __restrict__ out,
                int n, long long sn, long long so, int ao, int ap_, int D,
                int max_arm, int incl, int nsplit, int TN) {
  extern __shared__ float stage[];       // (TN + 2R) x SPAN_LANES, then
                                         // SPAN_WARPS x SPAN_LANES sums
  const int R = max_arm + 1;
  const int p0 = blockIdx.x * TN;
  const int base = p0 - R;               // position of staged row 0
  const size_t line = (size_t)blockIdx.y * so;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int d = blockIdx.z * SPAN_LANES + lane;
  const bool live = d < D;

  // stage the positions [p0 - R, p0 + TN + R) that lie in [0, n)
  const int r_lo = max(-base, 0);
  const int r_hi = min(TN + 2 * R, n - base);
  const float* src = vol + line + d;
  bool small_int = true;       // every term this thread staged is one
  for (int r0 = r_lo + warp; r0 < r_hi; r0 += SPAN_WARPS * SPAN_LOADS) {
    float v[SPAN_LOADS];
#pragma unroll
    for (int u = 0; u < SPAN_LOADS; ++u) {
      const int r = r0 + u * SPAN_WARPS;
      v[u] = live && r < r_hi ? src[(size_t)(base + r) * sn] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SPAN_LOADS; ++u) {
      const int r = r0 + u * SPAN_WARPS;
      if (r < r_hi) {
        const float t = split_terms(v[u], nsplit);
        small_int &= t == rintf(t) && fabsf(t) <= SPAN_INT_MAX;
        stage[r * SPAN_LANES + lane] = t;
      }
    }
  }
  const int np = min(TN, n - p0);
  const int* an = arm_neg + (size_t)blockIdx.y * ao;
  const int* ap = arm_pos + (size_t)blockIdx.y * ao;
  if (__syncthreads_and(small_int)) {
    // Integers of at most 2^15 in every staged row: every partial sum, in
    // any order, is an integer below 2^24 (386 rows at most), exact in
    // float32, so each window is a difference of two exact prefixes and
    // equals the ascending sum bit for bit (a zero sum is +0.0 both
    // ways).  Prefix P(j) of the staged rows [r_lo, j), in place: each
    // warp scans a contiguous chunk of rows, then adds the chunks before.
    float* sums = stage + (TN + 2 * R) * SPAN_LANES;
    const int chunk = (r_hi - r_lo + SPAN_WARPS - 1) / SPAN_WARPS;
    const int c0 = r_lo + warp * chunk, c1 = min(c0 + chunk, r_hi);
    float run = 0.0f;
    for (int r = c0; r < c1; ++r) {
      run = __fadd_rn(run, stage[r * SPAN_LANES + lane]);
      stage[r * SPAN_LANES + lane] = run;
    }
    sums[warp * SPAN_LANES + lane] = run;
    __syncthreads();
    float off = 0.0f;
    for (int w = 0; w < warp; ++w)
      off = __fadd_rn(off, sums[w * SPAN_LANES + lane]);
    if (off != 0.0f)
      for (int r = c0; r < c1; ++r)
        stage[r * SPAN_LANES + lane] =
            __fadd_rn(stage[r * SPAN_LANES + lane], off);
    __syncthreads();
    // stage[r] now holds P(r + 1)
    for (int i = warp; i < np; i += SPAN_WARPS) {
      const int p = p0 + i;
      const size_t a = (size_t)p * ap_;
      const int neg = min(max(an[a], 0), max_arm);
      const int pos = min(max(ap[a], 0), max_arm);
      const int lo = max(p - neg, 0) - base;
      const int hi = min(p + pos + incl, n) - base;
      const float* col = stage + lane;
      const float s_hi = hi > r_lo ? col[(hi - 1) * SPAN_LANES] : 0.0f;
      const float s_lo = lo > r_lo ? col[(lo - 1) * SPAN_LANES] : 0.0f;
      if (live) out[line + (size_t)p * sn + d] = __fsub_rn(s_hi, s_lo);
    }
    return;
  }

  // col[j * SPAN_LANES]: the staged term of position j + base
  const float* col = stage + lane;
  for (int g = warp * SPAN_K; g < np; g += SPAN_WARPS * SPAN_K) {
    // the K windows as staged rows [lo, hi); a position past the line
    // gets the empty window [lo[0], lo[0]), which takes no term and moves
    // none of the bounds below the others
    int lo[SPAN_K], hi[SPAN_K];
#pragma unroll
    for (int k = 0; k < SPAN_K; ++k) {
      const int p = p0 + g + k;
      if (g + k < np) {
        const size_t a = (size_t)p * ap_;
        const int neg = min(max(an[a], 0), max_arm);
        const int pos = min(max(ap[a], 0), max_arm);
        lo[k] = max(p - neg, 0) - base;
        hi[k] = min(p + pos + incl, n) - base;
      } else {
        lo[k] = hi[k] = lo[0];
      }
    }
    int lo_min = lo[0], lo_max = lo[0], hi_min = hi[0], hi_max = hi[0];
#pragma unroll
    for (int k = 1; k < SPAN_K; ++k) {
      lo_min = min(lo_min, lo[k]);
      lo_max = max(lo_max, lo[k]);
      hi_min = min(hi_min, hi[k]);
      hi_max = max(hi_max, hi[k]);
    }
    float acc[SPAN_K];
#pragma unroll
    for (int k = 0; k < SPAN_K; ++k) acc[k] = 0.0f;
    if (lo_max <= hi_min) {
      // ragged starts: j < lo_max <= hi_min <= every hi
      for (int j = lo_min; j < lo_max; ++j) {
        const float v = col[j * SPAN_LANES];
#pragma unroll
        for (int k = 0; k < SPAN_K; ++k)
          if (j >= lo[k]) acc[k] = __fadd_rn(acc[k], v);
      }
      // every window holds [lo_max, hi_min)
      int j = lo_max;
      for (; j + 4 <= hi_min; j += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = col[(j + u) * SPAN_LANES];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < SPAN_K; ++k) acc[k] = __fadd_rn(acc[k], v[u]);
      }
      for (; j < hi_min; ++j) {
        const float v = col[j * SPAN_LANES];
#pragma unroll
        for (int k = 0; k < SPAN_K; ++k) acc[k] = __fadd_rn(acc[k], v);
      }
      // ragged ends: j >= hi_min >= lo_max >= every lo
      for (j = hi_min; j < hi_max; ++j) {
        const float v = col[j * SPAN_LANES];
#pragma unroll
        for (int k = 0; k < SPAN_K; ++k)
          if (j < hi[k]) acc[k] = __fadd_rn(acc[k], v);
      }
    } else {
      for (int j = lo_min; j < hi_max; ++j) {
        const float v = col[j * SPAN_LANES];
#pragma unroll
        for (int k = 0; k < SPAN_K; ++k)
          if (j >= lo[k] && j < hi[k]) acc[k] = __fadd_rn(acc[k], v);
      }
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < SPAN_K; ++k)
        if (g + k < np) out[line + (size_t)(p0 + g + k) * sn + d] = acc[k];
    }
  }
}

// vol, out: (H, W, D) f32 contiguous; arm_neg, arm_pos: (H, W) i32;
// axis 1 sums along x (the H pass), axis 0 along y (the V pass);
// incl != 0 closes the window's right end; 1 <= nsplit <= 3;
// max_arm <= 64.
STM_API int stm_span_sum(const void* vol, const void* arm_neg,
                         const void* arm_pos, void* out, int H, int W, int D,
                         int axis, int max_arm, int incl, int nsplit,
                         void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || (axis != 0 && axis != 1) ||
      max_arm < 0 || max_arm > SPAN_MAX_ARM || nsplit < 1 || nsplit > 3)
    return (int)cudaErrorInvalidValue;
  const long long row = (long long)W * D;
  // H pass: lines are rows y, positions x; V pass: lines are columns x.
  const int n = axis == 1 ? W : H;
  const int lines = axis == 1 ? H : W;
  const long long sn = axis == 1 ? D : row;
  const long long so = axis == 1 ? row : D;
  const int ao = axis == 1 ? W : 1;
  const int ap_ = axis == 1 ? 1 : W;
  if (lines > 65535) return (int)cudaErrorInvalidValue;
  // balanced tiles of at most SPAN_TN_MAX positions, a multiple of SPAN_K
  const int tiles = (n + SPAN_TN_MAX - 1) / SPAN_TN_MAX;
  const int TN = ((n + tiles - 1) / tiles + SPAN_K - 1) / SPAN_K * SPAN_K;
  const size_t smem = (size_t)(TN + 2 * (max_arm + 1) + SPAN_WARPS) *
                      SPAN_LANES * sizeof(float);
  cudaError_t err = stm_smem_cap(span_sum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, lines, (D + SPAN_LANES - 1) / SPAN_LANES);
  dim3 block(SPAN_LANES, SPAN_WARPS);
  span_sum_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)vol, (const int*)arm_neg, (const int*)arm_pos,
      (float*)out, n, sn, so, ao, ap_, D, max_arm, incl ? 1 : 0, nsplit, TN);
  return (int)cudaGetLastError();
}
