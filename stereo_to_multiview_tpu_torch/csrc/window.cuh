// Half-open window sum along one axis of a volume with D innermost,
// shared by the horizontal (hpass.cu) and vertical (vpass.cu) passes.
//
// A volume element is addressed as (line, pos, d): base + line * s.line +
// pos * s.pos + d.  For every pos of one line and every d:
//   y(pos, d) = sum_{q in [pos - an, pos + ap)} in(line, q, d)
// with an/ap = the arms at (line, pos) clamped to [0, reach] and the
// window clipped to [0, n).  An arm of 0 excludes the anchor side.  The
// sum is rescaled by floor(y * 2^-shift + 0.5) = (y + 2^(shift-1)) >>
// shift (y >= 0; shift 0 is no rescale).  All arithmetic is int32 and
// exact: the TPU kernels' bf16 digit dots reproduce these integers.
//
// One block handles `tile` positions of one line; thread d owns column
// d.  It first builds the exclusive prefix sums of its column over the
// reachable range [p0 - reach, p0 + tile + reach) in shared memory
// (loads are coalesced: a warp reads 32 consecutive d of one position),
// and the block stages each position's window bounds (from the arms) in
// shared memory, so the per-position loop waits on no device-memory
// load; then each output is two shared-memory reads.  With WTA,
// the block reduces each position's D sums to the FIRST minimum
// (__reduce_min_sync + __ballot_sync per warp, then across warps in
// warp order) and writes disp = argmin - zd as float.
#pragma once

#include "stm_common.cuh"

struct Strides {
  long long line, pos;
};

template <typename TIn, bool WTA>
__device__ __forceinline__ void window_pass(
    const TIn* __restrict__ in, Strides si,
    const int* __restrict__ arm_neg, const int* __restrict__ arm_pos,
    Strides sa, int32_t* __restrict__ out, Strides so,
    float* __restrict__ disp, Strides sd, int n, int D, int reach,
    int shift, int zd, int line, int p0, int tile, int* win, int32_t* pre,
    unsigned* wmin, int* warg) {
  const int d = threadIdx.x;
  const bool live = d < D;
  const int lo_c = max(p0 - reach, 0);
  const int p1 = min(p0 + tile, n);
  const int hi_c = min(p1 + reach, n);

  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const long long ai = line * sa.line + p * sa.pos;
    const int an = min(max(arm_neg[ai], 0), reach);
    const int ap = min(max(arm_pos[ai], 0), reach);
    win[p - p0] = (max(p - an, 0) - lo_c) * D;             // prefix rows,
    win[tile + p - p0] = (min(p + ap, n) - lo_c) * D;      // as offsets
  }

  if (live) {
    const TIn* src = in + line * si.line + d;
    int32_t acc = 0;
    pre[d] = 0;
    int32_t* dst = pre + D + d;
#pragma unroll 4
    for (int q = lo_c; q < hi_c; ++q) {
      acc += (int32_t)src[q * si.pos];
      *dst = acc;
      dst += D;
    }
  }

  __syncthreads();

  const int32_t half = shift > 0 ? (1 << (shift - 1)) : 0;
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  for (int p = p0; p < p1; ++p) {
    int32_t s = 0;
    if (live)
      s = (pre[win[tile + p - p0] + d] - pre[win[p - p0] + d] + half) >>
          shift;
    if (!WTA) {
      if (live) out[line * so.line + p * so.pos + d] = s;
    } else {
      const unsigned v = live ? (unsigned)s : 0xFFFFFFFFu;
      const unsigned m = __reduce_min_sync(0xFFFFFFFFu, v);
      const unsigned hit = __ballot_sync(0xFFFFFFFFu, v == m);
      if ((threadIdx.x & 31) == 0) {
        wmin[(p - p0) * nw + warp] = m;
        warg[(p - p0) * nw + warp] = (warp << 5) + __ffs(hit) - 1;
      }
    }
  }

  if (WTA) {
    __syncthreads();
    for (int t = threadIdx.x; t < p1 - p0; t += blockDim.x) {
      unsigned best = wmin[t * nw];
      int arg = warg[t * nw];
      for (int w = 1; w < nw; ++w) {
        if (wmin[t * nw + w] < best) {   // strict: the first minimum wins
          best = wmin[t * nw + w];
          arg = warg[t * nw + w];
        }
      }
      disp[line * sd.line + (p0 + t) * sd.pos] = (float)(arg - zd);
    }
  }
}

// Shared memory of one block: window bounds, prefix sums, then the WTA
// scratch.
static inline size_t window_smem(int tile, int reach, int D, int threads,
                                 bool wta) {
  size_t bytes = (size_t)(2 * tile + (tile + 2 * reach + 1) * D) *
                 sizeof(int32_t);
  if (wta) bytes += (size_t)tile * (threads / 32) * 2 * sizeof(int32_t);
  return bytes;
}
