// B18a/c: the horizontal passes of the cross aggregation in the
// disparity-major (2D, H, W) layout, both eyes in one volume (left eye on
// planes [0, D), right eye on [D, 2D)), int16 between the passes; the
// vertical passes between them (B18b) are in vvdm.cu.
//
// Replace the TPU kernels stereo_to_multiview_tpu/ops/band.py
// `_pass1_dm_kernel` (B18a) and `_pass4_dm_kernel` (B18c), reached via
// `band_aggregate_q_dm`:
//   pass 1:    y = sum over [x - LEFT, x + RIGHT) of the u8 cost, int16;
//   passes 2+3: two sums over [y - UP, y + DOWN), each rescaled by
//              floor(v * 2^-s + 0.5) = (v + 2^(s-1)) >> s, int16;
//   pass 4:    the horizontal sum again (int32, it reaches ~1.4M at
//              usd = 34), then the FIRST minimum over d per eye:
//              disp = argmin - zd as float32.
// Windows are half-open and clipped to the image; arms are clamped to
// [0, reach].  The TPU kernels multiply base-256 bf16 digit planes with
// 0/1 band matrices on the MXU and swap the two minor axes around the
// vertical passes; the integers are the same, and on this card they are
// prefix-sum differences in the layout as it is.
//
// Bound on the H100: bytes.  1080p/D=128, both eyes: pass 1 reads 531 MB
// and writes 1062 MB (~0.48 ms at 3.35 TB/s), passes 2+3 read and write
// 1062 MB (~0.63 ms), pass 4 reads 1062 MB (~0.32 ms).
//
// Horizontal passes (B18a, B18c): x is the contiguous axis, so the window
// runs along a row.  A block of 128 threads takes one row of one eye and a
// tile of columns plus the arm reach either side, 512 elements in all,
// and loops over the eye's D planes.  The arms do not depend on d: each
// thread keeps the window bounds of its 4 outputs in registers for the
// whole loop.  Per plane a thread loads 4 consecutive elements (one 4- or
// 8-byte load, the next plane's started before this plane's scan), the
// block scans them (registers, warp shuffles, one pass over the 4 warp
// sums) into exclusive prefixes in shared memory, and every output is one
// difference.  Pass 4 keeps each output's running minimum and its d in
// registers while d walks upward with a strict `<`: the first minimum
// needs no reduction across threads, and the aggregate never reaches
// device memory.

#include "stm_common.cuh"

#include <limits.h>

#define HDM_THREADS 128
#define HDM_SPAN (4 * HDM_THREADS)   // elements a block scans per plane

// Four consecutive elements of a row from column xs on (columns outside
// [0, W) read as 0).  `vec`: xs is a multiple of 4 and the row is aligned
// for one load of the four.
__device__ __forceinline__ void hdm_load4(const uint8_t* __restrict__ row,
                                          int xs, int W, bool vec,
                                          int v[4]) {
  if (vec && xs >= 0 && xs + 3 < W) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + xs);
    v[0] = w & 255u;
    v[1] = (w >> 8) & 255u;
    v[2] = (w >> 16) & 255u;
    v[3] = w >> 24;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (xs + j >= 0 && xs + j < W) ? (int)row[xs + j] : 0;
  }
}

__device__ __forceinline__ void hdm_load4(const int16_t* __restrict__ row,
                                          int xs, int W, bool vec,
                                          int v[4]) {
  if (vec && xs >= 0 && xs + 3 < W) {
    const int2 w = *reinterpret_cast<const int2*>(row + xs);
    v[0] = (int)(int16_t)(w.x & 0xFFFF);
    v[1] = w.x >> 16;
    v[2] = (int)(int16_t)(w.y & 0xFFFF);
    v[3] = w.y >> 16;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (xs + j >= 0 && xs + j < W) ? (int)row[xs + j] : 0;
  }
}

// in: (2D, H, W); arms (H, W) i32 per eye; WTA false: out (2D, H, W) i16;
// WTA true: disp_l/disp_r (H, W) f32.  grid (tiles, H, 2), TX columns a
// tile, R = reach rounded up to 4, TX + 2R <= HDM_SPAN, TX % 4 == 0.
template <typename TIn, bool WTA>
__global__ void __launch_bounds__(HDM_THREADS)
hdm_kernel(const TIn* __restrict__ in, const int* __restrict__ an_l,
           const int* __restrict__ ap_l, const int* __restrict__ an_r,
           const int* __restrict__ ap_r, int16_t* __restrict__ out,
           float* __restrict__ disp_l, float* __restrict__ disp_r, int H,
           int W, int D, int reach, int R, int TX, int zd, int vec) {
  __shared__ __align__(16) int pre[HDM_SPAN + 4];
  __shared__ int wsum[HDM_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int y = blockIdx.y, e = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int s0 = x0 - R;                        // first scanned column
  const int* an = e ? an_r : an_l;
  const int* ap = e ? ap_r : ap_l;
  const size_t plane = (size_t)H * W;
  const size_t row = (size_t)y * W;

  // the window of each of this thread's 4 outputs, as prefix indices
  const int xo = x0 + 4 * t;
  int lo[4], hi[4];
  bool has[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = xo + j;
    has[j] = 4 * t + j < TX && x < W;
    lo[j] = hi[j] = 0;
    if (has[j]) {
      const int a = min(max(an[row + x], 0), reach);
      const int p = min(max(ap[row + x], 0), reach);
      lo[j] = max(x - a, 0) - s0;
      hi[j] = min(x + p, W) - s0;
    }
  }
  const bool all4 = vec && has[3];              // one vector store / load

  const TIn* src = in + (size_t)e * D * plane + row;
  int16_t* dst = WTA ? nullptr : out + (size_t)e * D * plane + row + xo;
  int best[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  int arg[4] = {0, 0, 0, 0};
  int v[4], nv[4] = {0, 0, 0, 0};
  hdm_load4(src, s0 + 4 * t, W, vec != 0, v);

  for (int d = 0; d < D; ++d) {
    if (d + 1 < D)
      hdm_load4(src + (size_t)(d + 1) * plane, s0 + 4 * t, W, vec != 0, nv);
    const int c1 = v[0], c2 = c1 + v[1], c3 = c2 + v[2], c4 = c3 + v[3];
    int s = c4;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += n;
    }
    if (lane == 31) wsum[warp] = s;
    __syncthreads();
    int base = s - c4;                          // exclusive in the warp
    for (int w = 0; w < warp; ++w) base += wsum[w];
    // pre[i] = sum of the scanned elements before i
    *reinterpret_cast<int4*>(pre + 4 * t) =
        make_int4(base, base + c1, base + c2, base + c3);
    if (t == HDM_THREADS - 1) pre[HDM_SPAN] = base + c4;
    __syncthreads();
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = pre[hi[j]] - pre[lo[j]];
    if (WTA) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r[j] < best[j]) {                   // strict: first minimum
          best[j] = r[j];
          arg[j] = d;
        }
    } else {
      int16_t* o = dst + (size_t)d * plane;
      if (all4) {
        int2 w;
        w.x = (r[0] & 0xFFFF) | (r[1] << 16);
        w.y = (r[2] & 0xFFFF) | (r[3] << 16);
        *reinterpret_cast<int2*>(o) = w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (has[j]) o[j] = (int16_t)r[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = nv[j];
  }

  if (WTA) {
    float* o = (e ? disp_r : disp_l) + row + xo;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (has[j]) o[j] = (float)(arg[j] - zd);
  }
}

template <typename TIn, bool WTA>
static int launch_hdm(const void* in, const void* an_l, const void* ap_l,
                      const void* an_r, const void* ap_r, void* out,
                      void* disp_l, void* disp_r, int H, int W, int D,
                      int reach, int zd, void* stream) {
  if (H <= 0 || H > 65535 || W <= 0 || D <= 0 || reach < 0 || reach > 64)
    return (int)cudaErrorInvalidValue;
  const int R = (reach + 3) & ~3;
  const int tx_max = HDM_SPAN - 2 * R;
  const int tiles = (W + tx_max - 1) / tx_max;
  const int TX = ((W + tiles - 1) / tiles + 3) & ~3;    // balanced tiles
  // vector loads and stores: every row start a multiple of 4 elements
  // from a 16-byte aligned base
  const int vec = W % 4 == 0 && (uintptr_t)in % 16 == 0 &&
                  (WTA || (uintptr_t)out % 16 == 0);
  dim3 grid(tiles, H, 2);
  hdm_kernel<TIn, WTA><<<grid, HDM_THREADS, 0, (cudaStream_t)stream>>>(
      (const TIn*)in, (const int*)an_l, (const int*)ap_l, (const int*)an_r,
      (const int*)ap_r, (int16_t*)out, (float*)disp_l, (float*)disp_r, H, W,
      D, reach, R, TX, zd, vec);
  return (int)cudaGetLastError();
}

// Pass 1 (B18a): in (2D, H, W) u8; left/right arms of each eye (H, W) i32;
// out (2D, H, W) i16.  reach <= 64 keeps every sum below 2^15.
STM_API int stm_pass1_dm(const void* in, const void* left_l,
                         const void* right_l, const void* left_r,
                         const void* right_r, void* out, int H, int W, int D,
                         int reach, void* stream) {
  return launch_hdm<uint8_t, false>(in, left_l, right_l, left_r, right_r, out,
                                    nullptr, nullptr, H, W, D, reach, 0,
                                    stream);
}

// Pass 4 + WTA (B18c): in (2D, H, W) i16 (values >= 0); disp_l, disp_r
// (H, W) f32.
STM_API int stm_pass4_wta_dm(const void* in, const void* left_l,
                             const void* right_l, const void* left_r,
                             const void* right_r, void* disp_l, void* disp_r,
                             int H, int W, int D, int reach, int zd,
                             void* stream) {
  return launch_hdm<int16_t, true>(in, left_l, right_l, left_r, right_r,
                                   nullptr, disp_l, disp_r, H, W, D, reach,
                                   zd, stream);
}
