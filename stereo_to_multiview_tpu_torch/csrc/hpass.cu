// B4/B6: the horizontal passes of the cross aggregation.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py `_res_kernel`
// in mode "int" (reached via `_band_pass_h` from `band_aggregate_q`):
//   pass 1 (B4): y = sum over [x - LEFT, x + RIGHT) of the u8 cost volume,
//                rescaled by s1, stored int32;
//   pass 4 (B6): the same sum of the int32 VV output, then the first-min
//                argmin over D: disp = argmin - zd as float32; or, for the
//                scanline optimisation that follows it when cfg.use_hslo
//                is set, the sum alone as an int32 volume (`_band_pass_h`
//                with out_dtype int32 and no WTA, band.py
//                `band_aggregate_q(zero_disp=None, final_out_t=True)`).
// Volumes are (H, W, D), D innermost; the u8 input may have a row stride
// larger than W*D (the left eye is a column slice of the pair volume).
//
// Bound on the H100: memory.  At 1080p/D=128 pass 1 reads 0.27 GB of u8
// and writes 1.06 GB of int32 per eye (~0.4 ms); pass 4 reads 1.06 GB
// and writes 8 MB (~0.32 ms), or 1.06 GB without the WTA (~0.64 ms).
// Design: per (row, 64-column tile) block,
// one thread per d builds its column's prefix sums over the tile plus the
// arm reach in shared memory (coalesced loads, each input read 1 +
// 2*usd/64 times, mostly from L2), so each output is one subtraction
// instead of a 2*usd+1 term sum; the WTA reduction happens in the block
// and the (H, W, D) aggregate of pass 4 never reaches device memory.
// See window.cuh.

#include "window.cuh"

#define HP_TILE 64

template <typename TIn, bool WTA>
__global__ void hpass_kernel(const TIn* __restrict__ in, long long in_row,
                             const int* __restrict__ an,
                             const int* __restrict__ ap,
                             int32_t* __restrict__ out,
                             float* __restrict__ disp, int W, int D,
                             int reach, int shift, int zd) {
  extern __shared__ int32_t smem[];
  int* win = smem;
  int32_t* pre = smem + 2 * HP_TILE;
  unsigned* wmin = reinterpret_cast<unsigned*>(
      pre + (size_t)(HP_TILE + 2 * reach + 1) * D);
  int* warg = reinterpret_cast<int*>(wmin + HP_TILE * (blockDim.x >> 5));
  const long long wd = (long long)W * D;
  window_pass<TIn, WTA>(in, Strides{in_row, D}, an, ap, Strides{W, 1},
                        out, Strides{wd, D}, disp, Strides{W, 1}, W, D,
                        reach, shift, zd, blockIdx.y,
                        blockIdx.x * HP_TILE, HP_TILE, win, pre, wmin, warg);
}

template <typename TIn, bool WTA>
static int launch_hpass(const void* in, long long in_row, const void* an,
                        const void* ap, void* out, void* disp, int H, int W,
                        int D, int reach, int shift, int zd, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || D > 1024 || reach < 0 || shift < 0 ||
      shift > 30)
    return (int)cudaErrorInvalidValue;
  const int threads = (D + 31) / 32 * 32;
  const size_t smem = window_smem(HP_TILE, reach, D, threads, WTA);
  cudaError_t err = stm_smem_cap(hpass_kernel<TIn, WTA>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + HP_TILE - 1) / HP_TILE, H);
  hpass_kernel<TIn, WTA><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const TIn*)in, in_row, (const int*)an, (const int*)ap,
      (int32_t*)out, (float*)disp, W, D, reach, shift, zd);
  return (int)cudaGetLastError();
}

// Pass 1: in (H, W, D) u8 with row stride in_row elements (x stride D);
// an/ap (H, W) i32; out (H, W, D) i32.
STM_API int stm_hpass_sum_u8(const void* in, long long in_row, const void* an,
                             const void* ap, void* out, int H, int W, int D,
                             int reach, int shift, void* stream) {
  return launch_hpass<uint8_t, false>(in, in_row, an, ap, out, nullptr, H, W,
                                      D, reach, shift, 0, stream);
}

// Pass 4 + WTA: in (H, W, D) i32 contiguous; an/ap (H, W) i32;
// disp (H, W) f32.
STM_API int stm_hpass_wta_i32(const void* in, const void* an, const void* ap,
                              void* disp, int H, int W, int D, int reach,
                              int zd, void* stream) {
  return launch_hpass<int32_t, true>(in, (long long)W * D, an, ap, nullptr,
                                     disp, H, W, D, reach, 0, zd, stream);
}

// Pass 4 without WTA: in (H, W, D) i32 contiguous; an/ap (H, W) i32;
// out (H, W, D) i32, rescaled by `shift` (0 on the ported path).
STM_API int stm_hpass_sum_i32(const void* in, const void* an, const void* ap,
                              void* out, int H, int W, int D, int reach,
                              int shift, void* stream) {
  return launch_hpass<int32_t, false>(in, (long long)W * D, an, ap, out,
                                      nullptr, H, W, D, reach, shift, 0,
                                      stream);
}
