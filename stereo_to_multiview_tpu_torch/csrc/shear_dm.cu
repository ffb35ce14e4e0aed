// B17: the right eye's disparity-major cost volume as per-plane shifts of
// the left eye's.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_shear_kernel` (reached via `_shear_right` from
// `ci_adcensus_kern(shift_extract=True)`).
//
// out[d][y][x] = vol[d][y][x - (d - zd)] where 0 <= x - (d - zd) < W, else 0.
// cost_r(x, d) = cost_l(x - (d - zd), d) wherever that column lies inside
// the image (the same pixel pair), so this is the right eye's cost but for
// the border columns, which the caller recomputes (B16, right-eye mode).
// The TPU kernel rolls each plane of a zero-padded copy by a static lane
// count; here each element is read at its shifted column directly.
//
// Bound on the H100: pure data movement, each element read and written
// once: at 1080p/D=128 265 MB each way in u8 (~0.16 ms at 3.35 TB/s), 1.06
// GB each way in float32 (~0.63 ms).  Design: one thread per (d, y, 4
// consecutive x), a block of 128 threads takes 512 columns of one row of
// one plane.  u8: where the four source bytes lie inside the row and rows
// are 4-byte aligned (W % 4 == 0), two aligned 32-bit loads and a funnel
// shift assemble them whatever the shift; one 32-bit store.  float32: four
// loads (consecutive threads read consecutive 16-byte groups) and one
// 16-byte store.  Other threads (row ends, unaligned rows) go element by
// element.

#include "stm_common.cuh"

#define SHEAR_DM_TX 128

__global__ void __launch_bounds__(SHEAR_DM_TX)
shear_dm_u8_kernel(const uint8_t* __restrict__ vol, uint8_t* __restrict__ out,
                   int H, int W, int zd) {
  const int x = (blockIdx.x * SHEAR_DM_TX + threadIdx.x) * 4;
  if (x >= W) return;
  const int d = blockIdx.z;
  const int xs = x - (d - zd);               // source column of x
  const size_t row = ((size_t)d * H + blockIdx.y) * W;
  const uint8_t* src = vol + row;
  uint8_t* dst = out + row;
  const bool aligned = (W & 3) == 0;
  const int a = xs & ~3;                      // aligned word holding xs
  if (aligned && xs >= 0 && a + 8 <= W) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(src + a);
    *reinterpret_cast<uint32_t*>(dst + x) =
        __funnelshift_r(w[0], w[1], 8 * (xs & 3));
    return;
  }
  uint8_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = xs + j;
    v[j] = (c >= 0 && c < W) ? src[c] : (uint8_t)0;
  }
  if (aligned) {                              // x + 3 < W
    *reinterpret_cast<uint32_t*>(dst + x) =
        v[0] | (v[1] << 8) | (v[2] << 16) | ((uint32_t)v[3] << 24);
  } else {
    for (int j = 0; j < 4 && x + j < W; ++j) dst[x + j] = v[j];
  }
}

__global__ void __launch_bounds__(SHEAR_DM_TX)
shear_dm_f32_kernel(const float* __restrict__ vol, float* __restrict__ out,
                    int H, int W, int zd) {
  const int x = (blockIdx.x * SHEAR_DM_TX + threadIdx.x) * 4;
  if (x >= W) return;
  const int d = blockIdx.z;
  const int xs = x - (d - zd);
  const size_t row = ((size_t)d * H + blockIdx.y) * W;
  const float* src = vol + row;
  float* dst = out + row;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = xs + j;
    v[j] = (c >= 0 && c < W) ? src[c] : 0.0f;
  }
  if ((W & 3) == 0) {                         // x + 3 < W, 16-byte aligned
    *reinterpret_cast<float4*>(dst + x) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && x + j < W; ++j) dst[x + j] = v[j];
  }
}

// vol, out: (D, H, W) contiguous, elem_size 1 (u8) or 4 (f32); 0 <= zd.
STM_API int stm_shear_dm(const void* vol, void* out, int H, int W, int D,
                         int zd, int elem_size, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || H > 65535 || D > 65535 ||
      (elem_size != 1 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + 4 * SHEAR_DM_TX - 1) / (4 * SHEAR_DM_TX), H, D);
  if (elem_size == 1)
    shear_dm_u8_kernel<<<grid, SHEAR_DM_TX, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)vol, (uint8_t*)out, H, W, zd);
  else
    shear_dm_f32_kernel<<<grid, SHEAR_DM_TX, 0, (cudaStream_t)stream>>>(
        (const float*)vol, (float*)out, H, W, zd);
  return (int)cudaGetLastError();
}
