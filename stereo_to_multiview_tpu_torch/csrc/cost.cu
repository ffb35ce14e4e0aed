// B2: quantized AD-census cost, the pair volume of both eyes.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_cost_kernel_xm` (reached via `ci_adcensus_kern_xm`, shear=True).
//
// P[y][xp][d], xp in [0, W + 2M), with k = d - zd,
//   xl = clamp(xp - M, 0, W-1),  xr = clamp(xp - M + k, 0, W-1):
//   AD = |Lb(xl) - Rb(xr)| + |Lg - Rg| + |Lr - Rr|        (0..765)
//   H  = popc(Lc0(xl) ^ Rc0(xr)) + popc(Lc1 ^ Rc1)       (0..48)
//   P  = table[AD * 49 + H]
// The table holds rint(127 * ((1 - e^{-(AD * 0.33333333333) / l_ad})
// + (1 - e^{-H / l_c}))) as u8, built once on the host in float32 with
// the TPU kernel's op order.  The left eye is P[:, M:M+W]; the right eye
// is the shear of P (shear.cu).  Reads outside the image clamp to the
// edge column.
//
// Bound on the H100: the 1080p/D=128 pair volume is 283 MB of u8 output
// against 46 MB of input, so the kernel is bound by its writes (~85 us at
// 3.35 TB/s).  Design: the 766 x 49 input domain is small, so the two
// expf of the TPU kernel become one lookup in a 37.5 KB shared-memory
// table: the inner loop is integer work only (one __vsadu4 for the three
// abs-diffs of byte-packed BGR, two __popc, one lookup).  Each thread
// emits 4 consecutive disparities as one 32-bit store, so a warp writes
// 128 contiguous bytes (one x, 128 d); the image reads of a warp are one
// broadcast (L) and 32 consecutive columns (R).  A D that is no multiple
// of 4 leaves the rows unaligned for such stores: the thread then writes
// its (up to) 4 bytes one at a time, the last quad of a position cut at D.

#include "stm_common.cuh"

#define STM_TABLE_SIZE (766 * 49)
#define COST_XP_PER_BLOCK 512
#define COST_THREADS 256

template <bool VEC>
__global__ void __launch_bounds__(COST_THREADS)
cost_pair_kernel(const uint32_t* __restrict__ lpk,
                 const uint32_t* __restrict__ rpk,
                 const int2* __restrict__ lcen,
                 const int2* __restrict__ rcen,
                 const uint8_t* __restrict__ table,
                 uint8_t* __restrict__ out, int W, int D, int zd, int M) {
  __shared__ uint8_t tab[STM_TABLE_SIZE];
  for (int i = threadIdx.x; i < STM_TABLE_SIZE; i += blockDim.x)
    tab[i] = table[i];
  __syncthreads();

  const int y = blockIdx.y;
  const int wp = W + 2 * M;
  const int xp0 = blockIdx.x * COST_XP_PER_BLOCK;
  const int nx = min(COST_XP_PER_BLOCK, wp - xp0);
  const int quads = (D + 3) >> 2;
  const uint32_t* lrow = lpk + (size_t)y * W;
  const uint32_t* rrow = rpk + (size_t)y * W;
  const int2* lcrow = lcen + (size_t)y * W;
  const int2* rcrow = rcen + (size_t)y * W;
  uint8_t* orow = out + (size_t)y * wp * D;

  for (int t = threadIdx.x; t < nx * quads; t += blockDim.x) {
    const int xi = t / quads;
    const int xp = xp0 + xi;
    const int d0 = (t - xi * quads) * 4;
    const int xl = min(max(xp - M, 0), W - 1);
    const uint32_t lp = lrow[xl];
    const int2 lc = lcrow[xl];
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xr = min(max(xp - M + d0 + j - zd, 0), W - 1);
      const int2 rc = rcrow[xr];
      const int ad = (int)__vsadu4(lp, rrow[xr]);
      const int ham = __popc(lc.x ^ rc.x) + __popc(lc.y ^ rc.y);
      packed |= (uint32_t)tab[ad * 49 + ham] << (8 * j);
    }
    uint8_t* o = orow + (size_t)xp * D + d0;
    if (VEC) {
      *reinterpret_cast<uint32_t*>(o) = packed;
    } else {
      for (int j = 0; j < 4 && d0 + j < D; ++j)
        o[j] = (uint8_t)(packed >> (8 * j));
    }
  }
}

// lpk/rpk: (H, W) u32 packed b | g << 8 | r << 16; lcen/rcen: (H, W, 2)
// i32 census words; table: 766*49 u8; out: (H, W + 2M, D) u8 with
// M = max(zd, D - zd).
STM_API int stm_cost_pair(const void* lpk, const void* rpk, const void* lcen,
                          const void* rcen, const void* table, void* out,
                          int H, int W, int D, int zd, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > D)
    return (int)cudaErrorInvalidValue;
  const int M = zd > D - zd ? zd : D - zd;
  dim3 grid((W + 2 * M + COST_XP_PER_BLOCK - 1) / COST_XP_PER_BLOCK, H);
  auto kernel = (D & 3) ? cost_pair_kernel<false> : cost_pair_kernel<true>;
  kernel<<<grid, COST_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lpk, (const uint32_t*)rpk, (const int2*)lcen,
      (const int2*)rcen, (const uint8_t*)table, (uint8_t*)out, W, D, zd, M);
  return (int)cudaGetLastError();
}
