// B2: AD-census cost, the pair volume of both eyes or one eye directly.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_cost_kernel_xm` (reached via `ci_adcensus_kern_xm`): shear=True, the
// pair volume; shear=False (and the JAX entry's fallback when the reach
// max(zd, D - zd) exceeds 64), one eye with sign +-1.
//
// P[y][xp][d], xp in [0, W + 2M), with k = d - zd,
//   xo = clamp(xp - M, 0, W-1),  xt = clamp(xp - M + sign * k, 0, W-1):
//   AD = |Ob(xo) - Tb(xt)| + |Og - Tg| + |Or - Tr|        (0..765)
//   H  = popc(Oc0(xo) ^ Tc0(xt)) + popc(Oc1 ^ Tc1)       (0..48)
// with O the own eye and T the other: the pair volume is O = L, T = R,
// sign +1 and M = max(zd, D - zd) (the left eye is P[:, M:M+W], the
// right eye its shear, shear.cu); the left eye alone is the same at
// M = 0, the right eye O = R, T = L, sign -1, M = 0 (AD and H are
// symmetric in the two eyes).  The cost of (AD, H), with the float32
// terms a[AD] = 1 - e^{-(AD * 0.33333333333) / l_ad} and
// c[H] = 1 - e^{-H / l_c} built once on the host (the TPU kernel's op
// order), is
//   u8, int16: rint(q * (a[AD] + c[H])) (u8 while round(2q) <= 255),
//              every operation rounded on its own (__fadd_rn, __fmul_rn,
//              __float2int_rn), so bit-equal to the host's table
//              (`cost_table`) of the same float32 operations;
//   float32:   a[AD] + c[H].
// Reads outside the image clamp to the edge column.
//
// Bound on the H100: the writes.  At 1080p/D=128 the pair volume is 283
// MB of u8 (~85 us at 3.35 TB/s), 566 MB of int16, 1.13 GB of float32;
// one eye directly 265 MB of u8.  Design: the two expf of the TPU kernel
// become lookups in the two term tables, 3.3 KB of shared memory a block
// (the whole u8 table, 37.5 KB a block, took 0.83-0.94 ms where the
// terms take 0.75 for twice the bytes in int16, on an H100).  The inner
// loop is one __vsadu4 for the three abs-diffs of byte-packed BGR, two
// __popc, two lookups, an add, a multiply and a conversion.  Each thread
// emits 4 consecutive disparities as one store of 4, 8 or 16 bytes, so a
// warp writes one x's 128 d contiguously; its image reads are one
// broadcast (own eye) and 32 consecutive columns (other eye).  A D that is no multiple of 4 leaves
// the rows unaligned for such stores: the thread then writes its (up to)
// 4 values one at a time, the last quad of a position cut at D.

#include "stm_common.cuh"

#define COST_AD 766
#define COST_HAM 49
#define COST_XP_PER_BLOCK 512
#define COST_THREADS 256

// the cost of (AD, H) from the terms tab = a[0..765] ++ c[0..48]
template <typename T>
__device__ __forceinline__ T cost_of(const float* tab, int ad, int ham,
                                     float q) {
  const float cost = __fadd_rn(tab[ad], tab[COST_AD + ham]);
  if constexpr (sizeof(T) == 4)
    return cost;
  else
    return (T)__float2int_rn(__fmul_rn(cost, q));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(COST_THREADS)
cost_pair_kernel(const uint32_t* __restrict__ own_pk,
                 const uint32_t* __restrict__ oth_pk,
                 const int2* __restrict__ own_cen,
                 const int2* __restrict__ oth_cen,
                 const float* __restrict__ ta, const float* __restrict__ tc,
                 float q, T* __restrict__ out, int W, int D, int zd, int M,
                 int sign) {
  __shared__ float tab[COST_AD + COST_HAM];
  for (int i = threadIdx.x; i < COST_AD + COST_HAM; i += blockDim.x)
    tab[i] = i < COST_AD ? ta[i] : tc[i - COST_AD];
  __syncthreads();

  const int y = blockIdx.y;
  const int wp = W + 2 * M;
  const int xp0 = blockIdx.x * COST_XP_PER_BLOCK;
  const int nx = min(COST_XP_PER_BLOCK, wp - xp0);
  const int quads = (D + 3) >> 2;
  const uint32_t* orow = own_pk + (size_t)y * W;
  const uint32_t* trow = oth_pk + (size_t)y * W;
  const int2* ocrow = own_cen + (size_t)y * W;
  const int2* tcrow = oth_cen + (size_t)y * W;
  T* dst_row = out + (size_t)y * wp * D;

  for (int t = threadIdx.x; t < nx * quads; t += blockDim.x) {
    const int xi = t / quads;
    const int xp = xp0 + xi;
    const int d0 = (t - xi * quads) * 4;
    const int xo = min(max(xp - M, 0), W - 1);
    const uint32_t op = orow[xo];
    const int2 oc = ocrow[xo];
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xt = min(max(xp - M + sign * (d0 + j - zd), 0), W - 1);
      const int2 tcv = tcrow[xt];
      const int ad = (int)__vsadu4(op, trow[xt]);
      const int ham = __popc(oc.x ^ tcv.x) + __popc(oc.y ^ tcv.y);
      v[j] = cost_of<T>(tab, ad, ham, q);
    }
    T* o = dst_row + (size_t)xp * D + d0;
    if (VEC) {
      stm_store4(o, v);
    } else {
      for (int j = 0; j < 4 && d0 + j < D; ++j) o[j] = v[j];
    }
  }
}

template <typename T>
static int launch_cost(const void* own_pk, const void* oth_pk,
                       const void* own_cen, const void* oth_cen,
                       const void* ta, const void* tc, float q, void* out,
                       int H, int W, int D, int zd, int M, int sign,
                       void* stream) {
  auto kernel = (D & 3) ? cost_pair_kernel<T, false>
                        : cost_pair_kernel<T, true>;
  dim3 grid((W + 2 * M + COST_XP_PER_BLOCK - 1) / COST_XP_PER_BLOCK, H);
  kernel<<<grid, COST_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)own_pk, (const uint32_t*)oth_pk,
      (const int2*)own_cen, (const int2*)oth_cen, (const float*)ta,
      (const float*)tc, q, (T*)out, W, D, zd, M, sign);
  return (int)cudaGetLastError();
}

// own_pk/oth_pk: (H, W) u32 packed b | g << 8 | r << 16; own_cen/oth_cen:
// (H, W, 2) i32 census words; ta (766), tc (49): the float32 terms; q:
// the quantization scale (elem_size 1: u8, 2: int16), unused for float32
// (elem_size 4); out: (H, W + 2M, D) of elem_size bytes.  The pair
// volume: own = L, other = R, M = max(zd, D - zd), sign 1; one eye:
// M = 0, own = that eye, sign 1 (left) or -1 (right).
STM_API int stm_cost_pair(const void* own_pk, const void* oth_pk,
                          const void* own_cen, const void* oth_cen,
                          const void* ta, const void* tc, float q, void* out,
                          int H, int W, int D, int zd, int M, int sign,
                          int elem_size, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > D || M < 0 ||
      H > 65535 || (sign != 1 && sign != -1))
    return (int)cudaErrorInvalidValue;
  switch (elem_size) {
    case 1:
      return launch_cost<uint8_t>(own_pk, oth_pk, own_cen, oth_cen, ta, tc,
                                  q, out, H, W, D, zd, M, sign, stream);
    case 2:
      return launch_cost<int16_t>(own_pk, oth_pk, own_cen, oth_cen, ta, tc,
                                  q, out, H, W, D, zd, M, sign, stream);
    case 4:
      return launch_cost<float>(own_pk, oth_pk, own_cen, oth_cen, ta, tc, q,
                                out, H, W, D, zd, M, sign, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
