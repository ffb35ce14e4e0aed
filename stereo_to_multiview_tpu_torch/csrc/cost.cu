// B2: AD-census cost of a row range of the frame, the pair volume of both
// eyes or one eye directly, with the grayscale and the 9x7 census
// computed in the kernel from the two images.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_cost_kernel_xm` and the census prologue of `_cost_planes_xm` (reached
// via `ci_adcensus_kern_xm`): shear=True, the pair volume; shear=False
// (and the JAX entry's fallback when the reach max(zd, D - zd) exceeds
// 64), one eye with sign +-1.
//
// For the frame rows y in [row0, row0 + nrows):
// P[y - row0][xp][d], xp in [0, W + 2M), with k = d - zd,
//   xo = clamp(xp - M, 0, W-1),  xt = clamp(xp - M + sign * k, 0, W-1):
//   AD = |Ob(xo) - Tb(xt)| + |Og - Tg| + |Or - Tr|        (0..765)
//   H  = popc(Oc0(y, xo) ^ Tc0(y, xt)) + popc(Oc1 ^ Tc1)  (0..48)
// with O the own eye and T the other: the pair volume is O = L, T = R,
// sign +1 and M = max(zd, D - zd) (the left eye is P[:, M:M+W], the
// right eye its shear, shear.cu); the left eye alone is the same at
// M = 0, the right eye O = R, T = L, sign -1, M = 0 (AD and H are
// symmetric in the two eyes).  The census codes Oc, Tc are the port's
// `census_transform_9x7(mux_average(img))` of the whole frame: gray =
// trunc(b * c + g * c + r * c), c = float32(0.3333333333333), each
// product and sum rounded on its own (no contraction); two words of 24
// bits, rows dy in {-3,-2,-1} and {1,2,3}, dx in {-4..4} minus 0, raster
// order, shift-then-set, bit set iff neighbour < center, reads clamped to
// the frame's edges (never to the row range's); the device code that
// stages them is shared with B16 (csrc/census.cuh).  The cost of (AD, H) is
//   u8, int16: the host's table `cost_table`, rint(q * (a[AD] + c[H]))
//              in float32 (u8 while round(2q) <= 255), the values of the
//              plain version by construction;
//   float32:   a[AD] + c[H], rounded once (__fadd_rn), of the float32
//              terms a[AD] = 1 - e^{-(AD * 0.33333333333) / l_ad} and
//              c[H] = 1 - e^{-H / l_c} built once on the host (the TPU
//              kernel's op order).
//
// Bound on the H100: the writes and the two images read once.  At
// 1080p/D=128 the pair volume is 283 MB of u8 (~85 us at 3.35 TB/s), 566
// MB of int16, 1.13 GB of float32; one eye directly 265 MB of u8.
// Design: a block takes 4 rows and 256 columns of the volume.  It stages
// the gray of the 10 frame rows around them for the own eye's 256
// columns and the other eye's 256 + 16 * ceil(D / 16) columns (the reach
// of the disparities), computes each staged column's census there (four
// columns at a time in 16-bit lanes where they lie inside the frame),
// and keeps pixel and census of each staged column in shared memory,
// clamped while staging.  A thread then owns 4 columns x 16 consecutive
// disparities: it reads the 19 other-eye columns that these reach (three
// words each) once and stores 16 disparities at a time (16 bytes of u8,
// 32 of int16, 64 of float32).  A cost is one lookup at AD * 49 + H in
// the quantized table staged in shared memory (37.5 KB of u8, 75 KB of
// int16), where the two float32 terms took two lookups, an add, a
// multiply and a conversion; float32 adds the two terms (3.3 KB).  Eight
// threads cover one column's 128 disparities, so a warp stores 4 x 512
// contiguous bytes of u8.  The other eye's staged words are skewed by
// one bank every 32 (k + k / 32), so the warp's 32 reads at stride 4 hit
// 32 banks; the table's lookups, at data-dependent indices, still
// conflict, and with the staging they bound the kernel (3.4x the bytes'
// time at 1080p/D=128 on an H100).  A D that is no multiple of 16
// writes its values one at a time.

#include "census.cuh"

#define COST_THREADS 256
#define COST_XB 256             // volume columns (x') a block
#define COST_RB 4               // volume rows a block
#define COST_XT 4               // columns a thread
#define COST_DPT 16             // disparities a thread
#define COST_GR (COST_RB + 6)   // gray rows a block

struct CostArgs {
  const uint8_t* own;
  const uint8_t* oth;
  const void* tab;      // the quantized table (u8, int16)
  const float* ta;      // the float32 terms
  const float* tc;
  void* out;
  int H, W, D, zd, M, row0, nrows;
};

// shared memory of one block at (D), in 32-bit words, with the layout
// offsets: the table, own pix/c0/c1, other pix/c0/c1, own gray, other gray
struct CostSmem {
  int own_pitch, oth_pitch, own_gwp, oth_gwp, words;
};

__host__ __device__ inline int cost_groups(int D) {
  return (D + COST_DPT - 1) / COST_DPT;
}

template <typename T>
__host__ __device__ inline CostSmem cost_smem(int D) {
  CostSmem s;
  const int oth_len = COST_XB + COST_DPT * cost_groups(D);
  s.own_pitch = COST_XB;
  s.oth_pitch = oth_len + (oth_len >> 5) + 1;
  // gray width <= len + 11 columns, rounded up to words
  s.own_gwp = (COST_XB + 11 + 3) & ~3;
  s.oth_gwp = (oth_len + 11 + 3) & ~3;
  s.words = cost_tab_words<T>() + 3 * COST_RB * (s.own_pitch + s.oth_pitch) +
            COST_GR * (s.own_gwp + s.oth_gwp) / 4;
  return s;
}

template <typename T, bool VEC, int SIGN>
__global__ void __launch_bounds__(COST_THREADS)
cost_pair_kernel(CostArgs a) {
  extern __shared__ __align__(16) uint32_t cost_sm[];
  const int W = a.W, D = a.D, G = cost_groups(D);
  const CostSmem L = cost_smem<T>(D);
  void* tab = cost_sm;
  cost_stage_table<T, COST_THREADS>(cost_sm, a.tab, a.ta, a.tc);

  const int xp0 = blockIdx.x * COST_XB;
  const int ylo = a.row0 + blockIdx.y * COST_RB;
  uint32_t* w = cost_sm + cost_tab_words<T>();
  CostEye own, oth;
  own.img = a.own;
  own.base = xp0 - a.M;
  own.len = COST_XB;
  own.pitch = L.own_pitch;
  own.skew = 0;
  own.pix = w;
  own.c0 = own.pix + COST_RB * L.own_pitch;
  own.c1 = own.c0 + COST_RB * L.own_pitch;
  w = own.c1 + COST_RB * L.own_pitch;
  oth.img = a.oth;
  // other-eye position k of (x' = xp0 + xl, d): xl + d for sign +1,
  // xl + (16G - 1 - d) for sign -1
  oth.base = SIGN > 0 ? xp0 - a.M - a.zd
                      : xp0 - a.M + a.zd - (COST_DPT * G - 1);
  oth.len = COST_XB + COST_DPT * G;
  oth.pitch = L.oth_pitch;
  oth.skew = 5;
  oth.pix = w;
  oth.c0 = oth.pix + COST_RB * L.oth_pitch;
  oth.c1 = oth.c0 + COST_RB * L.oth_pitch;
  w = oth.c1 + COST_RB * L.oth_pitch;
  cost_eye_layout(own, W);
  cost_eye_layout(oth, W);
  own.gray = reinterpret_cast<uint8_t*>(w);
  oth.gray = own.gray + COST_GR * L.own_gwp;

  cost_stage_gray<COST_RB, COST_THREADS>(own, ylo, a.H, W);
  cost_stage_gray<COST_RB, COST_THREADS>(oth, ylo, a.H, W);
  __syncthreads();
  cost_stage_census<COST_RB, COST_THREADS>(own, ylo, a.H, W);
  cost_stage_census<COST_RB, COST_THREADS>(oth, ylo, a.H, W);
  __syncthreads();

  const int wp = W + 2 * a.M;
  const int quads = COST_XB / COST_XT;
  const int rows = min(COST_RB, a.row0 + a.nrows - ylo);
  T* out = static_cast<T*>(a.out);
  for (int t = threadIdx.x; t < rows * quads * G; t += COST_THREADS) {
    const int g = t % G, rest = t / G;
    const int qd = rest % quads, r = rest / quads;
    const int xl = qd * COST_XT;
    if (xp0 + xl >= wp) continue;
    const int d0 = g * COST_DPT;
    // the 19 other-eye positions kb + o, o in [OMIN, OMIN + 19)
    constexpr int OMIN = SIGN > 0 ? 0 : 1 - COST_DPT;
    constexpr int NT = COST_DPT + COST_XT - 1;
    const int kb = xl + (SIGN > 0 ? d0 : COST_DPT * (G - g) - 1) + OMIN;
    uint32_t tp[NT], t0[NT], t1[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int s = r * oth.pitch + cost_slot(kb + i, 5);
      tp[i] = oth.pix[s];
      t0[i] = oth.c0[s];
      t1[i] = oth.c1[s];
    }
    T* orow = out + ((size_t)(ylo + r - a.row0) * wp + xp0 + xl) * D + d0;
#pragma unroll
    for (int xi = 0; xi < COST_XT; ++xi) {
      if (xp0 + xl + xi >= wp) break;
      const int s = r * own.pitch + xl + xi;
      const uint32_t op = own.pix[s], o0 = own.c0[s], o1 = own.c1[s];
      typename CostV<T>::V v[COST_DPT];
#pragma unroll
      for (int j = 0; j < COST_DPT; ++j) {
        const int i = (SIGN > 0 ? xi + j : xi - j) - OMIN;
        const int ad = (int)__vsadu4(op, tp[i]);
        const int ham = __popc(o0 ^ t0[i]) + __popc(o1 ^ t1[i]);
        v[j] = cost_of<T>(tab, ad, ham);
      }
      T* o = orow + (size_t)xi * D;
      if constexpr (VEC) {
        cost_store16<T>(o, v);
      } else {
        for (int j = 0; j < COST_DPT && d0 + j < D; ++j)
          o[j] = (T)v[j];
      }
    }
  }
}

template <typename T, bool VEC, int SIGN>
static int launch_cost_kernel(const CostArgs& a, size_t smem, dim3 grid,
                              cudaStream_t stream) {
  auto kernel = cost_pair_kernel<T, VEC, SIGN>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, COST_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cost(const CostArgs& a, int sign, void* stream) {
  const size_t smem = (size_t)cost_smem<T>(a.D).words * sizeof(uint32_t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((a.W + 2 * a.M + COST_XB - 1) / COST_XB,
            (a.nrows + COST_RB - 1) / COST_RB);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = a.D % COST_DPT == 0;
  if (sign > 0)
    return vec ? launch_cost_kernel<T, true, 1>(a, smem, grid, s)
               : launch_cost_kernel<T, false, 1>(a, smem, grid, s);
  return vec ? launch_cost_kernel<T, true, -1>(a, smem, grid, s)
             : launch_cost_kernel<T, false, -1>(a, smem, grid, s);
}

// own/oth: (H, W, 3) u8 contiguous images of the whole frame; tab: the
// quantized (766 * 49) table `cost_table` of elem_size 1 (u8) or 2
// (int16), unused for float32 (elem_size 4); ta (766), tc (49): the
// float32 terms, used for float32; out: (nrows, W + 2M, D) of elem_size
// bytes, the frame rows [row0, row0 + nrows).  The pair volume: own = L,
// other = R, M = max(zd, D - zd), sign 1; one eye: M = 0, own = that eye,
// sign 1 (left) or -1 (right).
STM_API int stm_cost_pair(const void* own, const void* oth, const void* tab,
                          const void* ta, const void* tc, void* out, int H,
                          int W, int D, int zd, int M, int sign, int row0,
                          int nrows, int elem_size, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > D || M < 0 ||
      row0 < 0 || nrows <= 0 || row0 + nrows > H ||
      (nrows + COST_RB - 1) / COST_RB > 65535 || (sign != 1 && sign != -1))
    return (int)cudaErrorInvalidValue;
  CostArgs a;
  a.own = (const uint8_t*)own;
  a.oth = (const uint8_t*)oth;
  a.tab = tab;
  a.ta = (const float*)ta;
  a.tc = (const float*)tc;
  a.out = out;
  a.H = H;
  a.W = W;
  a.D = D;
  a.zd = zd;
  a.M = M;
  a.row0 = row0;
  a.nrows = nrows;
  switch (elem_size) {
    case 1:
      return launch_cost<uint8_t>(a, sign, stream);
    case 2:
      return launch_cost<int16_t>(a, sign, stream);
    case 4:
      return launch_cost<float>(a, sign, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
