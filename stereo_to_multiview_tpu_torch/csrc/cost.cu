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
// the frame's edges (never to the row range's).  The cost of (AD, H) is
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

#include "stm_common.cuh"

#define COST_AD 766
#define COST_HAM 49
#define COST_THREADS 256
#define COST_XB 256             // volume columns (x') a block
#define COST_RB 4               // volume rows a block
#define COST_XT 4               // columns a thread
#define COST_DPT 16             // disparities a thread
#define COST_GR (COST_RB + 6)   // gray rows a block

// The value type of a cost before its store: the quantized int, or the
// float32 sum.
template <typename T> struct CostV { typedef int V; };
template <> struct CostV<float> { typedef float V; };

// The cost of (AD, H): u8 and int16 from the quantized table (AD * 49 +
// H), float32 from the terms tab = a[0..765] ++ c[0..48].
template <typename T>
__device__ __forceinline__ typename CostV<T>::V cost_of(const void* tab,
                                                        int ad, int ham) {
  if constexpr (sizeof(T) == 4) {
    const float* t = static_cast<const float*>(tab);
    return __fadd_rn(t[ad], t[COST_AD + ham]);
  } else {
    return static_cast<const T*>(tab)[ad * COST_HAM + ham];
  }
}

// 32-bit words of the table in shared memory
template <typename T>
__host__ __device__ constexpr int cost_tab_words() {
  return sizeof(T) == 4 ? 816 : (COST_AD * COST_HAM * (int)sizeof(T) + 15)
                                / 16 * 4;
}

__device__ __forceinline__ uint32_t cost_pack(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
}

// The staged layout of one eye: positions k in [0, len) stand for the
// columns base + k (before the clamp); gray covers the frame columns
// [gorg, gorg + gwp) (clamped), gorg = base (mod 4).
struct CostEye {
  const uint8_t* img;
  int base, len, gorg, gwp;
  uint8_t* gray;        // COST_GR rows of gwp bytes
  uint32_t* pix;        // COST_RB rows of `pitch` words each: pixel,
  uint32_t* c0;         // census word 0, census word 1
  uint32_t* c1;
  int pitch;
  bool skew;            // staged at k + k / 32
};

__device__ __forceinline__ int cost_clamp(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ int cost_slot(int k, bool skew) {
  return skew ? k + (k >> 5) : k;
}

__device__ void cost_eye_layout(CostEye& e, int W) {
  const int a = cost_clamp(e.base, W - 1) - 4;
  e.gorg = a - ((a - e.base) & 3);
  const int gend = cost_clamp(e.base + e.len - 1, W - 1) + 4;
  e.gwp = (gend - e.gorg + 4) & ~3;
}

__device__ void cost_stage_gray(const CostEye& e, int ylo, int H, int W) {
  const float third = 0.3333333333333f;
  for (int i = threadIdx.x; i < COST_GR * e.gwp; i += COST_THREADS) {
    const int r = i / e.gwp, j = i - r * e.gwp;
    const int y = cost_clamp(ylo - 3 + r, H - 1);
    const int x = cost_clamp(e.gorg + j, W - 1);
    const uint8_t* p = e.img + ((size_t)y * W + x) * 3;
    float acc = __fmul_rn((float)p[0], third);
    acc = __fadd_rn(acc, __fmul_rn((float)p[1], third));
    acc = __fadd_rn(acc, __fmul_rn((float)p[2], third));
    e.gray[i] = (uint8_t)__float2int_rz(acc);
  }
}

// the census of frame column cc (clamped) of gray row r + 3, one bit at a
// time
__device__ void cost_census1(const CostEye& e, int r, int cc, int W,
                             uint32_t& w0, uint32_t& w1) {
  int col[9];
#pragma unroll
  for (int dx = -4; dx <= 4; ++dx) col[dx + 4] = cost_clamp(cc + dx, W - 1)
                                                 - e.gorg;
  const int ctr = e.gray[(r + 3) * e.gwp + col[4]];
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
    if (dy == 0) continue;
    const uint8_t* g = e.gray + (r + 3 + dy) * e.gwp;
#pragma unroll
    for (int dx = -4; dx <= 4; ++dx) {
      if (dx == 0) continue;
      uint32_t& acc = w[dy > 0];
      acc = (acc << 1) | (uint32_t)(g[col[dx + 4]] < ctr);
    }
  }
  w0 = w[0];
  w1 = w[1];
}

// The census of four frame columns c..c+3, all inside the frame, at gray
// word wi (their centers), in 16-bit lanes: lane values 256 + n - c keep
// bit 8 for n >= c, four dx steps shift it up to a byte per row.
__device__ void cost_census4(const CostEye& e, int r, int wi,
                             uint32_t (&w0)[4], uint32_t (&w1)[4]) {
  const uint32_t* g0 = (const uint32_t*)(e.gray + (r + 3) * e.gwp);
  const uint32_t ctr = g0[wi];
  const uint32_t ce = __byte_perm(ctr, 0, 0x4240);   // centers 0, 2
  const uint32_t co = __byte_perm(ctr, 0, 0x4341);   // centers 1, 3
  uint32_t rows[6];
#pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
    if (dy == 0) continue;
    const uint32_t* g = (const uint32_t*)(e.gray + (r + 3 + dy) * e.gwp);
    const uint32_t wm = g[wi - 1], w0_ = g[wi], wp = g[wi + 1];
    uint32_t ge_e = 0u, ge_o = 0u;
#pragma unroll
    for (int dx = -4; dx <= 4; ++dx) {
      if (dx == 0) continue;
      uint32_t nb;
      if (dx == -4) nb = wm;
      else if (dx < 0) nb = __funnelshift_r(wm, w0_, 8 * (dx + 4));
      else if (dx < 4) nb = __funnelshift_r(w0_, wp, 8 * dx);
      else nb = wp;
      const uint32_t te = __byte_perm(nb, 0, 0x4240) + 0x01000100u - ce;
      const uint32_t to = __byte_perm(nb, 0, 0x4341) + 0x01000100u - co;
      ge_e = (ge_e << 1) | (te & 0x01000100u);
      ge_o = (ge_o << 1) | (to & 0x01000100u);
    }
    // bytes (pos 0, pos 1, pos 2, pos 3) of the row, bit set iff n < c
    rows[dy < 0 ? dy + 3 : dy + 2] = ~__byte_perm(ge_e, ge_o, 0x7351);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t s = (uint32_t)(p | (4 + p) << 4);   // bytes p, 4 + p
    w0[p] = (__byte_perm(rows[2], rows[1], s) & 0xFFFFu)
            | (__byte_perm(rows[0], 0, 0x4440 | p) << 16);
    w1[p] = (__byte_perm(rows[5], rows[4], s) & 0xFFFFu)
            | (__byte_perm(rows[3], 0, 0x4440 | p) << 16);
  }
}

// pixel and census of every staged position of the block's rows
__device__ void cost_stage_census(const CostEye& e, int ylo, int H, int W) {
  const int groups = (e.len + 3) >> 2;
  for (int t = threadIdx.x; t < COST_RB * groups; t += COST_THREADS) {
    const int r = t / groups, k = (t - r * groups) * 4;
    const int y = cost_clamp(ylo + r, H - 1);
    const int c = e.base + k;
    uint32_t w0[4], w1[4];
    if (c >= 0 && c + 3 <= W - 1) {
      cost_census4(e, r, (c - e.gorg) >> 2, w0, w1);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        cost_census1(e, r, cost_clamp(c + p, W - 1), W, w0[p], w1[p]);
    }
    const uint8_t* row = e.img + (size_t)y * W * 3;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int s = r * e.pitch + cost_slot(k + p, e.skew);
      e.pix[s] = cost_pack(row + cost_clamp(c + p, W - 1) * 3);
      e.c0[s] = w0[p];
      e.c1[s] = w1[p];
    }
  }
}

template <typename T>
__device__ __forceinline__ void cost_store16(
    T* o, const typename CostV<T>::V (&v)[16]);

template <>
__device__ __forceinline__ void cost_store16<uint8_t>(uint8_t* o,
                                                      const int (&v)[16]) {
  uint4 q;
  uint32_t* w = &q.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)v[4 * i] | ((uint32_t)v[4 * i + 1] << 8) |
           ((uint32_t)v[4 * i + 2] << 16) | ((uint32_t)v[4 * i + 3] << 24);
  *reinterpret_cast<uint4*>(o) = q;
}

template <>
__device__ __forceinline__ void cost_store16<int16_t>(int16_t* o,
                                                      const int (&v)[16]) {
  uint4 q[2];
  uint32_t* w = &q[0].x;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = (uint32_t)v[2 * i] | ((uint32_t)v[2 * i + 1] << 16);
  reinterpret_cast<uint4*>(o)[0] = q[0];
  reinterpret_cast<uint4*>(o)[1] = q[1];
}

template <>
__device__ __forceinline__ void cost_store16<float>(float* o,
                                                    const float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(o)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

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
  extern __shared__ uint32_t cost_sm[];
  const int W = a.W, D = a.D, G = cost_groups(D);
  const CostSmem L = cost_smem<T>(D);
  void* tab = cost_sm;
  if constexpr (sizeof(T) == 4) {
    float* t = reinterpret_cast<float*>(cost_sm);
    for (int i = threadIdx.x; i < COST_AD + COST_HAM; i += COST_THREADS)
      t[i] = i < COST_AD ? a.ta[i] : a.tc[i - COST_AD];
  } else {
    // the table's bytes, as words and then the tail
    constexpr int n = COST_AD * COST_HAM * (int)sizeof(T);
    const uint32_t* src = static_cast<const uint32_t*>(a.tab);
    for (int i = threadIdx.x; i < n / 4; i += COST_THREADS)
      cost_sm[i] = src[i];
    uint8_t* t8 = reinterpret_cast<uint8_t*>(cost_sm);
    for (int i = n / 4 * 4 + threadIdx.x; i < n; i += COST_THREADS)
      t8[i] = static_cast<const uint8_t*>(a.tab)[i];
  }

  const int xp0 = blockIdx.x * COST_XB;
  const int ylo = a.row0 + blockIdx.y * COST_RB;
  uint32_t* w = cost_sm + cost_tab_words<T>();
  CostEye own, oth;
  own.img = a.own;
  own.base = xp0 - a.M;
  own.len = COST_XB;
  own.pitch = L.own_pitch;
  own.skew = false;
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
  oth.skew = true;
  oth.pix = w;
  oth.c0 = oth.pix + COST_RB * L.oth_pitch;
  oth.c1 = oth.c0 + COST_RB * L.oth_pitch;
  w = oth.c1 + COST_RB * L.oth_pitch;
  cost_eye_layout(own, W);
  cost_eye_layout(oth, W);
  own.gray = reinterpret_cast<uint8_t*>(w);
  oth.gray = own.gray + COST_GR * L.own_gwp;

  cost_stage_gray(own, ylo, a.H, W);
  cost_stage_gray(oth, ylo, a.H, W);
  __syncthreads();
  cost_stage_census(own, ylo, a.H, W);
  cost_stage_census(oth, ylo, a.H, W);
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
      const int s = r * oth.pitch + cost_slot(kb + i, true);
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
