// The AD-census cost's shared device code: the grayscale and the 9x7
// census of staged image rows, the cost of an (AD, H) pair from a table
// staged in shared memory, and 16-value stores.  Used by B2
// (csrc/cost.cu) and B16 (csrc/cost_dm.cu), so that their census and
// costs cannot drift apart.
//
// The census codes are the port's `census_transform_9x7(mux_average(img))`
// of the whole frame: gray = trunc(b * c + g * c + r * c), c =
// float32(0.3333333333333), each product and sum rounded on its own (no
// contraction); two words of 24 bits, rows dy in {-3,-2,-1} and {1,2,3},
// dx in {-4..4} minus 0, raster order, shift-then-set, bit set iff
// neighbour < center, reads clamped to the frame's edges (never to a row
// range's).  A block stages the gray of its rows and 3 rows either side
// (`cost_stage_gray`), then pixel and census of every staged column
// (`cost_stage_census`: four columns at a time in 16-bit lanes where they
// lie inside the frame, else one bit at a time).
#pragma once

#include "stm_common.cuh"

#define COST_AD 766
#define COST_HAM 49

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
  int base, len, gorg, gwp;   // len: a multiple of 4
  uint8_t* gray;        // RB + 6 rows of gwp bytes
  uint32_t* pix;        // RB rows of `pitch` words each: pixel,
  uint32_t* c0;         // census word 0, census word 1
  uint32_t* c1;
  int pitch;
  int skew;             // staged at k + (k >> skew); 0: at k
};

__device__ __forceinline__ int cost_clamp(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ int cost_slot(int k, int skew) {
  return skew ? k + (k >> skew) : k;
}

__device__ void cost_eye_layout(CostEye& e, int W) {
  const int a = cost_clamp(e.base, W - 1) - 4;
  e.gorg = a - ((a - e.base) & 3);
  const int gend = cost_clamp(e.base + e.len - 1, W - 1) + 4;
  e.gwp = (gend - e.gorg + 4) & ~3;
}

// the gray of the frame rows [ylo - 3, ylo + RB + 3) (clamped), by NT
// threads
template <int RB, int NT>
__device__ void cost_stage_gray(const CostEye& e, int ylo, int H, int W) {
  const float third = 0.3333333333333f;
#pragma unroll 4
  for (int i = threadIdx.x; i < (RB + 6) * e.gwp; i += NT) {
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

// pixel and census of every staged position of the block's RB rows, by NT
// threads
template <int RB, int NT>
__device__ void cost_stage_census(const CostEye& e, int ylo, int H, int W) {
  const int groups = (e.len + 3) >> 2;
  for (int t = threadIdx.x; t < RB * groups; t += NT) {
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

// The cost table into shared memory `sm` by NT threads: u8 and int16 the
// quantized table's bytes, float32 the terms a[0..765] ++ c[0..48].
template <typename T, int NT>
__device__ void cost_stage_table(uint32_t* sm, const void* tab,
                                 const float* ta, const float* tc) {
  if constexpr (sizeof(T) == 4) {
    float* t = reinterpret_cast<float*>(sm);
    for (int i = threadIdx.x; i < COST_AD + COST_HAM; i += NT)
      t[i] = i < COST_AD ? ta[i] : tc[i - COST_AD];
  } else {
    // 16 bytes a load, several in flight (`sm` and the table 16-byte
    // aligned), then the tail
    constexpr int n = COST_AD * COST_HAM * (int)sizeof(T);
    const uint4* src = static_cast<const uint4*>(tab);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 16; i += NT)
      reinterpret_cast<uint4*>(sm)[i] = src[i];
    uint8_t* t8 = reinterpret_cast<uint8_t*>(sm);
    for (int i = n / 16 * 16 + threadIdx.x; i < n; i += NT)
      t8[i] = static_cast<const uint8_t*>(tab)[i];
  }
}
