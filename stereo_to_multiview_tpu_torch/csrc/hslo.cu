// B13: horizontal scanline optimisation fused with the first-min WTA.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/hslokern.py
// `_hslo_kernel` (reached via `dc_hslo_wta_kern`).
//
// For every row on its own, with C the (H, W, D) aggregated volume:
//   out(x, d) = (C(x, d) + best) - mn,   mn = min_k prev(k),
//   best = min(min(prev(d), mn + p2), min(prev(d+1), prev(d-1)) + p1)
// (1e30 beyond the ends of d), prev = the previous column's out; the first
// column of each direction is its own cost.  Forward over x = 0..W-1,
// backward over x = W-1..0, a = (fwd + bwd) * 0.5, disparity = first-min
// argmin_d a - zd.  (p1, p2) is one of three pairs, chosen by the count of
// small gradients: |ga(x) - ga(x-1)| < T and |gb(x') - gb(x'-1)| < T at
// x' = clamp(x + sign * (d - zd), 0, W - 1), column -1 read as column 0.
// Every operation is a float32 add, subtract or minimum (the three pairs
// come ready from the host, * 0.5 is exact), so the result is bit-equal
// to the plain PyTorch version.
//
// Bound on the H100: the volume read once, 1.06 GB an eye at 1080p/D=128
// (0.32 ms at 3.35 TB/s).  This design moves 2.25 volumes an eye: the
// int32 volume twice (forward, then backward segment by segment) and
// float32 checkpoints of 1/8 of a volume written once and read once
// (2.39 GB, 0.71 ms at 3.35 TB/s).  The recurrence is serial in x and
// parallel over the rows only, so a launch takes the rows of both eyes
// (2H warps: 2160 at 1080p, 17 a SM).
// Design: one warp per row, lane l owning the K = ceil(D / 32) consecutive
// disparities from l * K, so the d +- 1 neighbours are registers but for
// one shuffle each way, and mn is one `__reduce_min_sync` of an
// order-preserving integer image of the floats.
// - Loads hold no registers: columns arrive by cp.async, in units of
//   HSLO_SEG columns, into a ring of HSLO_UNITS units in shared memory,
//   one unit in flight while the warp walks the other.  Each lane copies
//   and reads back only its own K values of a column, so no barrier is
//   needed beyond the copy's own wait.
// - No forward scratch volume: the forward pass keeps its carry every
//   HSLO_SEG columns (a checkpoint, D floats).  The backward pass takes
//   the segments from the last; for each it recomputes the forward values
//   of the segment from the checkpoint before it into registers (the same
//   float operations in the same order: bit-equal), then walks the
//   segment back.  The ring unit of a backward segment holds that
//   checkpoint and the segment's costs, read once into registers.  2.875
//   x W DP steps a row instead of 2 x W, against 2.25 volumes of traffic
//   instead of 4.  (HSLO_SEG 1 is the kept scratch volume: a checkpoint
//   every column, no recomputation.)
// - A unit's costs (as floats) and flag bits are read into registers
//   before its steps, so a step holds no memory operation but the warp
//   minimum and the two shuffles.  With 16-17 warps a SM the steps are
//   bound by issue, not by the loads: each d's two penalties are selected
//   by one predicate (`hslo_sel2`).
// - The tier lookup is a funnel shift: the block keeps the row's own
//   small-gradient flags as bits (bit x), and the other image's as bits
//   indexed by X + (d - zd) + P, X = x for sign +1 and W - 1 - x for sign
//   -1 (the array reversed), padded by P >= every reach + HSLO_SEG with
//   the clamped end columns, so a lane's K consecutive d read K
//   consecutive bits, and a unit's columns one window of them.

#include "stm_common.cuh"

#define HSLO_BIG 1e30f
#define HSLO_SEG 8       // columns of a segment: one checkpoint each
#define HSLO_UNITS 2     // ring units of a warp: one walked, one loading
#define HSLO_MASK 0xFFFFFFFFu

struct HsloPenalties {
  float p1[3];
  float p2[3];
};

// One launch: `eyes` eyes of H rows each.  Eye 0 is vol[0] with gray[0]
// its own image, gray[1] the other, and sign; eye 1 is vol[1] with the
// grays swapped and -sign.
struct HsloArgs {
  const int32_t* vol[2];
  const uint8_t* gray[2];
  float* disp[2];
  float* ckpt;             // (eyes * H, nseg - 1, 32 * K) float32
  int H, W, D, zd, sign, P, nseg, vec;
  float T;
  HsloPenalties pen;
};

// Monotone map float -> unsigned (total order of the finite floats).
__device__ __forceinline__ unsigned hslo_key(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float hslo_unkey(unsigned k) {
  const unsigned b = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(b);
}

__device__ __forceinline__ float warp_min(float v) {
  return hslo_unkey(__reduce_min_sync(HSLO_MASK, hslo_key(v)));
}

// Copy the first n (0..K) of a lane's K values into its K words of a ring
// column: 16 bytes at a time where `vec` (K % 4 == 0, aligned, n % 4 ==
// 0), else 4.
template <int K>
__device__ __forceinline__ void hslo_fill(uint32_t* dst, const void* src,
                                          int n, bool vec) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  if (K % 4 == 0 && vec) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      if (4 * q < n) stm_cp16(dst + 4 * q, s + 4 * q);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < n) stm_cp4(dst + j, s + j);
  }
}

// A lane's K words of a ring column as floats: int32 costs converted
// (1e30 beyond the first n unless FULL), or float32 bits (FLT).
template <int K, bool FULL, bool FLT>
__device__ __forceinline__ void hslo_read(const uint32_t* src, int n,
                                          float (&c)[K]) {
  uint32_t v[K];
  if (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(src)[q];
      v[(4 * q) % K] = t.x;
      v[(4 * q + 1) % K] = t.y;
      v[(4 * q + 2) % K] = t.z;
      v[(4 * q + 3) % K] = t.w;
    }
  } else if (K == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(src);
    v[0] = t.x;
    v[1 % K] = t.y;
  } else {
    v[0] = src[0];
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    c[j] = (FULL || j < n) ? (FLT ? __uint_as_float(v[j]) : (float)(int)v[j])
                           : HSLO_BIG;
}

// Two selections by one bit of tb: (a, b) = tb & bit ? (hi_a, hi_b) :
// (lo_a, lo_b), from one predicate.  (Written as C++ selects, each bit
// test compiled to a shift, an AND and a compare: a fifth of a step's
// instructions.)
__device__ __forceinline__ void hslo_sel2(unsigned tb, unsigned bit,
                                          float hi_a, float lo_a, float hi_b,
                                          float lo_b, float& a, float& b) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\tand.b32 t, %2, %3;\n\t"
      "setp.ne.b32 p, t, 0;\n\tselp.f32 %0, %4, %5, p;\n\t"
      "selp.f32 %1, %6, %7, p;\n\t}"
      : "=f"(a), "=f"(b)
      : "r"(tb), "r"(bit), "f"(hi_a), "f"(lo_a), "f"(hi_b), "f"(lo_b));
}

// A unit's loads, made before its steps: the costs as floats and, per
// column, the flag bits of the lane's K disparities (the other image's,
// bits 0..K-1) and the own image's flag (bit 16).  So the DP chain of a
// step holds no memory operation.
template <int K>
struct HsloUnit {
  float c[HSLO_SEG][K];
  unsigned tb[HSLO_SEG];
};

template <int K, bool FULL>
struct HsloRow {
  const uint32_t* sa;    // own image's small-gradient bits, bit x
  const uint32_t* ob;    // the other image's, bit X + (d - zd) + P
  float p1[3], p2[3];    // the tiers' penalties (0, 1, 2 small gradients)
  int W, D, lane, d0, sign, ibase;   // ibase = d0 - zd + P

  // The unit's costs (ring columns 1..n of `unit`, the lane's words) and
  // flag bits for the columns x0 .. x0 + n - 1.  Column i reads the other
  // image's bits X + ibase .. X + ibase + K - 1, X = x0 + i (sign +1) or
  // W - 1 - x0 - i (sign -1): one window of HSLO_SEG - 1 + K bits.
  __device__ __forceinline__ void prep(const uint32_t* unit, int x0, int n,
                                       int nd, HsloUnit<K>& u) const {
#pragma unroll
    for (int i = 0; i < HSLO_SEG; ++i)
      if (i < n) hslo_read<K, FULL, false>(unit + (1 + i) * 32 * K, nd, u.c[i]);
    const unsigned own = sa[x0 >> 5] >> (x0 & 31);
    const int lo = (sign > 0 ? x0 : W - x0 - HSLO_SEG) + ibase;
    const unsigned win = __funnelshift_r(ob[lo >> 5], ob[(lo >> 5) + 1], lo);
#pragma unroll
    for (int i = 0; i < HSLO_SEG; ++i) {
      const int o = sign > 0 ? i : HSLO_SEG - 1 - i;
      u.tb[i] = ((win >> o) & ((1u << K) - 1u)) | (((own >> i) & 1u) << 16);
    }
  }

  // One DP step with the column's costs c and flag word tb: prev <- out.
  __device__ __forceinline__ void step(float (&prev)[K], const float (&c)[K],
                                       unsigned tb) const {
    // off the chain: each d's penalties from its tier = s1 + s2
    const bool s1 = (tb & 0x10000u) != 0u;
    const float lo1 = s1 ? p1[1] : p1[0], hi1 = s1 ? p1[2] : p1[1];
    const float lo2 = s1 ? p2[1] : p2[0], hi2 = s1 ? p2[2] : p2[1];
    float q1[K], q2[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      hslo_sel2(tb, 1u << j, hi1, lo1, hi2, lo2, q1[j], q2[j]);
    float local[K];
#pragma unroll
    for (int j = 0; j < K; ++j) local[j] = prev[j];
#pragma unroll
    for (int h = 1; h < K; h *= 2)
#pragma unroll
      for (int j = 0; j + h < K; j += 2 * h)
        local[j] = fminf(local[j], local[j + h]);
    const float mn = warp_min(local[0]);
    float up_in = __shfl_down_sync(HSLO_MASK, prev[0], 1);
    float dn_in = __shfl_up_sync(HSLO_MASK, prev[K - 1], 1);
    if (lane == 31) up_in = HSLO_BIG;
    if (lane == 0) dn_in = HSLO_BIG;
    float out[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float up = j + 1 < K ? prev[j + 1 < K ? j + 1 : j] : up_in;
      const float dn = j > 0 ? prev[j > 0 ? j - 1 : 0] : dn_in;
      const float best = fminf(fminf(prev[j], __fadd_rn(mn, q2[j])),
                               __fadd_rn(fminf(up, dn), q1[j]));
      out[j] = __fsub_rn(__fadd_rn(c[j], best), mn);
      if (!FULL && d0 + j >= D) out[j] = HSLO_BIG;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) prev[j] = out[j];
  }
};

template <int K>
__device__ __forceinline__ void hslo_store(float* dst, const float (&v)[K]) {
  if (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[(4 * q) % K], v[(4 * q + 1) % K], v[(4 * q + 2) % K],
                      v[(4 * q + 3) % K]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) dst[j] = v[j];
  }
}

// a = (fwd + bwd) * 0.5 and the first minimum over d: the lane's own in
// ascending d (strict <), then the warp's least value and the least lane
// holding it.
template <int K, bool FULL>
__device__ __forceinline__ void hslo_wta(const float (&f)[K],
                                         const float (&b)[K], int lane,
                                         int d0, int D, int zd, float* dst) {
  float best = HSLO_BIG;
  int arg = d0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float a = (FULL || d0 + j < D)
                        ? __fmul_rn(__fadd_rn(f[j], b[j]), 0.5f)
                        : HSLO_BIG;
    if (j == 0 || a < best) {
      best = a;
      arg = d0 + j;
    }
  }
  const unsigned key = (FULL || d0 < D) ? hslo_key(best) : 0xFFFFFFFFu;
  const unsigned m = __reduce_min_sync(HSLO_MASK, key);
  const unsigned hit = __ballot_sync(HSLO_MASK, key == m);
  if (lane == __ffs(hit) - 1) *dst = (float)(arg - zd);
}

__device__ __forceinline__ bool hslo_small(const uint8_t* row, int x,
                                           float T) {
  return (float)abs((int)row[x] - (int)row[max(x - 1, 0)]) < T;
}

// The row's flag bits: sa[x] of the own image, ob[i] of the other at
// x' = clamp(X - P, 0, W - 1), X = i (sign +1) or W - 1 - i (sign -1).
// Sixteen words a batch, so that their loads are in flight together.
__device__ void hslo_flags(const uint8_t* ra, const uint8_t* rb,
                           uint32_t* sa, uint32_t* ob, int W, int P,
                           int sign, float T, int lane, int nwa, int nwb) {
  for (int w0 = 0; w0 < nwa; w0 += 16) {
    bool f[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      f[q] = hslo_small(ra, min(((w0 + q) << 5) + lane, W - 1), T);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const unsigned b = __ballot_sync(HSLO_MASK, f[q]);
      if (lane == 0 && w0 + q < nwa) sa[w0 + q] = b;
    }
  }
  for (int w0 = 0; w0 < nwb; w0 += 16) {
    bool f[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      int xp = ((w0 + q) << 5) + lane - P;
      if (sign < 0) xp = W - 1 - xp;
      f[q] = hslo_small(rb, min(max(xp, 0), W - 1), T);
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const unsigned b = __ballot_sync(HSLO_MASK, f[q]);
      if (lane == 0 && w0 + q < nwb) ob[w0 + q] = b;
    }
  }
}

__host__ __device__ inline int hslo_nwb(int W, int P) {
  return (W + 2 * P) / 32 + 2;
}

template <int K, bool FULL>
__global__ void __launch_bounds__(32, K <= 4 ? 17 : 8)
hslo_kernel(const HsloArgs a) {
  constexpr int COLW = 32 * K;                  // words of a ring column
  constexpr int UNITW = (HSLO_SEG + 1) * COLW;  // checkpoint + segment
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = a.W, D = a.D, nseg = a.nseg;
  const int nwa = (W + 31) >> 5;
  uint32_t* ring = smem;
  uint32_t* sa = ring + HSLO_UNITS * UNITW;
  uint32_t* ob = sa + nwa;
  const int lane = threadIdx.x;
  const int eye = blockIdx.x >= a.H;
  const int y = blockIdx.x - eye * a.H;
  const int sign = eye ? -a.sign : a.sign;
  const int d0 = lane * K;
  const int nd = min(max(D - d0, 0), K);        // the lane's valid d
  const int32_t* vrow = (eye ? a.vol[1] : a.vol[0]) + (size_t)y * W * D + d0;
  float* drow = (eye ? a.disp[1] : a.disp[0]) + (size_t)y * W;
  const uint8_t* own = eye ? a.gray[1] : a.gray[0];
  const uint8_t* other = eye ? a.gray[0] : a.gray[1];
  float* crow = a.ckpt + (size_t)blockIdx.x * (nseg - 1) * COLW + d0;
  const bool vec = a.vec;

  hslo_flags(own + (size_t)y * W, other + (size_t)y * W, sa, ob, W, a.P,
             sign, a.T, lane, nwa, hslo_nwb(W, a.P));
  __syncwarp();
  const HsloRow<K, FULL> row{
      sa, ob, {a.pen.p1[0], a.pen.p1[1], a.pen.p1[2]},
      {a.pen.p2[0], a.pen.p2[1], a.pen.p2[2]}, W, D, lane, d0, sign,
      d0 - a.zd + a.P};

  // columns x0 .. x0 + HSLO_SEG - 1 into ring columns 1 .. HSLO_SEG
  auto fill_cols = [&](uint32_t* unit, int x0) {
#pragma unroll
    for (int i = 0; i < HSLO_SEG; ++i)
      if (x0 + i < W)
        hslo_fill<K>(unit + (1 + i) * COLW + d0, vrow + (size_t)(x0 + i) * D,
                     nd, vec);
  };

  // forward: x = 0 .. W-1; the carry after each full segment but the
  // last is its checkpoint
  float prev[K];
  for (int q = 0; q < HSLO_UNITS - 1; ++q) {
    if (q < nseg) fill_cols(ring + q * UNITW, q * HSLO_SEG);
    stm_cp_commit();
  }
  for (int u = 0; u < nseg; ++u) {
    const int un = u + HSLO_UNITS - 1;
    if (un < nseg) fill_cols(ring + (un % HSLO_UNITS) * UNITW, un * HSLO_SEG);
    stm_cp_commit();
    stm_cp_wait<HSLO_UNITS - 1>();
    const int x0 = u * HSLO_SEG;
    HsloUnit<K> cu;
    row.prep(ring + (u % HSLO_UNITS) * UNITW + d0, x0, min(HSLO_SEG, W - x0),
             nd, cu);
#pragma unroll
    for (int i = 0; i < HSLO_SEG; ++i) {
      if (x0 + i < W) {
        if (x0 + i == 0) {
#pragma unroll
          for (int j = 0; j < K; ++j) prev[j] = cu.c[0][j];
        } else {
          row.step(prev, cu.c[i], cu.tb[i]);
        }
      }
    }
    if (u < nseg - 1) hslo_store<K>(crow + (size_t)u * COLW, prev);
  }
  stm_cp_wait<0>();

  // backward: segment k = nseg-1 .. 0, each unit the checkpoint before it
  // (ring column 0) and its costs
  auto fill_seg = [&](int t) {
    const int k = nseg - 1 - t;
    if (k >= 0) {
      uint32_t* unit = ring + (t % HSLO_UNITS) * UNITW;
      if (k > 0)
        hslo_fill<K>(unit + d0, crow + (size_t)(k - 1) * COLW, K, true);
      fill_cols(unit, k * HSLO_SEG);
    }
    stm_cp_commit();
  };
  float fl[K];               // forward value of the segment's last column
  float b[K];                // the backward carry
#pragma unroll
  for (int j = 0; j < K; ++j) fl[j] = prev[j];
  for (int q = 0; q < HSLO_UNITS - 1; ++q) fill_seg(q);
  for (int t = 0; t < nseg; ++t) {
    fill_seg(t + HSLO_UNITS - 1);
    stm_cp_wait<HSLO_UNITS - 1>();
    const int k = nseg - 1 - t;
    const int x0 = k * HSLO_SEG;
    const int n = min(HSLO_SEG, W - x0);
    const uint32_t* unit = ring + (t % HSLO_UNITS) * UNITW + d0;
    HsloUnit<K> cu;
    row.prep(unit, x0, n, nd, cu);
    float f[K], fnext[K];
    if (k > 0) {
      hslo_read<K, true, true>(unit, K, f);
#pragma unroll
      for (int j = 0; j < K; ++j) fnext[j] = f[j];
    }
    // the segment's forward values: recomputed from the checkpoint, the
    // last column's carried over from the segment after it (a short last
    // segment recomputes all of its columns)
    float fs[HSLO_SEG][K];
#pragma unroll
    for (int i = 0; i < HSLO_SEG; ++i) {
      if (i < n) {
        if (i == HSLO_SEG - 1) {
#pragma unroll
          for (int j = 0; j < K; ++j) fs[i][j] = fl[j];
        } else {
          if (x0 + i == 0) {
#pragma unroll
            for (int j = 0; j < K; ++j) f[j] = cu.c[0][j];
          } else {
            row.step(f, cu.c[i], cu.tb[i]);
          }
#pragma unroll
          for (int j = 0; j < K; ++j) fs[i][j] = f[j];
        }
      }
    }
    if (k > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) fl[j] = fnext[j];
    }
#pragma unroll
    for (int i = HSLO_SEG - 1; i >= 0; --i) {
      if (i < n) {
        const int x = x0 + i;
        if (x == W - 1) {
#pragma unroll
          for (int j = 0; j < K; ++j) b[j] = cu.c[i][j];
        } else {
          row.step(b, cu.c[i], cu.tb[i]);
        }
        hslo_wta<K, FULL>(fs[i], b, lane, d0, D, a.zd, drow + x);
      }
    }
  }
}

static inline int hslo_k(int D) { return (D + 31) / 32 <= 1   ? 1
                                         : (D + 31) / 32 <= 2 ? 2
                                         : (D + 31) / 32 <= 4 ? 4
                                                              : 8; }

// P: the padding of the other image's bits, the largest |d - zd| of a
// lane's d, and HSLO_SEG more for a unit's window
static inline int hslo_reach(int D, int zd) {
  const int k = hslo_k(D);
  const int p = zd > 32 * k - 1 - zd ? zd : 32 * k - 1 - zd;
  return (p > 0 ? p : 0) + HSLO_SEG;
}

static inline size_t hslo_smem(int W, int D, int zd) {
  const int k = hslo_k(D);
  return (size_t)HSLO_UNITS * (HSLO_SEG + 1) * 32 * k * 4 +
         4 * (size_t)((W + 31) / 32 + hslo_nwb(W, hslo_reach(D, zd)));
}

template <int K, bool FULL>
static int launch_hslo(const HsloArgs& a, int blocks, size_t smem,
                       void* stream) {
  cudaError_t err = stm_smem_cap(hslo_kernel<K, FULL>, smem);
  if (err != cudaSuccess) return (int)err;
  hslo_kernel<K, FULL><<<blocks, 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_hslo_k(const HsloArgs& a, int blocks, size_t smem,
                         void* stream) {
  return a.D == 32 * K ? launch_hslo<K, true>(a, blocks, smem, stream)
                       : launch_hslo<K, false>(a, blocks, smem, stream);
}

// Floats of the checkpoint buffer `stm_hslo_wta` needs: (eyes * H,
// ceil(W / HSLO_SEG) - 1, 32 * ceil(D / 32)), at least 1.
STM_API int stm_hslo_scratch(int eyes, int H, int W, int D) {
  if (eyes < 1 || H <= 0 || W <= 0 || D <= 0 || D > 256) return -1;
  const long long n = (long long)eyes * H * ((W + HSLO_SEG - 1) / HSLO_SEG - 1) *
                      32 * hslo_k(D);
  return n > 0x7FFFFFFFLL ? -1 : (n > 0 ? (int)n : 1);
}

// vol0 (and vol1 with eyes = 2): (H, W, D) i32, non-negative; ga, gb (H,
// W) u8: eye 0's own and other image's gray (eye 1 takes them swapped);
// disp0 (disp1): (H, W) f32; ckpt: `stm_hslo_scratch` floats.  p1, p2:
// host arrays of the three tiers' penalties (0, 1, 2 small gradients).
// sign: +1 for a left eye's volume, -1 for a right's (eye 1 takes -sign).
// D <= 256.
STM_API int stm_hslo_wta(const void* vol0, const void* vol1, const void* ga,
                         const void* gb, void* disp0, void* disp1,
                         void* ckpt, int eyes, int H, int W, int D, int zd,
                         int sign, float T, const float* p1, const float* p2,
                         void* stream) {
  if (eyes < 1 || eyes > 2 || H <= 0 || W <= 0 || D <= 0 || D > 256 ||
      (sign != 1 && sign != -1) || p1 == nullptr || p2 == nullptr ||
      (long long)eyes * H > 0x7FFFFFFFLL ||
      hslo_smem(W, D, zd) > 227 * 1024 || stm_hslo_scratch(eyes, H, W, D) < 0)
    return (int)cudaErrorInvalidValue;
  HsloArgs a;
  a.vol[0] = (const int32_t*)vol0;
  a.vol[1] = (const int32_t*)(eyes > 1 ? vol1 : vol0);
  a.gray[0] = (const uint8_t*)ga;
  a.gray[1] = (const uint8_t*)gb;
  a.disp[0] = (float*)disp0;
  a.disp[1] = (float*)(eyes > 1 ? disp1 : disp0);
  a.ckpt = (float*)ckpt;
  a.H = H;
  a.W = W;
  a.D = D;
  a.zd = zd;
  a.sign = sign;
  a.P = hslo_reach(D, zd);
  a.nseg = (W + HSLO_SEG - 1) / HSLO_SEG;
  a.vec = (D % 4 == 0) && ((uintptr_t)a.vol[0] % 16 == 0) &&
          ((uintptr_t)a.vol[1] % 16 == 0);
  a.T = T;
  for (int t = 0; t < 3; ++t) {
    a.pen.p1[t] = p1[t];
    a.pen.p2[t] = p2[t];
  }
  const size_t smem = hslo_smem(W, D, zd);
  const int blocks = eyes * H;
  switch (hslo_k(D)) {
    case 1:
      return launch_hslo_k<1>(a, blocks, smem, stream);
    case 2:
      return launch_hslo_k<2>(a, blocks, smem, stream);
    case 4:
      return launch_hslo_k<4>(a, blocks, smem, stream);
    default:
      return launch_hslo_k<8>(a, blocks, smem, stream);
  }
}
