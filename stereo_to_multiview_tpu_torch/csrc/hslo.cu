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
// Bound on the H100: memory, beside a serial chain.  The int32 volume is
// read twice and the float32 forward result written and read once: 4 x
// 1.06 GB an eye at 1080p/D=128 (~1.3 ms at 3.35 TB/s).  The recurrence is
// serial in x (2 x 1920 dependent steps) and parallel over the rows only.
// Design: one warp per row, lane l owning the K = ceil(D / 32) consecutive
// disparities from l * K, so the d +- 1 neighbours are registers but for
// one shuffle each way, and mn is one `__reduce_min_sync` of an
// order-preserving integer image of the floats.  The TPU kernel's int8
// tier volume (265 MB) does not exist: the block keeps the row's two
// small-gradient flags per column in shared memory and reads the tier
// from them.  Columns are loaded eight at a time, one group ahead of the
// chain, so that the ~1000 resident warps keep enough loads in flight
// (the launch bounds keep ten one-warp blocks on an SM: a 1080-row frame
// is one wave on 132 SMs).
// The forward result goes through a float32 scratch volume in device
// memory that the caller provides.

#include "stm_common.cuh"

#define HSLO_BIG 1e30f
#define HSLO_GROUP 8

struct HsloPenalties {
  float p1[3];
  float p2[3];
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
  return hslo_unkey(__reduce_min_sync(0xFFFFFFFFu, hslo_key(v)));
}

template <int K>
struct HsloRow {
  const uint8_t* sa;     // small-gradient flags of the own image's row
  const uint8_t* sb;     // ... of the other image's row
  int W, D, zd, sign, d0, lane;
  HsloPenalties pen;

  // One DP step at column x: prev <- out.
  __device__ __forceinline__ void step(float (&prev)[K], const float (&c)[K],
                                       int x) const {
    float local = prev[0];
#pragma unroll
    for (int j = 1; j < K; ++j) local = fminf(local, prev[j]);
    const float mn = warp_min(local);
    float up_in = __shfl_down_sync(0xFFFFFFFFu, prev[0], 1);
    float dn_in = __shfl_up_sync(0xFFFFFFFFu, prev[K - 1], 1);
    if (lane == 31) up_in = HSLO_BIG;
    if (lane == 0) dn_in = HSLO_BIG;
    const int s1 = sa[x];
    float out[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int d = d0 + j;
      const int xp = min(max(x + sign * (d - zd), 0), W - 1);
      const int t = s1 + sb[xp];
      const float p1 = t == 2 ? pen.p1[2] : (t == 1 ? pen.p1[1] : pen.p1[0]);
      const float p2 = t == 2 ? pen.p2[2] : (t == 1 ? pen.p2[1] : pen.p2[0]);
      const float up = j + 1 < K ? prev[j + 1 < K ? j + 1 : j] : up_in;
      const float dn = j > 0 ? prev[j > 0 ? j - 1 : 0] : dn_in;
      const float best = fminf(fminf(prev[j], __fadd_rn(mn, p2)),
                               __fadd_rn(fminf(up, dn), p1));
      out[j] = d < D ? __fsub_rn(__fadd_rn(c[j], best), mn) : HSLO_BIG;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) prev[j] = out[j];
  }
};

// One column's K values of the lane's disparities (0 beyond D), as one
// 16-byte load where the lane owns four aligned values.
template <int K, typename T>
__device__ __forceinline__ void load_col(const T* __restrict__ p, int d0,
                                         int D, float (&c)[K]) {
  if (K == 4 && (D & 3) == 0) {
    struct alignas(16) Quad { T v[4]; };
    Quad q = {};
    if (d0 < D) q = *reinterpret_cast<const Quad*>(p + d0);
#pragma unroll
    for (int j = 0; j < K; ++j) c[j] = (float)q.v[j & 3];
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) c[j] = d0 + j < D ? (float)p[d0 + j] : 0.0f;
}

template <int K>
__device__ __forceinline__ void store_col(float* __restrict__ p, int d0,
                                          int D, const float (&c)[K]) {
  if (K == 4 && (D & 3) == 0) {
    if (d0 < D)
      *reinterpret_cast<float4*>(p + d0) = make_float4(c[0], c[1 % K],
                                                       c[2 % K], c[3 % K]);
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (d0 + j < D) p[d0 + j] = c[j];
}

template <int K>
__global__ void __launch_bounds__(32, 10)
hslo_kernel(const int32_t* __restrict__ vol, const uint8_t* __restrict__ ga,
            const uint8_t* __restrict__ gb, float* __restrict__ fwd,
            float* __restrict__ disp, int W, int D, int zd, int sign,
            float T, HsloPenalties pen) {
  extern __shared__ uint8_t flags[];
  uint8_t* sa = flags;
  uint8_t* sb = flags + W;
  const int y = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* ra = ga + (size_t)y * W;
  const uint8_t* rb = gb + (size_t)y * W;
  for (int x = lane; x < W; x += 32) {
    const int xm = max(x - 1, 0);
    sa[x] = (float)abs((int)ra[x] - (int)ra[xm]) < T;
    sb[x] = (float)abs((int)rb[x] - (int)rb[xm]) < T;
  }
  __syncwarp();

  HsloRow<K> row{sa, sb, W, D, zd, sign, lane * K, lane, pen};
  const int d0 = lane * K;
  const size_t base = (size_t)y * W * D;
  const int32_t* vrow = vol + base;
  float* frow = fwd + base;
  float prev[K];
  float cur[HSLO_GROUP][K], nxt[HSLO_GROUP][K];

  // forward: x = 0 .. W-1, results to the scratch volume
#pragma unroll
  for (int i = 0; i < HSLO_GROUP; ++i)
    if (i < W) load_col<K>(vrow + (size_t)i * D, d0, D, cur[i]);
  for (int x0 = 0; x0 < W; x0 += HSLO_GROUP) {
#pragma unroll
    for (int i = 0; i < HSLO_GROUP; ++i) {
      const int xn = x0 + HSLO_GROUP + i;
      if (xn < W) load_col<K>(vrow + (size_t)xn * D, d0, D, nxt[i]);
    }
#pragma unroll
    for (int i = 0; i < HSLO_GROUP; ++i) {
      const int x = x0 + i;
      if (x < W) {
        if (x == 0) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            prev[j] = d0 + j < D ? cur[i][j] : HSLO_BIG;
        } else {
          row.step(prev, cur[i], x);
        }
        store_col<K>(frow + (size_t)x * D, d0, D, prev);
      }
    }
#pragma unroll
    for (int i = 0; i < HSLO_GROUP; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) cur[i][j] = nxt[i][j];
  }

  // backward: x = W-1 .. 0, averaged with the forward result, then the
  // first-min WTA
  float fcur[HSLO_GROUP][K], fnxt[HSLO_GROUP][K];
#pragma unroll
  for (int i = 0; i < HSLO_GROUP; ++i) {
    const int x = W - 1 - i;
    if (x >= 0) {
      load_col<K>(vrow + (size_t)x * D, d0, D, cur[i]);
      load_col<K>(frow + (size_t)x * D, d0, D, fcur[i]);
    }
  }
  for (int x0 = W - 1; x0 >= 0; x0 -= HSLO_GROUP) {
#pragma unroll
    for (int i = 0; i < HSLO_GROUP; ++i) {
      const int xn = x0 - HSLO_GROUP - i;
      if (xn >= 0) {
        load_col<K>(vrow + (size_t)xn * D, d0, D, nxt[i]);
        load_col<K>(frow + (size_t)xn * D, d0, D, fnxt[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < HSLO_GROUP; ++i) {
      const int x = x0 - i;
      if (x >= 0) {
        if (x == W - 1) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            prev[j] = d0 + j < D ? cur[i][j] : HSLO_BIG;
        } else {
          row.step(prev, cur[i], x);
        }
        float best = HSLO_BIG;
        int arg = d0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float a = d0 + j < D
                              ? __fmul_rn(__fadd_rn(fcur[i][j], prev[j]), 0.5f)
                              : HSLO_BIG;
          if (j == 0 || a < best) {       // strict: the first minimum wins
            best = a;
            arg = d0 + j;
          }
        }
        const unsigned key = d0 < D ? hslo_key(best) : 0xFFFFFFFFu;
        const unsigned m = __reduce_min_sync(0xFFFFFFFFu, key);
        const unsigned hit = __ballot_sync(0xFFFFFFFFu, key == m);
        if (lane == __ffs(hit) - 1)
          disp[(size_t)y * W + x] = (float)(arg - zd);
      }
    }
#pragma unroll
    for (int i = 0; i < HSLO_GROUP; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        cur[i][j] = nxt[i][j];
        fcur[i][j] = fnxt[i][j];
      }
  }
}

template <int K>
static int launch_hslo(const void* vol, const void* ga, const void* gb,
                       void* fwd, void* disp, int H, int W, int D, int zd,
                       int sign, float T, const HsloPenalties& pen,
                       void* stream) {
  const size_t smem = 2 * (size_t)W;
  cudaError_t err = stm_smem_cap(hslo_kernel<K>, smem);
  if (err != cudaSuccess) return (int)err;
  hslo_kernel<K><<<H, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)vol, (const uint8_t*)ga, (const uint8_t*)gb,
      (float*)fwd, (float*)disp, W, D, zd, sign, T, pen);
  return (int)cudaGetLastError();
}

// vol (H, W, D) i32, non-negative; ga, gb (H, W) u8: the own and the other
// image's gray; fwd (H, W, D) f32 scratch; disp (H, W) f32.  p1, p2: host
// arrays of the three tiers' penalties (0, 1, 2 small gradients).  sign:
// +1 for the left eye's volume, -1 for the right's.  D <= 256.
STM_API int stm_hslo_wta(const void* vol, const void* ga, const void* gb,
                         void* fwd, void* disp, int H, int W, int D, int zd,
                         int sign, float T, const float* p1, const float* p2,
                         void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || D > 256 || (sign != 1 && sign != -1) ||
      p1 == nullptr || p2 == nullptr || 2 * (size_t)W > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  HsloPenalties pen;
  for (int t = 0; t < 3; ++t) {
    pen.p1[t] = p1[t];
    pen.p2[t] = p2[t];
  }
  const int k = (D + 31) / 32;
  if (k <= 1)
    return launch_hslo<1>(vol, ga, gb, fwd, disp, H, W, D, zd, sign, T, pen,
                          stream);
  if (k <= 2)
    return launch_hslo<2>(vol, ga, gb, fwd, disp, H, W, D, zd, sign, T, pen,
                          stream);
  if (k <= 4)
    return launch_hslo<4>(vol, ga, gb, fwd, disp, H, W, D, zd, sign, T, pen,
                          stream);
  return launch_hslo<8>(vol, ga, gb, fwd, disp, H, W, D, zd, sign, T, pen,
                        stream);
}
