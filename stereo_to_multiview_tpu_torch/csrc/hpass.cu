// B4/B6: the horizontal passes of the cross aggregation.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py `_res_kernel`
// in mode "int" (reached via `_band_pass_h` from `band_aggregate_q`):
//   pass 1 (B4): y = sum over [x - LEFT, x + RIGHT) of the u8 cost volume
//                (or, at band_qscale > 127.5, of the int16 one: `terms=2`,
//                band.py:649), rescaled by s1, stored int32;
//   pass 4 (B6): the same sum of the int32 VV output, then the first-min
//                argmin over D: disp = argmin - zd as float32; or, for the
//                scanline optimisation that follows it when cfg.use_hslo
//                is set, the sum alone as an int32 volume (`_band_pass_h`
//                with out_dtype int32 and no WTA, band.py
//                `band_aggregate_q(zero_disp=None, final_out_t=True)`).
// and in mode "float", terms=1, with the WTA (band_lossy_wta, band.py:
// 704-708): each int32 input rounded to bf16 (round to nearest, ties to
// even) before the window sum.  Every such value is an integer, and the
// pass-4 inputs stay below (2^24 - 1) / (2 * usd + 1) (the rescale
// shifts), so the window sums stay below 2^24: the float32 dot of the TPU
// kernel is exact in any order, and the integer sum here equals it.
// Volumes are (H, W, D), D innermost; the u8 and int16 inputs may have a
// row stride larger than W*D (the left eye is a column slice of the pair
// volume).
// Windows are half-open, [max(x - an, 0), min(x + ap, W)), the arms
// clamped to [0, reach] (an arm of 0 excludes the anchor side); a sum is
// rescaled by (y + 2^(shift-1)) >> shift.  All sums are exact integers.
//
// Bound on the H100: memory.  At 1080p/D=128 pass 1 reads 0.27 GB of u8
// and writes 1.06 GB of int32 per eye (~0.4 ms); pass 4 reads 1.06 GB
// and writes 8 MB (~0.32 ms), or 1.06 GB without the WTA (~0.64 ms).
//
// Design: one warp streams one row (two rows when D <= 64) along x over a
// segment of S <= HP_SEG output columns, primed over the reach to its
// left and run reach columns past its right end.  Lane g owns the 4
// consecutive d = 4g .. 4g + 3 of each position (of each chunk of 4 * G d
// when D > 128), so a warp reads a position's 128 d as one 32-bit load a
// lane (u8: 128 B), one 8-byte load (int16: 256 B) or one 16-byte load
// (int32: 512 B).  The running
// prefix of each owned d goes into a ring of N = 2 * reach + STEP + 1
// slots in shared memory, the warp's own (no barrier anywhere); output x
// is P(min(x + ap, W)) - P(max(x - an, 0)), taken reach positions behind
// the newest input.  Pass 1's prefixes are u16, packed two a u32 word: a
// window sum is at most (2 * reach + 1) * 255 < 2^16 for reach <= 127, so
// the wrapped difference of a word is exact in both halves (the low
// half's carries cancel).  Pass 1 on int16 costs and pass 4 take u32
// prefixes: their window sums reach 2^22 (129 x 32766) and stay below
// 2^31.  Positions go in batches of STEP: the next batch's inputs and
// arms are loaded before the current batch is pushed, and kept raw until
// it comes up; a batch pushes all its positions, then reads its outputs
// (the ring holds STEP slots more for that).  A batch whose positions
// all push and all output runs without a branch, so the positions'
// loads, shuffles and reductions overlap (on an H100 the WTA pass at
// 1080p took 0.84 ms with a branch per position, 0.60 without).  Lane k
// of a row's group loads the arms of the batch's position k and hands
// its window to the group by shuffle.  The WTA takes, in each lane, the
// first minimum of its own d with a strict < in ascending d, then two
// __reduce_min_sync over the warp (the minimum, then the least d holding
// it): no cross-warp pass, and only the (H, W) float plane is written, a
// batch's results as one coalesced store.  A D that is no multiple of 4, or a
// row or base not aligned to the vector width, takes scalar loads and
// stores with the tail of d masked.
//
// A block is one warp.  At usd = 34 a ring is 85 slots of 8 bytes a lane
// for pass 1 (21.8 KB a warp, 10 warps resident an SM), 85 of 16 bytes
// for pass 4 without the WTA (43.5 KB, 5 warps) and 77 of 16 bytes with
// it (39.4 KB, 5 warps).  The halo re-read falls from 2.06x (the tiled
// predecessor) to 1 + 2 * reach / S (1.28x at 1080p, S = 240, mostly
// from L2: neighbouring segments of a row are neighbouring blocks).
// Segments of 512 measured faster for the WTA pass at 1080p, but they
// leave the 540-row LOWRES frame 540 warps, fewer than the card holds.

#include <cuda_bf16.h>

#include <type_traits>

#include "stm_common.cuh"

// positions of a batch (<= 16): the sums keep more loads in flight, the
// WTA pass fewer registers and ring slots (on an H100 at 1080p, 16 against
// 8: sum-only 0.88 against 0.94 ms, WTA 0.60 against 0.57)
#define HP_STEP_SUM 16
#define HP_STEP_WTA 8
#define HP_SEG 256                  // most output columns of a segment
#define HP_SMEM_MAX (227 * 1024)    // shared memory a block may hold

// A lane's raw input for its 4 d of one position, and its 4 prefixes.
template <typename TIn> struct HpTypes;
template <> struct HpTypes<uint8_t> {
  typedef uint32_t Raw;             // bytes d0 .. d0 + 3
  typedef uint2 Pre;                // (d0 | d1 << 16, d2 | d3 << 16)
};
template <> struct HpTypes<int16_t> {
  typedef uint2 Raw;                // d0 | d1 << 16, d2 | d3 << 16
  typedef uint4 Pre;                // one u32 a d
};
template <> struct HpTypes<int32_t> {
  typedef int4 Raw;
  typedef uint4 Pre;
};

// The lane's 4 values at p (d0 .. d0 + 3 of one position); nd = D - d0
// of them exist (none when nd <= 0), the rest read as 0.
template <bool VEC>
__device__ __forceinline__ uint32_t hp_load(const uint8_t* p, int nd) {
  if (VEC) return nd > 0 ? *reinterpret_cast<const uint32_t*>(p) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nd) v |= (uint32_t)p[j] << (8 * j);
  return v;
}

template <bool VEC>
__device__ __forceinline__ uint2 hp_load(const int16_t* p, int nd) {
  if (VEC) return nd > 0 ? *reinterpret_cast<const uint2*>(p)
                         : make_uint2(0u, 0u);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nd) v[j] = (uint16_t)p[j];
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

template <bool VEC>
__device__ __forceinline__ int4 hp_load(const int32_t* p, int nd) {
  if (VEC) return nd > 0 ? *reinterpret_cast<const int4*>(p)
                         : make_int4(0, 0, 0, 0);
  int4 v = make_int4(0, 0, 0, 0);
  if (nd > 0) v.x = p[0];
  if (nd > 1) v.y = p[1];
  if (nd > 2) v.z = p[2];
  if (nd > 3) v.w = p[3];
  return v;
}

__device__ __forceinline__ void hp_add(uint2& P, uint32_t v) {
  P.x += __byte_perm(v, 0u, 0x4140);          // byte 0 | byte 1 << 16
  P.y += __byte_perm(v, 0u, 0x4342);          // byte 2 | byte 3 << 16
}

// int16: each half sign-extended (the costs are >= 0 on every path)
__device__ __forceinline__ void hp_add(uint4& P, uint2 v) {
  P.x += (uint32_t)(int32_t)(int16_t)(v.x & 0xFFFFu);
  P.y += (uint32_t)((int32_t)v.x >> 16);
  P.z += (uint32_t)(int32_t)(int16_t)(v.y & 0xFFFFu);
  P.w += (uint32_t)((int32_t)v.y >> 16);
}

__device__ __forceinline__ void hp_add(uint4& P, int4 v) {
  P.x += (uint32_t)v.x;
  P.y += (uint32_t)v.y;
  P.z += (uint32_t)v.z;
  P.w += (uint32_t)v.w;
}

// band_lossy_wta: an int32 rounded to bf16 (round to nearest even) and
// back, exact as an integer below 2^24
__device__ __forceinline__ int hp_bf16(int v) {
  return __float2int_rn(__bfloat162float(__float2bfloat16_rn(
      __int2float_rn(v))));
}

__device__ __forceinline__ int4 hp_bf16(int4 v) {
  return make_int4(hp_bf16(v.x), hp_bf16(v.y), hp_bf16(v.z), hp_bf16(v.w));
}

// The 4 window sums hi - lo.
__device__ __forceinline__ void hp_sums(uint2 hi, uint2 lo, uint32_t (&s)[4]) {
  const uint32_t a = hi.x - lo.x, b = hi.y - lo.y;
  s[0] = a & 0xFFFFu;
  s[1] = a >> 16;
  s[2] = b & 0xFFFFu;
  s[3] = b >> 16;
}

__device__ __forceinline__ void hp_sums(uint4 hi, uint4 lo, uint32_t (&s)[4]) {
  s[0] = hi.x - lo.x;
  s[1] = hi.y - lo.y;
  s[2] = hi.z - lo.z;
  s[3] = hi.w - lo.w;
}

// Slot of prefix j when the newest, jn, sits in slot w of an N-slot ring.
__device__ __forceinline__ int hp_slot(int w, int jn, int j, int N) {
  const int s = w - (jn - j);
  return s < 0 ? s + N : s;
}

// One warp a (row group, segment): blockIdx.x = row group * nseg + seg.
// G lanes a row (32, or 16 when D <= 64: two rows a warp).  LOSSY (int32
// with the WTA only) rounds each input to bf16 as its batch comes up.
template <typename TIn, bool WTA, int G, bool VEC, bool LOSSY>
__global__ void __launch_bounds__(32)
hpass_kernel(const TIn* __restrict__ in, long long in_row,
             const int* __restrict__ arm_neg, const int* __restrict__ arm_pos,
             int32_t* __restrict__ out, float* __restrict__ disp, int H,
             int W, int D, int reach, int shift, int zd, int S, int nseg,
             int N) {
  typedef typename HpTypes<TIn>::Raw Raw;
  typedef typename HpTypes<TIn>::Pre Pre;
  constexpr int R = 32 / G;                   // rows of a warp
  constexpr int STEP = WTA ? HP_STEP_WTA : HP_STEP_SUM;
  extern __shared__ __align__(16) unsigned char hp_smem[];
  Pre* ring = reinterpret_cast<Pre*>(hp_smem);          // [slot][lane]
  uint2* best = reinterpret_cast<uint2*>(ring + (size_t)N * 32);

  const int lane = threadIdx.x;
  const int r = lane / G, g = lane % G;
  const int seg = blockIdx.x % nseg;
  const int y0 = (blockIdx.x / nseg) * R;
  const int y = y0 + r;
  const bool row_ok = y < H;
  const int x0 = seg * S, x1 = min(x0 + S, W);
  const int q0 = max(x0 - reach, 0), q1 = min(x1 + reach, W);
  // step i pushes input column q0 + i (if < q1) and outputs x = q0 + i -
  // reach (if in [x0, x1))
  const int steps = x1 + reach - q0;
  const int nchunk = (D + 4 * G - 1) / (4 * G);
  const int half = shift > 0 ? 1 << (shift - 1) : 0;
  // lane e loads the arms of batch position e % STEP of row e / STEP of
  // the warp's rows; a row's group reads them from lane r * STEP + k
  const int ar = lane / STEP, ak = lane % STEP;
  const bool arm_lane = ar < R && y0 + ar < H;
  const int* an_row = arm_neg + (size_t)(y0 + ar) * W;
  const int* ap_row = arm_pos + (size_t)(y0 + ar) * W;
  const int src0 = r * STEP;

  for (int c = 0; c < nchunk; ++c) {
    const int d0 = c * 4 * G + 4 * g;
    const int nd = row_ok ? D - d0 : 0;       // the lane's d that exist
    const TIn* src = in + (size_t)(row_ok ? y : 0) * in_row + d0;
    Pre P = {};
    ring[lane] = P;                           // P(0) = 0 in slot 0
    int w = 0;                                // slot of the newest prefix

    Raw vnext[STEP];
    int an_next = 0, ap_next = 0;
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
      const int q = q0 + k;
      vnext[k] = hp_load<VEC>(src + (size_t)q * D, q < q1 ? nd : 0);
    }
    {
      const int x = q0 + ak - reach;
      if (arm_lane && x >= x0 && x < x1) {
        an_next = an_row[x];
        ap_next = ap_row[x];
      }
    }

    for (int i0 = 0; i0 < steps; i0 += STEP) {
      Raw v[STEP];
#pragma unroll
      for (int k = 0; k < STEP; ++k) v[k] = vnext[k];
      const int an_raw = an_next, ap_raw = ap_next;
      if (i0 + STEP < steps) {             // the next batch's loads
        const int i1 = i0 + STEP;
#pragma unroll
        for (int k = 0; k < STEP; ++k) {
          const int q = q0 + i1 + k;
          vnext[k] = hp_load<VEC>(src + (size_t)q * D, q < q1 ? nd : 0);
        }
        const int x = q0 + i1 + ak - reach;
        an_next = ap_next = 0;
        if (arm_lane && x >= x0 && x < x1) {
          an_next = an_row[x];
          ap_next = ap_row[x];
        }
      }

      // push the batch's inputs: P(j) for j up to jn.  A batch whose
      // positions all exist (all but the last of a segment's batches)
      // runs branch-free, so the positions' work can overlap.
      const int w0 = w;
      auto push = [&](int k) {
        if constexpr (LOSSY)
          hp_add(P, hp_bf16(v[k]));
        else
          hp_add(P, v[k]);
        const int slot = w0 + k + 1;
        ring[(slot < N ? slot : slot - N) * 32 + lane] = P;
      };
      const int npush = min(STEP, q1 - q0 - i0);
      if (npush == STEP) {
#pragma unroll
        for (int k = 0; k < STEP; ++k) push(k);
      } else {
#pragma unroll
        for (int k = 0; k < STEP; ++k)
          if (k < npush) push(k);
      }
      if (npush > 0) w = w0 + npush < N ? w0 + npush : w0 + npush - N;
      const int jn = min(i0 + STEP, q1 - q0);

      // this lane's window (as prefix indices hi << 16 | lo), for batch
      // position ak of row ar; a row below the frame reads the newest
      // prefix twice
      unsigned win = ((unsigned)jn << 16) | (unsigned)jn;
      {
        const int x = q0 + i0 + ak - reach;
        if (arm_lane && x >= x0 && x < x1) {
          const int an = min(max(an_raw, 0), reach);
          const int ap = min(max(ap_raw, 0), reach);
          win = ((unsigned)(min(x + ap, W) - q0) << 16) |
                (unsigned)(max(x - an, 0) - q0);
        }
      }

      unsigned res = 0;                       // WTA: position ak's d
      uint32_t res_m = 0;
      // output x = q0 + i0 + k - reach of the batch
      auto emit = [&](int k) {
        const unsigned wk = __shfl_sync(0xFFFFFFFFu, win, src0 + k);
        const int x = q0 + i0 + k - reach;
        const Pre ph = ring[hp_slot(w, jn, (int)(wk >> 16), N) * 32 + lane];
        const Pre pl = ring[hp_slot(w, jn, (int)(wk & 0xFFFFu), N) * 32 +
                            lane];
        uint32_t s[4];
        hp_sums(ph, pl, s);
        if (!WTA) {
          int32_t o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = ((int32_t)s[j] + half) >> shift;
          int32_t* dst = out + ((size_t)y * W + x) * D + d0;
          if (VEC) {
            if (nd > 0) *reinterpret_cast<int4*>(dst) =
                make_int4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < nd) dst[j] = o[j];
          }
        } else {
          // the lane's first minimum, ascending d; no d: never a minimum
          uint32_t bv = 0xFFFFFFFFu;
          unsigned bd = 0xFFFFFFFFu;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((VEC ? nd > 0 : j < nd) && s[j] < bv) {
              bv = s[j];
              bd = (unsigned)(d0 + j);
            }
          }
          // per row of the warp: the least value, then the least d
          // holding it
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const uint32_t m =
                __reduce_min_sync(0xFFFFFFFFu, r == rr ? bv : 0xFFFFFFFFu);
            const unsigned a = __reduce_min_sync(
                0xFFFFFFFFu, r == rr && bv == m ? bd : 0xFFFFFFFFu);
            if (lane == rr * STEP + k) {
              res_m = m;
              res = a;
            }
          }
        }
      };
      const int xb = q0 + i0 - reach;         // output of batch position 0
      if (xb >= x0 && xb + STEP <= x1) {
#pragma unroll
        for (int k = 0; k < STEP; ++k) emit(k);
      } else {
#pragma unroll
        for (int k = 0; k < STEP; ++k)
          if (xb + k >= x0 && xb + k < x1) emit(k);  // uniform over the warp
      }

      if (WTA) {
        const int x = q0 + i0 + ak - reach;
        if (arm_lane && x >= x0 && x < x1) {
          if (c > 0) {                        // an earlier chunk of d
            const uint2 b = best[x - x0];
            if (!(res_m < b.x)) {             // strict: the first min wins
              res_m = b.x;
              res = b.y;
            }
          }
          if (c + 1 < nchunk)
            best[x - x0] = make_uint2(res_m, res);
          else
            disp[(size_t)(y0 + ar) * W + x] = (float)((int)res - zd);
        }
      }
    }
  }
}

template <typename TIn, bool WTA, int G, bool VEC, bool LOSSY>
static cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t stream,
                              const TIn* in, long long in_row, const int* an,
                              const int* ap, int32_t* out, float* disp,
                              int H, int W, int D, int reach, int shift,
                              int zd, int S, int nseg, int N) {
  auto kernel = hpass_kernel<TIn, WTA, G, VEC, LOSSY>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32, smem, stream>>>(in, in_row, an, ap, out, disp, H, W, D,
                                     reach, shift, zd, S, nseg, N);
  return cudaGetLastError();
}

template <typename TIn, bool WTA, bool LOSSY = false>
static int launch_hpass(const void* in_v, long long in_row, const void* an,
                        const void* ap, void* out_v, void* disp, int H,
                        int W, int D, int reach, int shift, int zd,
                        void* stream) {
  typedef typename HpTypes<TIn>::Pre Pre;
  const TIn* in = (const TIn*)in_v;
  int32_t* out = (int32_t*)out_v;
  if (H <= 0 || W <= 0 || D <= 0 || reach < 0 || shift < 0 || shift > 30 ||
      in_row < (long long)W * D)
    return (int)cudaErrorInvalidValue;
  if (sizeof(TIn) == 1 && reach > 127)        // u16 prefix differences
    return (int)cudaErrorInvalidValue;
  const int nseg = (W + HP_SEG - 1) / HP_SEG;
  const int S = (W + nseg - 1) / nseg;
  const int N = 2 * reach + (WTA ? HP_STEP_WTA : HP_STEP_SUM) + 1;
  if (S + N > 65535) return (int)cudaErrorInvalidValue;  // 16-bit indices
  const int G = D <= 64 ? 16 : 32;
  const int nchunk = (D + 4 * G - 1) / (4 * G);
  const size_t smem = (size_t)N * 32 * sizeof(Pre) +
                      (WTA && nchunk > 1 ? (size_t)S * sizeof(uint2) : 0);
  if (smem > HP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const size_t align = 4 * sizeof(TIn);       // one lane's 4 d
  const bool vec = D % 4 == 0 && in_row % 4 == 0 &&
                   (uintptr_t)in % align == 0 &&
                   (out == nullptr || (uintptr_t)out % 16 == 0);
  const dim3 grid(nseg * ((H + 32 / G - 1) / (32 / G)));
  cudaStream_t st = (cudaStream_t)stream;
  float* dp = (float*)disp;
  const int* a = (const int*)an;
  const int* b = (const int*)ap;
  auto go = [&](auto kern_g, auto kern_vec) {
    return launch_one<TIn, WTA, decltype(kern_g)::value,
                      decltype(kern_vec)::value, LOSSY>(
        grid, smem, st, in, in_row, a, b, out, dp, H, W, D, reach, shift, zd,
        S, nseg, N);
  };
  using G32 = std::integral_constant<int, 32>;
  using G16 = std::integral_constant<int, 16>;
  using Vec = std::true_type;
  using Scalar = std::false_type;
  const cudaError_t err =
      G == 32 ? (vec ? go(G32{}, Vec{}) : go(G32{}, Scalar{}))
              : (vec ? go(G16{}, Vec{}) : go(G16{}, Scalar{}));
  return (int)err;
}

// Pass 1: in (H, W, D) u8 with row stride in_row elements (x stride D);
// an/ap (H, W) i32; out (H, W, D) i32.
STM_API int stm_hpass_sum_u8(const void* in, long long in_row, const void* an,
                             const void* ap, void* out, int H, int W, int D,
                             int reach, int shift, void* stream) {
  return launch_hpass<uint8_t, false>(in, in_row, an, ap, out, nullptr, H, W,
                                      D, reach, shift, 0, stream);
}

// Pass 1 at band_qscale > 127.5: in (H, W, D) int16 with row stride in_row
// elements (x stride D); an/ap (H, W) i32; out (H, W, D) i32.
STM_API int stm_hpass_sum_i16(const void* in, long long in_row,
                              const void* an, const void* ap, void* out,
                              int H, int W, int D, int reach, int shift,
                              void* stream) {
  return launch_hpass<int16_t, false>(in, in_row, an, ap, out, nullptr, H, W,
                                      D, reach, shift, 0, stream);
}

// Pass 4 + WTA: in (H, W, D) i32 contiguous; an/ap (H, W) i32;
// disp (H, W) f32.  lossy != 0: each input rounded to bf16 first.
STM_API int stm_hpass_wta_i32(const void* in, const void* an, const void* ap,
                              void* disp, int H, int W, int D, int reach,
                              int zd, int lossy, void* stream) {
  if (lossy)
    return launch_hpass<int32_t, true, true>(in, (long long)W * D, an, ap,
                                             nullptr, disp, H, W, D, reach, 0,
                                             zd, stream);
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
