// B18a/c: the horizontal passes of the cross aggregation in the
// disparity-major (2D, H, W) layout, both eyes in one volume (left eye on
// planes [0, D), right eye on [D, 2D)), int16 between the passes; the
// vertical passes between them (B18b) are in vvdm.cu.
//
// Replace the TPU kernels stereo_to_multiview_tpu/ops/band.py
// `_pass1_dm_kernel` (B18a) and `_pass4_dm_kernel` (B18c), reached via
// `band_aggregate_q_dm` and `band_stereo_core_dm`:
//   pass 1:  y = sum over [x - LEFT, x + RIGHT) of the u8 cost, int16 (a
//            window is at most 2 * reach <= 128 wide, so every sum stays
//            below 128 * 255 < 2^15);
//   pass 4:  the same sum of the int16 output of passes 2+3 (int32, it
//            reaches 128 * 32767 < 2^22), then the FIRST minimum over d
//            per eye: disp = argmin - zd as float32.
// Windows are half-open and clipped to the image; arms are clamped to
// [0, reach].  The TPU kernels multiply base-256 bf16 digit planes with
// 0/1 band matrices on the MXU; the integers are the same, and on this
// card they are prefix-sum differences along the row.
//
// Bound on the H100: bytes.  Pass 1 reads the u8 volume and writes it as
// int16, pass 4 reads the int16 volume and writes two float planes; both
// read four int32 arm planes.  Both eyes at 1080p/D=128: 0.53 + 1.06 GB
// (0.485 ms at 3.35 TB/s) and 1.06 GB (0.332 ms); a 680x3840 chunk of the
// 4K preset: 0.611 and 0.418 ms.
//
// Design.  A warp owns one (eye, row, segment of TX <= 512 output
// columns, group of planes).  It scans the 640 columns from s0 = x0 - RL
// (RL = reach rounded up to 16) as 16 columns a lane (lane l's columns
// s0 + 16 l ..) and then 4 a lane (s0 + 512 + 4 l ..).  For each plane it
// takes each lane's local prefixes, a warp shuffle scan of the lanes'
// totals, and writes the span's exclusive prefixes P[0..640] into its own
// slots in shared memory (P[i] in slot i + i / 16: one pad slot in 16, so
// that the lanes' 16 writes fall in distinct banks); after a __syncwarp
// each output is P[hi] - P[lo].  Lane l's outputs are x0 + l + 32 j, so
// neighbouring lanes read neighbouring windows (few bank conflicts where
// arms vary slowly) and store neighbouring columns.  The slots are double
// buffered, so one __syncwarp a plane is the only synchronisation of the
// loop.  What it does about the old design's limits (a block of 128
// threads a row and tile of TX + 2 R <= 512 columns, 4 a thread, two
// __syncthreads and a shared-memory scan a plane, one plane in flight):
//  - no block barrier in the plane loop: a warp shares nothing with the
//    other warps of its block (P <= 8 groups of the eye's planes on the
//    same row segment, more of them for short frames) until the WTA's one
//    final reduction;
//  - bytes in flight: each lane loads 16 bytes a plane (16 u8 columns or,
//    as two loads, 16 int16 columns) and 4 columns more for the halo, the
//    next step's loads issued before the current step is scanned (a ring
//    of HDM_NS = 2 steps in registers; 3 measured slower);
//  - halo re-read: segments of ~480 columns at W = 1920 and 3840 scan
//    RL + TX + reach columns, of which only the 16- and 4-column units a
//    window reaches are loaded (1.15-1.17x at reach 34, against 1.19x);
//  - window bounds once per (row, column): each lane keeps its 16 outputs'
//    slot offsets of P[lo] and P[hi] packed in 16 registers for all of
//    its planes;
//  - pass 1 packs two planes a word: column c's word is a(c) | b(c) << 16
//    for planes d and d + 1, so one scan, one write and two reads serve
//    both planes; the low half of a word difference is plane d's sum
//    (below 2^16: its carries into the high half cancel in the
//    difference), the high half plane d + 1's.  Its stores are 2 bytes a
//    lane, 64 neighbouring bytes a warp: a layout of 16 neighbouring
//    columns a lane with two 16-byte stores a plane measured slower on
//    the card (its reads of P conflict in the banks);
//  - pass 4 keeps each output's running first minimum in a lane register
//    as the key sum * 256 + d (sum * 2^32 + d in 64 bits when D > 256): a
//    min of keys is the least sum and, among equal sums, the least d,
//    which is the strict `<` over ascending d; the P warps' keys meet
//    once in shared memory and each (H, W) float plane is written once;
//  - any W and any base: rows whose starts are 16-byte aligned (u8 W %
//    16 == 0, int16 W % 8 == 0, an aligned base) load each unit that a
//    window reaches with one vector load; other rows load the 4-byte
//    words that overlap the row and the lane's columns (one more than the
//    columns need) and shift them into place with __byte_perm.  Columns
//    of a loaded unit that lie outside the row (the neighbouring rows'
//    bytes) enter the prefixes but no window, so they cancel in every
//    difference; no load leaves the row's bytes (rounded out to 4-byte
//    words).
// 120-128 registers a thread (the launch bound allows 128), no spills but
// 4 bytes in the unaligned-row variant with 64-bit keys.  The old design
// (PR 3) took 1.374 ms (pass 1) and 1.150 ms (pass 4) at 1080p, 1.598 and
// 1.324 ms on a 680x3840 chunk, 0.17 and 0.15 ms at 200x1001 (NVIDIA H100
// 80GB HBM3, 700 W): 29-38% of the bound.

#include "stm_common.cuh"

#include <limits.h>

#define HDM_TX 512                     // most output columns a segment
#define HDM_SLOTS 684                  // slots of P[0..HDM_TX + 128], padded
#define HDM_NS 2                       // steps in the ring of loads
#define HDM_PMAX 8                     // warps (plane groups) a block
#define HDM_WARPS 16384                // warps a launch aims for

// The slot of prefix P[i]: one pad slot after every 16.
__host__ __device__ __forceinline__ int hdm_slot(int i) { return i + (i >> 4); }

// A lane's raw loads of one step (PS planes): g, the words of its 16
// columns; t, those of its 4 halo columns.  Without VEC one more word
// each, for the shift into place.
template <typename TIn, bool VEC>
struct HdmStep {
  static constexpr int ES = (int)sizeof(TIn);
  static constexpr int PS = ES == 1 ? 2 : 1;       // planes a step
  static constexpr int NG = 4 * ES + (VEC ? 0 : 1);
  static constexpr int NT = ES + (VEC ? 0 : 1);
  uint32_t g[PS][NG];
  uint32_t t[PS][NT];
};

// Byte offset (0..3) of column c0 of `row` from a 4-byte boundary: the
// same for every lane's columns (16 * ES and 4 * ES apart).
template <typename TIn>
__device__ __forceinline__ int hdm_misalign(const TIn* row, int c0) {
  return (int)(((uintptr_t)row + (uintptr_t)(intptr_t)(c0 * (int)sizeof(TIn)))
               & 3u);
}

// One plane's row: the lane's 16 columns from c0 into g, its 4 from c1
// into t.  need: bit 0 (u8) or bits 0, 1 (the int16 halves) the group,
// bit 2 the halo unit; an unneeded unit reads as 0.
template <typename TIn, bool VEC>
__device__ __forceinline__ void hdm_load(
    const TIn* __restrict__ row, int W, int c0, int c1, unsigned need,
    uint32_t (&g)[HdmStep<TIn, VEC>::NG],
    uint32_t (&t)[HdmStep<TIn, VEC>::NT]) {
  constexpr int ES = (int)sizeof(TIn);
  if constexpr (VEC) {
    // rows 16-byte aligned: each unit lies wholly inside or outside it
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int h = 0; h < ES; ++h) {
      const uint4 v = (need >> h) & 1u
          ? *reinterpret_cast<const uint4*>(row + c0 + 8 * h) : z;
      g[4 * h] = v.x;
      g[4 * h + 1] = v.y;
      g[4 * h + 2] = v.z;
      g[4 * h + 3] = v.w;
    }
    if constexpr (ES == 1) {
      t[0] = need & 4u ? *reinterpret_cast<const uint32_t*>(row + c1) : 0u;
    } else {
      const uint2 v = need & 4u ? *reinterpret_cast<const uint2*>(row + c1)
                                : make_uint2(0u, 0u);
      t[0] = v.x;
      t[1] = v.y;
    }
  } else {
    // the 4-byte words that overlap both the unit and the row's bytes
    const char* rb = reinterpret_cast<const char*>(row);
    const int nb = W * ES;
    const int mb = hdm_misalign(row, c0);
    const bool ng = (need & 3u) != 0u, nt = (need & 4u) != 0u;
    const int a0 = c0 * ES - mb, a1 = c1 * ES - mb;
#pragma unroll
    for (int k = 0; k < HdmStep<TIn, VEC>::NG; ++k) {
      const int o = a0 + 4 * k;
      g[k] = ng && o + 4 > 0 && o < nb
          ? *reinterpret_cast<const uint32_t*>(rb + o) : 0u;
    }
#pragma unroll
    for (int k = 0; k < HdmStep<TIn, VEC>::NT; ++k) {
      const int o = a1 + 4 * k;
      t[k] = nt && o + 4 > 0 && o < nb
          ? *reinterpret_cast<const uint32_t*>(rb + o) : 0u;
    }
  }
}

// The lane's words in place: n words from w (n + 1 without VEC, shifted
// by mb bytes).
template <bool VEC, int N>
__device__ __forceinline__ void hdm_align(const uint32_t* w, int mb,
                                          uint32_t (&o)[N]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = w[q];
  } else {
    const unsigned sel = 0x3210u + 0x1111u * (unsigned)mb;
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = __byte_perm(w[q], w[q + 1], sel);
  }
}

// Column words of a step: c (the lane's 16 columns), h (its 4 halo
// columns).  u8: planes d, d + 1 as a(c) | b(c) << 16.
template <bool VEC>
__device__ __forceinline__ void hdm_words(
    const HdmStep<uint8_t, VEC>& st, const int (&mb)[2], uint32_t (&c)[16],
    uint32_t (&h)[4]) {
  uint32_t a[4], b[4], at[1], bt[1];
  hdm_align<VEC, 4>(st.g[0], mb[0], a);
  hdm_align<VEC, 4>(st.g[1], mb[1], b);
  hdm_align<VEC, 1>(st.t[0], mb[0], at);
  hdm_align<VEC, 1>(st.t[1], mb[1], bt);
  uint32_t w[20];
  auto pack = [&](uint32_t av, uint32_t bv, int q) {
    const uint32_t lo = __byte_perm(av, bv, 0x5140);   // a0 b0 a1 b1
    const uint32_t hi = __byte_perm(av, bv, 0x7362);   // a2 b2 a3 b3
    w[4 * q] = __byte_perm(lo, 0u, 0x4140);            // a0 | b0 << 16
    w[4 * q + 1] = __byte_perm(lo, 0u, 0x4342);
    w[4 * q + 2] = __byte_perm(hi, 0u, 0x4140);
    w[4 * q + 3] = __byte_perm(hi, 0u, 0x4342);
  };
#pragma unroll
  for (int q = 0; q < 4; ++q) pack(a[q], b[q], q);
  pack(at[0], bt[0], 4);
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = w[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = w[16 + i];
}

// int16: one plane, each column sign-extended to 32 bits.
template <bool VEC>
__device__ __forceinline__ void hdm_words(
    const HdmStep<int16_t, VEC>& st, const int (&mb)[1], uint32_t (&c)[16],
    uint32_t (&h)[4]) {
  uint32_t g[8], t[2];
  hdm_align<VEC, 8>(st.g[0], mb[0], g);
  hdm_align<VEC, 2>(st.t[0], mb[0], t);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[2 * q] = (uint32_t)(int32_t)(int16_t)(g[q] & 0xFFFFu);
    c[2 * q + 1] = (uint32_t)((int32_t)g[q] >> 16);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    h[2 * q] = (uint32_t)(int32_t)(int16_t)(t[q] & 0xFFFFu);
    h[2 * q + 1] = (uint32_t)((int32_t)t[q] >> 16);
  }
}

// The WTA's key of a sum r at plane d, and d back from a key.
template <typename Key>
__device__ __forceinline__ Key hdm_key(int r, int d) {
  if constexpr (sizeof(Key) == 8)
    return (long long)r * 4294967296LL + d;
  else
    return r * 256 + d;
}

template <typename Key>
__device__ __forceinline__ int hdm_arg(Key k) {
  if constexpr (sizeof(Key) == 8)
    return (int)(k & 0xFFFFFFFFLL);
  else
    return k & 255;
}

// in: (2D, H, W); arms (H, W) i32 per eye; WTA false: out (2D, H, W) i16;
// WTA true: disp_l/disp_r (H, W) f32.  Block (32, P): blockIdx.x = (eye *
// H + row) * nseg + segment, warp w the eye's planes [w * DG, + DG).
// Lane l's outputs are x0 + l + 32 j.  Dynamic shared memory: P x 2 x
// HDM_SLOTS u32.
template <typename TIn, bool WTA, bool VEC, typename Key>
__global__ void __launch_bounds__(32 * HDM_PMAX, 2)
hdm_kernel(const TIn* __restrict__ in, const int* __restrict__ an_l,
           const int* __restrict__ ap_l, const int* __restrict__ an_r,
           const int* __restrict__ ap_r, int16_t* __restrict__ out,
           float* __restrict__ disp_l, float* __restrict__ disp_r, int H,
           int W, int D, int reach, int zd, int TX, int RL, int nseg,
           int DG) {
  typedef HdmStep<TIn, VEC> Step;
  constexpr int ES = (int)sizeof(TIn);
  constexpr int PS = Step::PS;
  extern __shared__ __align__(16) uint32_t hdm_smem[];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int seg = blockIdx.x % nseg;
  const int ry = blockIdx.x / nseg;
  const int y = ry % H, e = ry / H;
  const int x0 = seg * TX, s0 = x0 - RL;
  const int xend = min(x0 + TX, W);
  // the columns some window reaches
  const int nlo = max(x0 - reach, 0), nhi = min(xend + reach - 1, W);
  const int c0 = s0 + 16 * lane, c1 = s0 + HDM_TX + 4 * lane;
  auto hits = [&](int c, int n) { return c < nhi && c + n > nlo; };
  unsigned need = hits(c1, 4) ? 4u : 0u;
  if constexpr (ES == 1)
    need |= hits(c0, 16) ? 1u : 0u;
  else
    need |= (hits(c0, 8) ? 1u : 0u) | (hits(c0 + 8, 8) ? 2u : 0u);

  // the window of each of the lane's 16 outputs: byte offsets of the
  // slots of P[lo] (low half) and P[hi] (high half)
  const int* an = e ? an_r : an_l;
  const int* ap = e ? ap_r : ap_l;
  const size_t rowa = (size_t)y * W;
  const int xl = x0 + lane;
  uint32_t bnd[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int x = xl + 32 * j;
    bnd[j] = 0u;
    if (x < xend) {
      const int a = min(max(an[rowa + x], 0), reach);
      const int p = min(max(ap[rowa + x], 0), reach);
      const int lo = max(x - a, 0) - s0, hi = min(x + p, W) - s0;
      bnd[j] = (uint32_t)(4 * hdm_slot(lo)) |
               (uint32_t)(4 * hdm_slot(hi)) << 16;
    }
  }
  uint32_t* buf0 = hdm_smem + (size_t)warp * 2 * HDM_SLOTS;
  uint32_t* buf1 = buf0 + HDM_SLOTS;
  if (lane == 0) buf0[0] = buf1[0] = 0u;       // P[0] = 0

  const int dbeg = warp * DG, dend = min(D, dbeg + DG);
  const int nsteps = dbeg < dend ? (dend - dbeg + PS - 1) / PS : 0;
  const size_t plane = (size_t)H * W;
  const TIn* base = in + (size_t)e * D * plane + rowa;   // row y, plane 0
  auto load_step = [&](Step& st, int s) {
#pragma unroll
    for (int k = 0; k < PS; ++k) {
      const int d = dbeg + s * PS + k;
      hdm_load<TIn, VEC>(base + (size_t)d * plane, W, c0, c1,
                         d < dend ? need : 0u, st.g[k], st.t[k]);
    }
  };
  Key key[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if constexpr (sizeof(Key) == 8)
      key[j] = LLONG_MAX;
    else
      key[j] = INT_MAX;
  }

  // a ring of HDM_NS steps' loads: step s in ring[s % HDM_NS], loaded
  // again with step s + HDM_NS once step s is summed
  Step ring[HDM_NS];
#pragma unroll
  for (int k = 0; k < HDM_NS; ++k)
    if (k < nsteps) load_step(ring[k], k);
  for (int sb = 0; sb < nsteps; sb += HDM_NS) {
#pragma unroll
    for (int k = 0; k < HDM_NS; ++k) {
      const int s = sb + k;
      if (s < nsteps) {                         // uniform across the warp
        const Step& cur = ring[k];
        const int d = dbeg + s * PS;
        int mb[PS];
#pragma unroll
        for (int q = 0; q < PS; ++q)
          mb[q] = VEC ? 0 : hdm_misalign(base + (size_t)(d + q) * plane, c0);
        uint32_t c[16], h[4];
        hdm_words<VEC>(cur, mb, c, h);
        if (s + HDM_NS < nsteps) load_step(ring[k], s + HDM_NS);
        // the lane's inclusive prefixes, then the warp's scan of totals
#pragma unroll
        for (int i = 1; i < 16; ++i) c[i] += c[i - 1];
#pragma unroll
        for (int i = 1; i < 4; ++i) h[i] += h[i - 1];
        uint32_t i0 = c[15], i1 = h[3];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t n0 = __shfl_up_sync(0xFFFFFFFFu, i0, o);
          const uint32_t n1 = __shfl_up_sync(0xFFFFFFFFu, i1, o);
          if (lane >= o) {
            i0 += n0;
            i1 += n1;
          }
        }
        const uint32_t b0 = i0 - c[15];
        const uint32_t b1 = __shfl_sync(0xFFFFFFFFu, i0, 31) + i1 - h[3];
        uint32_t* buf = (s & 1) ? buf1 : buf0;
        uint32_t* bl = buf + 17 * lane;          // slot of P[16 l]
#pragma unroll
        for (int i = 0; i < 15; ++i) bl[1 + i] = b0 + c[i];
        bl[17] = b0 + c[15];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          buf[hdm_slot(HDM_TX + 1 + 4 * lane + i)] = b1 + h[i];
        __syncwarp();
        const char* bb = reinterpret_cast<const char*>(buf);
        uint32_t r[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          r[j] = *reinterpret_cast<const uint32_t*>(bb + (bnd[j] >> 16)) -
                 *reinterpret_cast<const uint32_t*>(bb + (bnd[j] & 0xFFFFu));
        if constexpr (WTA) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            key[j] = min(key[j], hdm_key<Key>((int)r[j], d));
        } else {
          // plane d from the low halves, d + 1 from the high ones, a
          // warp's stores 64 neighbouring bytes
          int16_t* o = out + ((size_t)(e * D + d) * H + y) * W + xl;
          const bool two = d + 1 < dend;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (xl + 32 * j < xend) {
              o[32 * j] = (int16_t)(r[j] & 0xFFFFu);
              if (two) o[plane + 32 * j] = (int16_t)(r[j] >> 16);
            }
        }
      }
    }
  }

  if constexpr (WTA) {
    // the P warps' first minima meet in shared memory (each warp's keys
    // in its own slots: slot(k) of its output x0 + k)
    __syncwarp();
    Key* kw = reinterpret_cast<Key*>(buf0);
#pragma unroll
    for (int j = 0; j < 16; ++j) kw[hdm_slot(lane + 32 * j)] = key[j];
    __syncthreads();
    const int P = blockDim.y;
    float* dsp = (e ? disp_r : disp_l) + rowa;
    for (int k = warp * 32 + lane; k < xend - x0; k += 32 * P) {
      const int sk = hdm_slot(k);
      Key b = reinterpret_cast<const Key*>(hdm_smem)[sk];
      for (int w = 1; w < P; ++w)
        b = min(b, reinterpret_cast<const Key*>(
                       hdm_smem + (size_t)w * 2 * HDM_SLOTS)[sk]);
      dsp[x0 + k] = (float)(hdm_arg(b) - zd);
    }
  }
}

template <typename TIn, bool WTA>
static int launch_hdm(const void* in, const void* an_l, const void* ap_l,
                      const void* an_r, const void* ap_r, void* out,
                      void* disp_l, void* disp_r, int H, int W, int D,
                      int reach, int zd, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || reach < 0 || reach > 64)
    return (int)cudaErrorInvalidValue;
  constexpr int ES = (int)sizeof(TIn);
  constexpr int PS = ES == 1 ? 2 : 1;
  const int nseg = (W + HDM_TX - 1) / HDM_TX;
  const int TX = ((W + nseg - 1) / nseg + 15) & ~15;    // balanced
  const int RL = (reach + 15) & ~15;
  const long long items = 2LL * H * nseg;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  // plane groups a block: more warps for short frames, up to HDM_PMAX
  int P = 1;
  while (P < HDM_PMAX && items * P < HDM_WARPS && P * PS < D) P *= 2;
  const int DG = ((D + P - 1) / P + PS - 1) / PS * PS;
  // vector loads: every row start 16-byte aligned
  const bool vec = (uintptr_t)in % 16 == 0 && W % (16 / ES) == 0;
  const size_t smem = (size_t)P * 2 * HDM_SLOTS * 4;
  const dim3 grid((unsigned)items), block(32, P);
  cudaStream_t st = (cudaStream_t)stream;
#define HDM_GO(V, K)                                                        \
  hdm_kernel<TIn, WTA, V, K><<<grid, block, smem, st>>>(                    \
      (const TIn*)in, (const int*)an_l, (const int*)ap_l, (const int*)an_r, \
      (const int*)ap_r, (int16_t*)out, (float*)disp_l, (float*)disp_r, H,   \
      W, D, reach, zd, TX, RL, nseg, DG)
  if constexpr (WTA) {
    if (D > 256) {
      if (vec) HDM_GO(true, long long);
      else HDM_GO(false, long long);
      return (int)cudaGetLastError();
    }
  }
  if (vec) HDM_GO(true, int);
  else HDM_GO(false, int);
#undef HDM_GO
  return (int)cudaGetLastError();
}

// Pass 1 (B18a): in (2D, H, W) u8; left/right arms of each eye (H, W) i32;
// out (2D, H, W) i16.  reach <= 64 keeps every sum below 2^15.
STM_API int stm_pass1_dm(const void* in, const void* left_l,
                         const void* right_l, const void* left_r,
                         const void* right_r, void* out, int H, int W, int D,
                         int reach, void* stream) {
  return launch_hdm<uint8_t, false>(in, left_l, right_l, left_r, right_r, out,
                                    nullptr, nullptr, H, W, D, reach, 0,
                                    stream);
}

// Pass 4 + WTA (B18c): in (2D, H, W) i16 (values >= 0); disp_l, disp_r
// (H, W) f32.
STM_API int stm_pass4_wta_dm(const void* in, const void* left_l,
                             const void* right_l, const void* left_r,
                             const void* right_r, void* disp_l, void* disp_r,
                             int H, int W, int D, int reach, int zd,
                             void* stream) {
  return launch_hdm<int16_t, true>(in, left_l, right_l, left_r, right_r,
                                   nullptr, disp_l, disp_r, H, W, D, reach,
                                   zd, stream);
}
