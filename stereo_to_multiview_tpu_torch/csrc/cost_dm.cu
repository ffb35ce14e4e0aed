// B16: AD-census cost of both eyes, disparity-major.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_cost_kernel` (reached via `ci_adcensus_kern_stacked`, eyes
// "lr_stacked", and via `ci_adcensus_kern`, eyes "lr"; with
// shift_extract=True, eyes "l" over the whole width and eyes "r" on the
// border column tiles).
//
// out[d][y][x]     = C(L(y, x), R(y, clamp(x + (d - zd), 0, W-1)))   left eye
// out[D + d][y][x] = C(R(y, x), L(y, clamp(x - (d - zd), 0, W-1)))   right eye
// Three modes: both eyes stacked as above; the left eye alone, (D, H, W);
// the right eye alone over the columns [x0, x1), (D, H, x1 - x0).
//   AD = |b - b'| + |g - g'| + |r - r'|            (0..765)
//   H  = popc(c0 ^ c0') + popc(c1 ^ c1')           (0..48)
//   C  = qtable[AD * 49 + H]                       u8 (quantized), or
//   C  = ad_term[AD] + ham_term[H]                 float32, rounded once
// The tables hold the TPU kernel's float32 expression evaluated on the
// host over the whole (AD, H) domain, so no expf runs here and the kernel
// is bit-equal to its plain version.  The TPU kernel bakes the clamp into
// 128 edge-padded columns and builds every window with a lane roll and a
// select; here the clamp is applied once when a row is staged.
//
// Bound on the H100: bytes.  At 1080p/D=128 the (2D, H, W) u8 volume is
// 531 MB of output against 46 MB of input (~0.17 ms at 3.35 TB/s); the
// float32 volume is four times that.  Design: a block takes 256 columns
// of 4 consecutive rows.  Per row it stages both eyes' packed BGR and
// census words over the tile plus 128 columns either side in shared
// memory, then each thread owns one x and loops over d: one __vsadu4, two
// __popc and a shared-memory lookup per (eye, d), and consecutive threads
// write consecutive elements of a plane.  The 37.5 KB u8 table is loaded
// once per block and serves its 4 rows.

#include "stm_common.cuh"

#define CD_TILE 256
#define CD_REACH 128
#define CD_SPAN (CD_TILE + 2 * CD_REACH)
#define CD_ROWS 4
#define CD_AD 766
#define CD_HAM 49

enum { CD_BOTH = 0, CD_LEFT = 1, CD_RIGHT = 2 };

// Output column x - x0 of the columns [x0, x1); each plane is H x (x1 - x0).
template <bool QUANT, int EYES>
__global__ void __launch_bounds__(CD_TILE)
cost_dm_kernel(const uint32_t* __restrict__ lpk,
               const uint32_t* __restrict__ rpk,
               const int2* __restrict__ lcen, const int2* __restrict__ rcen,
               const uint8_t* __restrict__ qtable,
               const float* __restrict__ ad_term,
               const float* __restrict__ ham_term, void* __restrict__ out,
               int H, int W, int D, int zd, int x0, int x1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* cen = reinterpret_cast<int2*>(smem_raw);          // [2][CD_SPAN]
  uint32_t* pix = reinterpret_cast<uint32_t*>(cen + 2 * CD_SPAN);
  uint8_t* qtab = reinterpret_cast<uint8_t*>(pix + 2 * CD_SPAN);
  float* fad = reinterpret_cast<float*>(pix + 2 * CD_SPAN);
  float* fham = fad + CD_AD;
  if (QUANT) {
    for (int i = threadIdx.x; i < CD_AD * CD_HAM; i += CD_TILE)
      qtab[i] = qtable[i];
  } else {
    for (int i = threadIdx.x; i < CD_AD; i += CD_TILE) fad[i] = ad_term[i];
    for (int i = threadIdx.x; i < CD_HAM; i += CD_TILE) fham[i] = ham_term[i];
  }

  const int xb = x0 + blockIdx.x * CD_TILE;
  const int x = xb + threadIdx.x;
  const int c = threadIdx.x + CD_REACH;        // own column in the stage
  const int wo = x1 - x0;
  const size_t plane = (size_t)H * wo;
  uint8_t* out_q = reinterpret_cast<uint8_t*>(out);
  float* out_f = reinterpret_cast<float*>(out);

  for (int r = 0; r < CD_ROWS; ++r) {
    const int y = blockIdx.y * CD_ROWS + r;
    if (y >= H) break;                          // the whole block leaves
    __syncthreads();            // tables loaded; the last row's reads done
    const size_t row = (size_t)y * W;
    for (int i = threadIdx.x; i < CD_SPAN; i += CD_TILE) {
      const size_t q = row + min(max(xb - CD_REACH + i, 0), W - 1);
      pix[i] = lpk[q];
      pix[CD_SPAN + i] = rpk[q];
      cen[i] = lcen[q];
      cen[CD_SPAN + i] = rcen[q];
    }
    __syncthreads();
    if (x >= x1) continue;
    const uint32_t lp = pix[c], rp = pix[CD_SPAN + c];
    const int2 lc = cen[c], rc = cen[CD_SPAN + c];
    size_t o = (size_t)y * wo + (x - x0);       // plane d of the first eye
    // the right eye's planes follow the left eye's only when both are out
    const size_t right = EYES == CD_BOTH ? (size_t)D * plane : 0;
    for (int d = 0; d < D; ++d, o += plane) {
      const int k = d - zd;
      if (EYES != CD_RIGHT) {
        const int2 oc_r = cen[CD_SPAN + c + k];   // R at x + k
        const int ad_l = (int)__vsadu4(lp, pix[CD_SPAN + c + k]);
        const int ham_l = __popc(lc.x ^ oc_r.x) + __popc(lc.y ^ oc_r.y);
        if (QUANT) out_q[o] = qtab[ad_l * CD_HAM + ham_l];
        else out_f[o] = __fadd_rn(fad[ad_l], fham[ham_l]);
      }
      if (EYES != CD_LEFT) {
        const int2 oc_l = cen[c - k];             // L at x - k
        const int ad_r = (int)__vsadu4(rp, pix[c - k]);
        const int ham_r = __popc(rc.x ^ oc_l.x) + __popc(rc.y ^ oc_l.y);
        if (QUANT) out_q[o + right] = qtab[ad_r * CD_HAM + ham_r];
        else out_f[o + right] = __fadd_rn(fad[ad_r], fham[ham_r]);
      }
    }
  }
}

template <bool QUANT, int EYES>
static int launch_cost_dm(const void* lpk, const void* rpk, const void* lcen,
                          const void* rcen, const void* qtable,
                          const void* ad_term, const void* ham_term,
                          void* out, int H, int W, int D, int zd, int x0,
                          int x1, void* stream) {
  const size_t tab = QUANT ? (size_t)CD_AD * CD_HAM
                           : (size_t)(CD_AD + CD_HAM) * sizeof(float);
  const size_t smem = (size_t)2 * CD_SPAN * (sizeof(int2) + sizeof(uint32_t))
                      + tab;
  cudaError_t err = stm_smem_cap(cost_dm_kernel<QUANT, EYES>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((x1 - x0 + CD_TILE - 1) / CD_TILE, (H + CD_ROWS - 1) / CD_ROWS);
  cost_dm_kernel<QUANT, EYES><<<grid, CD_TILE, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)lpk, (const uint32_t*)rpk, (const int2*)lcen,
      (const int2*)rcen, (const uint8_t*)qtable, (const float*)ad_term,
      (const float*)ham_term, out, H, W, D, zd, x0, x1);
  return (int)cudaGetLastError();
}

template <int EYES>
static int launch_eyes(const void* lpk, const void* rpk, const void* lcen,
                       const void* rcen, const void* qtable,
                       const void* ad_term, const void* ham_term, void* out,
                       int H, int W, int D, int zd, int quant, int x0, int x1,
                       void* stream) {
  return quant ? launch_cost_dm<true, EYES>(lpk, rpk, lcen, rcen, qtable,
                                            ad_term, ham_term, out, H, W, D,
                                            zd, x0, x1, stream)
               : launch_cost_dm<false, EYES>(lpk, rpk, lcen, rcen, qtable,
                                             ad_term, ham_term, out, H, W, D,
                                             zd, x0, x1, stream);
}

// lpk/rpk: (H, W) u32 packed b | g << 8 | r << 16; lcen/rcen: (H, W, 2)
// i32 census words; out: u8 from qtable (766 * 49 u8) when quant != 0,
// else f32 from ad_term (766 f32) and ham_term (49 f32).  eyes 0: both,
// out (2D, H, W); eyes 1: the left eye, out (D, H, W); eyes 2: the right
// eye over the columns [x0, x1), out (D, H, x1 - x0).  zd <= 128 and
// D - zd <= 128.
STM_API int stm_cost_dm(const void* lpk, const void* rpk, const void* lcen,
                        const void* rcen, const void* qtable,
                        const void* ad_term, const void* ham_term, void* out,
                        int H, int W, int D, int zd, int quant, int eyes,
                        int x0, int x1, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > CD_REACH ||
      D - zd > CD_REACH || D - zd < 0 || eyes < CD_BOTH || eyes > CD_RIGHT ||
      x0 < 0 || x1 <= x0 || x1 > W || (eyes != CD_RIGHT && (x0 || x1 != W)) ||
      (quant ? qtable == nullptr : ad_term == nullptr || ham_term == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((H + CD_ROWS - 1) / CD_ROWS > 65535) return (int)cudaErrorInvalidValue;
#define CD_ARGS lpk, rpk, lcen, rcen, qtable, ad_term, ham_term, out, H, W, \
    D, zd, quant, x0, x1, stream
  if (eyes == CD_BOTH) return launch_eyes<CD_BOTH>(CD_ARGS);
  if (eyes == CD_LEFT) return launch_eyes<CD_LEFT>(CD_ARGS);
  return launch_eyes<CD_RIGHT>(CD_ARGS);
#undef CD_ARGS
}
