// B16: AD-census cost of both eyes, disparity-major, over a row range of
// the frame, with the grayscale and the 9x7 census computed in the kernel
// from the two images.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_cost_kernel` (reached via `ci_adcensus_kern_stacked`, eyes
// "lr_stacked", and via `ci_adcensus_kern`, eyes "lr"; with
// shift_extract=True, eyes "l" over the whole width and eyes "r" on the
// border column tiles) and the census the JAX entries compute before it.
//
// For the frame rows y in [row0, row0 + nrows), output row y - row0:
// out[d][y][x]     = C(L(y, x), R(y, clamp(x + (d - zd), 0, W-1)))   left eye
// out[D + d][y][x] = C(R(y, x), L(y, clamp(x - (d - zd), 0, W-1)))   right eye
// Three modes: both eyes stacked as above; the left eye alone, (D, nrows,
// W); the right eye alone over one or two column ranges, written in place
// into a (D, nrows, W) volume at those columns.
//   AD = |b - b'| + |g - g'| + |r - r'|            (0..765)
//   H  = popc(c0 ^ c0') + popc(c1 ^ c1')           (0..48)
//   C  = qtable[AD * 49 + H]                       u8 (quantized), or
//   C  = a[AD] + c[H]                              float32, rounded once
// The census codes are those of the whole frame (csrc/census.cuh, B2's own
// device code): the gray rows around the range are read from the frame,
// clamped at its edges only.  The tables hold the TPU kernel's float32
// expression evaluated on the host over the whole (AD, H) domain, so no
// expf runs here and the kernel is bit-equal to its plain version.
//
// Bound on the H100: bytes.  At 1080p/D=128 the (2D, H, W) u8 volume is
// 531 MB of output against 12 MB of images (~0.162 ms at 3.35 TB/s); the
// float32 volume is four times that.  Design: a block stages both eyes'
// gray, packed pixels and census words over its tile of columns (256 x 4
// rows, or 64 x 8 rows for the right-eye strips) and the disparities'
// reach either side, each staged word at k + k / 8 so that the lanes of
// a row at stride 8 hit distinct banks (a row pitch of 8 mod 32 words
// puts the 4 rows of a strip block's warp on the other banks).  A thread
// owns 8 consecutive columns of one eye, row and group of 32 planes: its
// own 8 pixels and census words stay in registers, and the other eye's 8
// columns slide one column a plane in a register ring (the plane loop
// unrolled by 8, so each slot is a static register), one new column read
// a plane.  Each plane's 8 values go out as one 8-byte store of u8 (32
// bytes of float32) where the row's columns are 8-byte aligned, one at a
// time elsewhere.  Sixteen columns a thread spilled at the two blocks an
// SM that the staging allows (128 registers) and ran slower at one;
// eight take 102-112 registers.  What remains per output is the
// arithmetic (a byte-wise absolute difference, two xors and popcounts)
// and the table lookup in shared memory at a data-dependent index: the
// integer pipe, not the bytes, bounds the kernel.

#include "census.cuh"

#define CD_THREADS 256
#define CD_COLS 8         // columns a thread
#define CD_PLANES 32      // planes a work item
#define CD_REACH 128
#define CD_SKEW 3         // staged word k at k + (k >> 3)

enum { CD_BOTH = 0, CD_LEFT = 1, CD_RIGHT = 2 };

// Rows of a block for a tile of XB columns.
template <int XB> struct CdTile;
template <> struct CdTile<256> { static constexpr int RB = 4; };
template <> struct CdTile<64> { static constexpr int RB = 8; };

struct CdArgs {
  const uint8_t* img_l;
  const uint8_t* img_r;
  const void* tab;      // the u8 table
  const float* ta;      // the float32 terms
  const float* tc;
  void* out;
  int H, W, D, zd, row0, nrows, eyes;
  int omin, omax;       // the hull of both eyes' offsets (other - own)
  int a0, a1, b0, b1;   // the column ranges; range a's tiles come first
  int tiles_a;
};

// The staged layout: `len` positions an eye (a multiple of 4) from column
// xb + omin, `pitch` words a row, `gwp` gray bytes a row, `words` in all.
struct CdSmem {
  int len, pitch, gwp, words;
};

template <typename T, int XB>
__host__ __device__ inline CdSmem cd_smem(int omin, int omax) {
  constexpr int RB = CdTile<XB>::RB;
  constexpr int NQ = XB / CD_COLS;          // lanes of one row in a warp
  CdSmem s;
  s.len = (XB + omax - omin + 1 + 3) & ~3;
  const int slots = s.len + (s.len >> CD_SKEW) + 1;
  s.pitch = (slots - NQ + 31) / 32 * 32 + NQ;   // = NQ (mod 32)
  s.gwp = (s.len + 11 + 3) & ~3;
  s.words = cost_tab_words<T>() + 2 * 3 * RB * s.pitch +
            2 * (RB + 6) * s.gwp / 4;
  return s;
}

// The 8 values of one plane as one aligned store: 8 bytes of u8, 32 of
// float32.
template <typename T>
__device__ __forceinline__ void cd_store(
    T* o, const typename CostV<T>::V (&v)[CD_COLS]) {
  if constexpr (sizeof(T) == 1) {
    uint2 q;
    q.x = (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
          ((uint32_t)v[3] << 24);
    q.y = (uint32_t)v[4] | ((uint32_t)v[5] << 8) | ((uint32_t)v[6] << 16) |
          ((uint32_t)v[7] << 24);
    *reinterpret_cast<uint2*>(o) = q;
  } else {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename T, int XB, bool VEC>
__global__ void __launch_bounds__(CD_THREADS, XB == 256 ? 2 : 1)
cost_dm_kernel(CdArgs a) {
  constexpr int RB = CdTile<XB>::RB;
  constexpr int NQ = XB / CD_COLS;
  extern __shared__ __align__(16) uint32_t cd_sm[];
  const int W = a.W, D = a.D;
  const CdSmem L = cd_smem<T, XB>(a.omin, a.omax);
  const void* tab = cd_sm;
  cost_stage_table<T, CD_THREADS>(cd_sm, a.tab, a.ta, a.tc);

  const int tile = blockIdx.x;
  const bool in_a = tile < a.tiles_a;
  const int xb = in_a ? a.a0 + tile * XB : a.b0 + (tile - a.tiles_a) * XB;
  const int xe = in_a ? a.a1 : a.b1;
  const int ylo = a.row0 + blockIdx.y * RB;
  CostEye eye[2];                            // L, R
  uint32_t* w = cd_sm + cost_tab_words<T>();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    eye[e].img = e ? a.img_r : a.img_l;
    eye[e].base = xb + a.omin;
    eye[e].len = L.len;
    eye[e].pitch = L.pitch;
    eye[e].skew = CD_SKEW;
    eye[e].pix = w;
    eye[e].c0 = w + RB * L.pitch;
    eye[e].c1 = w + 2 * RB * L.pitch;
    w += 3 * RB * L.pitch;
    cost_eye_layout(eye[e], W);
  }
  eye[0].gray = reinterpret_cast<uint8_t*>(w);
  eye[1].gray = eye[0].gray + (RB + 6) * L.gwp;
  cost_stage_gray<RB, CD_THREADS>(eye[0], ylo, a.H, W);
  cost_stage_gray<RB, CD_THREADS>(eye[1], ylo, a.H, W);
  __syncthreads();
  cost_stage_census<RB, CD_THREADS>(eye[0], ylo, a.H, W);
  cost_stage_census<RB, CD_THREADS>(eye[1], ylo, a.H, W);
  __syncthreads();

  // work items (column group q, row r, eye e, plane group g), q fastest:
  // a warp's lanes share e and g
  const int E = a.eyes == CD_BOTH ? 2 : 1;
  const int G = (D + CD_PLANES - 1) / CD_PLANES;
  const int rows = min(RB, a.row0 + a.nrows - ylo);
  T* out = static_cast<T*>(a.out);
  const size_t plane_sz = (size_t)a.nrows * W;
  const int cw = RB * L.pitch;
  for (int it = threadIdx.x; it < NQ * RB * E * G; it += CD_THREADS) {
    const int q = it % NQ;
    int rest = it / NQ;
    const int r = rest % RB;
    rest /= RB;
    const int e =
        a.eyes == CD_RIGHT ? 1 : (a.eyes == CD_LEFT ? 0 : rest % E);
    const int g = rest / E;
    const int x0 = xb + q * CD_COLS;
    if (r >= rows || x0 >= xe) continue;
    // the eyes' staged words (pix, c0, c1 at 0, cw, 2 cw) in the order of
    // `eye`
    const uint32_t* own = cd_sm + cost_tab_words<T>() + e * 3 * cw;
    const uint32_t* oth = cd_sm + cost_tab_words<T>() + (1 - e) * 3 * cw;
    // the offsets o (other column - own column) of this group, ascending:
    // the left eye's o = d - zd, the right eye's o = zd - d
    const int olo = e ? a.zd - D + 1 : -a.zd;
    const int o0 = olo + g * CD_PLANES;
    const int o1 = min(o0 + CD_PLANES, olo + D);
    const int ko = q * CD_COLS - a.omin;     // own column x0 at position ko
    const int row = r * L.pitch;
    uint32_t op[CD_COLS], oc0[CD_COLS], oc1[CD_COLS];
    uint32_t tp[CD_COLS], tc0[CD_COLS], tc1[CD_COLS];
#pragma unroll
    for (int i = 0; i < CD_COLS; ++i) {
      const int s = row + cost_slot(ko + i, CD_SKEW);
      op[i] = own[s];
      oc0[i] = own[cw + s];
      oc1[i] = own[2 * cw + s];
      // slot i of the ring: the other column x0 + o0 + i
      const int t = row + cost_slot(ko + o0 + i, CD_SKEW);
      tp[i] = oth[t];
      tc0[i] = oth[cw + t];
      tc1[i] = oth[2 * cw + t];
    }
    T* orow = out + (size_t)(ylo + r - a.row0) * W + x0;
    const bool vec = VEC && x0 + CD_COLS <= xe;
    for (int ob = o0; ob < o1; ob += CD_COLS) {
#pragma unroll
      for (int j = 0; j < CD_COLS; ++j) {
        const int o = ob + j;
        if (o >= o1) break;
        // slot (j + i) % COLS holds the other column x0 + o + i
        typename CostV<T>::V v[CD_COLS];
#pragma unroll
        for (int i = 0; i < CD_COLS; ++i) {
          const int s = (j + i) & (CD_COLS - 1);
          const int ad = (int)__vsadu4(op[i], tp[s]);
          const int ham = __popc(oc0[i] ^ tc0[s]) + __popc(oc1[i] ^ tc1[s]);
          v[i] = cost_of<T>(tab, ad, ham);
        }
        const int d = e ? a.zd - o : o + a.zd;
        const int plane = a.eyes == CD_BOTH && e ? D + d : d;
        T* dst = orow + (size_t)plane * plane_sz;
        if (vec) {
          cd_store<T>(dst, v);
        } else {
#pragma unroll
          for (int i = 0; i < CD_COLS; ++i)
            if (x0 + i < xe) dst[i] = (T)v[i];
        }
        // slot j takes the other column x0 + o + COLS
        const int t = row + cost_slot(ko + o + CD_COLS, CD_SKEW);
        tp[j] = oth[t];
        tc0[j] = oth[cw + t];
        tc1[j] = oth[2 * cw + t];
      }
    }
  }
}

template <typename T, int XB, bool VEC>
static int launch_cd(const CdArgs& a, void* stream) {
  constexpr int RB = CdTile<XB>::RB;
  const size_t smem =
      (size_t)cd_smem<T, XB>(a.omin, a.omax).words * sizeof(uint32_t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = cost_dm_kernel<T, XB, VEC>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = a.tiles_a + (a.b1 - a.b0 + XB - 1) / XB;
  dim3 grid(tiles, (a.nrows + RB - 1) / RB);
  kernel<<<grid, CD_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int XB>
static int launch_cd_tile(CdArgs& a, bool vec, void* stream) {
  constexpr int RB = CdTile<XB>::RB;
  if ((a.nrows + RB - 1) / RB > 65535) return (int)cudaErrorInvalidValue;
  a.tiles_a = (a.a1 - a.a0 + XB - 1) / XB;
  return vec ? launch_cd<T, XB, true>(a, stream)
             : launch_cd<T, XB, false>(a, stream);
}

// img_l, img_r: (H, W, 3) u8 contiguous images of the whole frame;
// qtable: the (766 * 49) u8 table `cost_table` when quant != 0, else
// ad_term (766 f32) and ham_term (49 f32); the frame rows [row0, row0 +
// nrows).  eyes 0: both, out (2D, nrows, W); eyes 1: the left eye, out
// (D, nrows, W); eyes 2: the right eye over the columns [a0, a1) and [b0,
// b1) (b0 = b1: none; a1 <= b0), written in place into out (D, nrows,
// W).  out of u8 (quant) or f32.  zd <= 128 and D - zd <= 128.
STM_API int stm_cost_dm(const void* img_l, const void* img_r,
                        const void* qtable, const void* ad_term,
                        const void* ham_term, void* out, int H, int W, int D,
                        int zd, int quant, int eyes, int row0, int nrows,
                        int a0, int a1, int b0, int b1, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > CD_REACH ||
      D - zd > CD_REACH || D - zd < 0 || eyes < CD_BOTH || eyes > CD_RIGHT ||
      row0 < 0 || nrows <= 0 || row0 + nrows > H || a0 < 0 || a1 <= a0 ||
      b1 < b0 || (b1 > b0 && b0 < a1) || (b1 > b0 ? b1 : a1) > W ||
      (eyes != CD_RIGHT && (a0 || a1 != W || b1 > b0)) ||
      (quant ? qtable == nullptr : ad_term == nullptr || ham_term == nullptr))
    return (int)cudaErrorInvalidValue;
  CdArgs a;
  a.img_l = (const uint8_t*)img_l;
  a.img_r = (const uint8_t*)img_r;
  a.tab = qtable;
  a.ta = (const float*)ad_term;
  a.tc = (const float*)ham_term;
  a.out = out;
  a.H = H;
  a.W = W;
  a.D = D;
  a.zd = zd;
  a.row0 = row0;
  a.nrows = nrows;
  a.eyes = eyes;
  a.omin = min(-zd, zd - D + 1);
  a.omax = max(D - 1 - zd, zd);
  a.a0 = a0;
  a.a1 = a1;
  a.b0 = b1 > b0 ? b0 : 0;
  a.b1 = b1 > b0 ? b1 : 0;
  // vector stores where every column group starts aligned: 8 bytes of
  // u8, 32 of float32
  const bool vec = W % CD_COLS == 0 && a0 % CD_COLS == 0 &&
                   a.b0 % CD_COLS == 0 && ((uintptr_t)out & 15) == 0;
  if (eyes == CD_RIGHT)
    return quant ? launch_cd_tile<uint8_t, 64>(a, vec, stream)
                 : launch_cd_tile<float, 64>(a, vec, stream);
  return quant ? launch_cd_tile<uint8_t, 256>(a, vec, stream)
               : launch_cd_tile<float, 256>(a, vec, stream);
}
