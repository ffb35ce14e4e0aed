// B7 and B11: left-right cross-check labels, occlusion hits and the
// synthesis' bleed masks, with the occlusion stage of both eyes as one
// kernel.
//
// Replaces the TPU kernels stereo_to_multiview_tpu/ops/postkern.py
// `_dcc_kernel_xm` (reached via `dcc_occl_kern`) and `_bleed_kernel`
// (reached via `filter_bleed_mask_kern`):
//   hits   (dibr_occl): hit_r[j] = any x with clamp(x + trunc(dl(x))) == j,
//                       hit_l[j] = any x with clamp(x - trunc(dr(x))) == j;
//   labels (dr_dcc):    mm_l(x) = |dl(x) - dr(clamp(x + trunc(dl(x))))|
//                       > thresh (mm_r likewise with x - trunc(dr(x)));
//                       label = mm ? (hit ? 1 : 2) : 0;
//   bleed  (dibr_bleed_mask): cnt = the non-zero values of the (2r+1)^2
//                       neighbourhood under the reference's edge rule (a
//                       negative coordinate mirrors, s -> -s; past the
//                       end it maps to n - 1 - offset); mask = (cnt >
//                       thresh ? 1 : occl) == 1, as float32;
//   masks  (dibr_occl_masks): the bleed masks of both eyes' hits, without
//                       the hits ever reaching device memory.
// Disparities truncate toward zero (cvt.rzi saturates, and the offset is
// clamped to the row before it is added), and every target column clamps
// into the row: a writer past the border lands on the edge column.
//
// Bound on the H100: memory.  At 1080p the labels read two float32 planes
// and write two u8 planes (20.7 MB, 0.0062 ms); the fused stage reads two
// float32 planes and writes two float32 masks (33.2 MB, 0.0099 ms).
// Design: warps read rows 16 bytes a lane, OCCL_LOADS row chunks in
// flight, and scatter each column's hit as a byte of 1 into shared memory
// (a store of 1 is idempotent: no atomics, no loop over colliding
// writers).  B7 takes a row and segment of up to OCCL_SEG output columns
// a block (any width: a segment keeps the hits that land in it), stages
// both rows for the labels' gather where they fit (else the gather reads
// device memory), and stores from byte rows laid out on the output's
// 16-byte boundaries: hits 16 bytes a thread, labels 4 (a warp still
// stores 128 contiguous bytes; 16 a thread left half the block idle at
// 1080p, each thread with 32 dependent gathers).  The fused stage
// takes a band of rows a block and eye: it scatters the band and its r
// halo rows each side (the halo recomputed from disparity rows that
// neighbouring blocks read too, so from L2) into byte rows, packs them
// into bit rows (four bytes of 0/1 to four bits by one multiply), counts
// each pixel's neighbourhood by popc on 32-bit fields of the bit rows
// (OCCL_CW columns from one field where their windows lie inside the row
// and span at most 32 columns, at r = 1 after a bit-sliced sum of the
// three rows; else span by span under the edge rule), and stores the
// float32 masks 16 bytes at a time.  The band is chosen for about three
// blocks a streaming multiprocessor in one wave (6 rows at 1080p, 11 at
// 2160 rows).  The window [y0 - r, y1 + r) holds every row the edge rule
// maps a band row to: mirrored rows are at most r, past-the-end rows
// n - 1 - dy at least n - 1 - r.
// r_max: the fused stage needs its window's 2r + 1 bit rows and one byte
// row in shared memory (the band shrinks to one row, the byte rows are
// scattered a group at a time).  Above r_max(W) (`stm_occl_masks_rmax`:
// 471 at 1920 columns, 235 at 3840, 32 at 25,000) it runs B7's hits into
// two u8 planes, then the same count-and-store on those planes (the hit
// source a u8 plane in device memory): two launches.  B11's u8 entry is
// that second kernel on one plane.

#include "stm_common.cuh"

#define OCCL_THREADS 256
#define OCCL_WARPS (OCCL_THREADS / 32)
#define OCCL_U8_ROWS 2            // output rows a block of B11's u8 entry
#define OCCL_LOADS 4              // row chunks a warp loads at once
#define OCCL_CW 4                 // mask columns a thread counts at once
#define OCCL_SEG 65536            // B7: output columns a block at most
#define OCCL_SMEM_MAX 232448      // a block's shared memory on sm_90

// Words of a bit row: one bit a column, and a zero word past the end, so
// that a 32-bit field may start at any column of the row.
__host__ __device__ __forceinline__ int bit_stride(int W) {
  return (W + 31) / 32 + 1;
}

// Bytes of a scatter row: a multiple of 32, so that each word's 32 bytes
// are two aligned 16-byte loads.
__host__ __device__ __forceinline__ int byte_pitch(int W) {
  return (W + 31) / 32 * 32;
}

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// clamp(x + sign * trunc(d), 0, W - 1) without overflow.
__device__ __forceinline__ int hit_target(float d, int x, int sign, int W) {
  const int q = min(max(__float2int_rz(d), -W), W);
  return min(max(x + sign * q, 0), W - 1);
}

// Columns c0 + 4 lane .. + 3 of row d (c0 a multiple of 128): one 16-byte
// load where the row's floats are 16-byte aligned (`vec`), else four;
// columns past W read as 0.
__device__ __forceinline__ void load4(const float* __restrict__ d, int c0,
                                      int W, bool vec, float (&v)[4]) {
  const int x = c0 + 4 * (threadIdx.x & 31);
  if (vec && x + 3 < W) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(d + x));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = x + j < W ? __ldg(d + x + j) : 0.0f;
  }
}

// Scatters those columns' hits as bytes of 1 into `hit`, which holds the
// target columns [lo, hi): a store of 1 is idempotent, so colliding
// writers need no atomics.
__device__ __forceinline__ void scatter4(const float (&v)[4], int c0, int W,
                                         int sign, uint8_t* hit, int lo,
                                         int hi) {
  const int x = c0 + 4 * (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (x + j < W) {
      const int t = hit_target(v[j], x + j, sign, W);
      if (t >= lo && t < hi) hit[t - lo] = 1;
    }
  }
}

// Four bytes of 0 or 1 -> four bits: byte i lands on bit 24 + i of the
// product and no two partial products meet.
__device__ __forceinline__ uint32_t pack4(uint32_t u) {
  return (u * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 q) {
  return pack4(q.x) | pack4(q.y) << 4 | pack4(q.z) << 8 | pack4(q.w) << 12;
}

__device__ __forceinline__ bool bit_at(const uint32_t* bits, int x) {
  return (bits[x >> 5] >> (x & 31)) & 1u;
}

// 32 consecutive bits from column a of a bit row (a zero word follows
// the row's last column).
__device__ __forceinline__ uint32_t field32(const uint32_t* bits, int a) {
  return __funnelshift_r(bits[a >> 5], bits[(a >> 5) + 1], a & 31);
}

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += OCCL_THREADS)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------
// B7: labels or hits, a block a row and segment of up to OCCL_SEG
// output columns.
// ---------------------------------------------------------------------

// A cross-check label of one eye at column x: `own` the eye's row, `other`
// the other eye's, `hit` the eye's hit byte.
__device__ __forceinline__ uint32_t label_at(const float* own,
                                             const float* other,
                                             uint32_t hit, int x, int sign,
                                             int W, float thresh) {
  const float a = own[x];
  const float b = other[hit_target(a, x, sign, W)];
  if (!(fabsf(a - b) > thresh)) return 0u;
  return hit ? 1u : 2u;
}

// Four labels of one eye from column x, as the bytes of a word.
__device__ __forceinline__ uint32_t labels4(const float* own,
                                            const float* other,
                                            uint32_t hits, int x, int sign,
                                            int W, float thresh) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= label_at(own, other, (hits >> (8 * i)) & 0xffu, x + i, sign, W,
                  thresh) << (8 * i);
  return w;
}

// MODE 0: hits; 1: labels, both rows staged in shared memory for the
// gather; 2: labels, the gather from device memory.  Shared memory: two
// hit rows of `seg` bytes, each starting `pad` bytes into a slot of
// round16(seg + 16) bytes (so that a column on a 16-byte boundary of the
// output sits on one in shared memory), then in mode 1 both rows' floats.
template <int MODE>
__global__ void __launch_bounds__(OCCL_THREADS)
dcc_kernel(const float* __restrict__ dl, const float* __restrict__ dr,
           uint8_t* __restrict__ out_l, uint8_t* __restrict__ out_r, int W,
           float thresh, int seg, int vec) {
  extern __shared__ uint4 sm4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(sm4);
  const size_t slot = round16((size_t)seg + 16);
  const size_t row = (size_t)blockIdx.x * W;
  const int c0 = blockIdx.y * seg, c1 = min(W, c0 + seg);
  const int pad = (int)((row + c0) & 15);
  uint8_t* hit_l = sm + pad;
  uint8_t* hit_r = sm + slot + pad;
  float* st_l = reinterpret_cast<float*>(sm + 2 * slot);
  float* st_r = st_l + round16((size_t)W * 4) / 4;
  const float* rl = dl + row;
  const float* rr = dr + row;
  zero_smem(sm, 2 * slot);
  __syncthreads();
  for (int cc = (threadIdx.x >> 5) * 128; cc < W; cc += OCCL_WARPS * 128) {
    float a[4], b[4];
    load4(rl, cc, W, vec, a);
    load4(rr, cc, W, vec, b);
    if (MODE == 1) {
      const int x = cc + 4 * (threadIdx.x & 31);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < W) {
          st_l[x + j] = a[j];
          st_r[x + j] = b[j];
        }
    }
    scatter4(a, cc, W, +1, hit_r, c0, c1);
    scatter4(b, cc, W, -1, hit_l, c0, c1);
  }
  __syncthreads();

  const float* gl = MODE == 1 ? st_l : rl;
  const float* gr = MODE == 1 ? st_r : rr;
  uint8_t* ol = out_l + row;
  uint8_t* orr = out_r + row;
  auto one = [&](int x) {
    const uint8_t hl = hit_l[x - c0], hr = hit_r[x - c0];
    if (MODE == 0) {
      ol[x] = hl;
      orr[x] = hr;
    } else {
      ol[x] = (uint8_t)label_at(gl, gr, hl, x, +1, W, thresh);
      orr[x] = (uint8_t)label_at(gr, gl, hr, x, -1, W, thresh);
    }
  };
  // the segment's bytes in chunks of LC from its first LC-byte boundary
  // (the planes' bases are 16-byte aligned), the head and tail a byte
  constexpr int LC = MODE == 0 ? 16 : 4;
  const int n = c1 - c0;
  const int head = min(n, (LC - (pad & (LC - 1))) & (LC - 1));
  const int nvec = (n - head) / LC;
  for (int v = threadIdx.x; v < nvec; v += OCCL_THREADS) {
    const int x0 = c0 + head + LC * v;
    if (MODE == 0) {
      *reinterpret_cast<uint4*>(ol + x0) =
          *reinterpret_cast<const uint4*>(hit_l + (x0 - c0));
      *reinterpret_cast<uint4*>(orr + x0) =
          *reinterpret_cast<const uint4*>(hit_r + (x0 - c0));
    } else {
      const uint32_t hl =
          *reinterpret_cast<const uint32_t*>(hit_l + (x0 - c0));
      const uint32_t hr =
          *reinterpret_cast<const uint32_t*>(hit_r + (x0 - c0));
      *reinterpret_cast<uint32_t*>(ol + x0) =
          labels4(gl, gr, hl, x0, +1, W, thresh);
      *reinterpret_cast<uint32_t*>(orr + x0) =
          labels4(gr, gl, hr, x0, -1, W, thresh);
    }
  }
  for (int x = c0 + threadIdx.x; x < c0 + head; x += OCCL_THREADS) one(x);
  for (int x = c0 + head + LC * nvec + threadIdx.x; x < c1;
       x += OCCL_THREADS)
    one(x);
}

// ---------------------------------------------------------------------
// B11: the bleed count and mask store, on hits from either source.
// ---------------------------------------------------------------------

// Hits as bit rows lo.. in shared memory (scattered from disparities).
struct BitRows {
  const uint32_t* bits;
  int lo, stride;
  // the bits of columns [a, a + n) of row k, n <= 32, a + n <= W
  __device__ __forceinline__ uint32_t field(int k, int a, int n) const {
    return field32(bits + (k - lo) * stride, a) & low_bits(n);
  }
  __device__ __forceinline__ bool one(int y, int x) const {
    return bit_at(bits + (y - lo) * stride, x);
  }
  // the value 1 at x0 .. x0 + OCCL_CW - 1 of row y, from its field at x0
  __device__ __forceinline__ uint32_t ones(int, int, uint32_t f) const {
    return f;
  }
};

// Hits as a u8 plane in device memory: a non-zero value counts; only
// the value 1 passes as itself.
struct ByteRows {
  const uint8_t* p;
  int W;
  __device__ __forceinline__ uint32_t field(int k, int a, int n) const {
    const uint8_t* q = p + (size_t)k * W + a;
    uint32_t f = 0u;
    for (int j = 0; j < n; ++j) f |= (uint32_t)(q[j] != 0) << j;
    return f;
  }
  __device__ __forceinline__ bool one(int y, int x) const {
    return p[(size_t)y * W + x] == 1;
  }
  __device__ __forceinline__ uint32_t ones(int y, int x0, uint32_t) const {
    const uint8_t* q = p + (size_t)y * W + x0;
    uint32_t f = 0u;
#pragma unroll
    for (int i = 0; i < OCCL_CW; ++i) f |= (uint32_t)(q[i] == 1) << i;
    return f;
  }
};

// bleed_index: i + off, a negative coordinate mirrored, one past the
// end mapped to n - 1 - off.
__device__ __forceinline__ int bleed_index(int i, int off, int n) {
  int s = i + off;
  if (s < 0) s = -s;
  return s > n - 1 ? n - 1 - off : s;
}

// Hits in columns [a, b) of row k.
template <class Src>
__device__ __forceinline__ int span_count(const Src& src, int k, int a,
                                          int b) {
  int c = 0;
  for (; a < b; a += 32) c += __popc(src.field(k, a, min(32, b - a)));
  return c;
}

// Row k's hits at the columns bleed_index(x, dx, W), dx in [-r, r]: the
// columns inside the row, then the mirrored ones (1 .. r - x) and the
// ones past the end (W - 1 - dx for dx in [W - x, r]: W - 1 - r .. x - 1).
template <class Src>
__device__ __forceinline__ int row_count(const Src& src, int k, int x,
                                         int r, int W) {
  int c = span_count(src, k, max(0, x - r), min(W, x + r + 1));
  if (x < r) c += span_count(src, k, 1, r - x + 1);
  if (x + r > W - 1) c += span_count(src, k, W - 1 - r, x);
  return c;
}

// At r = 1: the OCCL_CW + 2 bits of columns x0 - 1 .. x0 + OCCL_CW of
// row k (x0 .. x0 + OCCL_CW - 1 inside the row, W >= 2), column -1 read
// as column 1 and column W as column W - 2: the edge rule at r = 1 (the
// past-the-end rule n - 1 - off is the mirror where off = 1).
template <class Src>
__device__ __forceinline__ uint32_t field_r1(const Src& src, int k, int x0,
                                             int W) {
  if (x0 >= 1 && x0 + OCCL_CW <= W - 1)
    return src.field(k, x0 - 1, OCCL_CW + 2);
  uint32_t f = 0u;
#pragma unroll
  for (int j = 0; j < OCCL_CW + 2; ++j) {
    const int c = x0 - 1 + j;
    f |= src.field(k, c < 0 ? -c : c > W - 1 ? 2 * (W - 1) - c : c, 1) << j;
  }
  return f;
}

template <class Src>
__device__ __forceinline__ float mask_at(const Src& src, int y, int x,
                                         int H, int W, int r,
                                         float thresh) {
  int cnt = 0;
  for (int dy = -r; dy <= r; ++dy)
    cnt += row_count(src, bleed_index(y, dy, H), x, r, W);
  return ((float)cnt > thresh || src.one(y, x)) ? 1.0f : 0.0f;
}

// Rows [y0, y1) of `mask` (W columns; its base 16-byte aligned): flat
// chunks of OCCL_CW floats from the band's first 32-byte boundary, the
// head and tail a float.  A chunk inside one row whose windows lie inside
// the row and span at most 32 columns counts from one field a row of the
// window: column x0 + i's window is bits i .. i + 2r.  RC >= 0 fixes r at
// compile time; at r = 1 every chunk inside one row takes this path (the
// edge columns from `field_r1`), and the three rows are added bit-sliced
// first (sum and carry planes), so a column costs two popc.  Elsewhere a
// chunk at a row's ends counts span by span (`mask_at`); its warp waits
// for it.
template <int RC, class Src>
__device__ __forceinline__ void count_store(const Src& src,
                                            float* __restrict__ mask,
                                            int y0, int y1, int H, int W,
                                            int r_arg, float thresh) {
  constexpr int CW = OCCL_CW;
  const int r = RC >= 0 ? RC : r_arg;
  const size_t base = (size_t)y0 * W;
  const int n = (y1 - y0) * W;
  const int head = min(n, (int)((CW - (base & (CW - 1))) & (CW - 1)));
  const int nvec = (n - head) / CW;
  const bool narrow = 2 * r + CW <= 32;
  const uint32_t win = low_bits(2 * r + 1);
  float* out = mask + base;
  // the chunk's row and column, advanced without a division
  const int step = CW * OCCL_THREADS;
  const int ystep = step / W, xstep = step - ystep * W;
  int y = y0 + (head + CW * (int)threadIdx.x) / W;
  int x0 = head + CW * (int)threadIdx.x - (y - y0) * W;
  for (int v = threadIdx.x; v < nvec; v += OCCL_THREADS) {
    float m[CW];
    if (RC == 1 ? x0 + CW <= W
                : narrow && x0 >= r && x0 + CW - 1 + r <= W - 1) {
      int c[CW];
      uint32_t centre;
      if (RC == 1) {
        const uint32_t fa = field_r1(src, bleed_index(y, -1, H), x0, W);
        const uint32_t fb = field_r1(src, y, x0, W);
        const uint32_t fc = field_r1(src, bleed_index(y, 1, H), x0, W);
        const uint32_t s0 = fa ^ fb ^ fc;
        const uint32_t s1 = (fa & fb) | (fa & fc) | (fb & fc);
        centre = fb >> 1;
#pragma unroll
        for (int i = 0; i < CW; ++i)
          c[i] = __popc(s0 & (7u << i)) + 2 * __popc(s1 & (7u << i));
      } else {
        centre = 0u;
#pragma unroll
        for (int i = 0; i < CW; ++i) c[i] = 0;
        for (int dy = -r; dy <= r; ++dy) {
          const uint32_t fl =
              src.field(bleed_index(y, dy, H), x0 - r, 2 * r + CW);
          if (dy == 0) centre = fl >> r;
#pragma unroll
          for (int i = 0; i < CW; ++i) c[i] += __popc(fl & (win << i));
        }
      }
      const uint32_t ones = src.ones(y, x0, centre & low_bits(CW));
#pragma unroll
      for (int i = 0; i < CW; ++i)
        m[i] = ((float)c[i] > thresh || ((ones >> i) & 1u)) ? 1.0f : 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int yi = y + (x0 + i) / W;
        m[i] = mask_at(src, yi, (x0 + i) % W, H, W, r, thresh);
      }
    }
#pragma unroll
    for (int q = 0; q < CW / 4; ++q)
      *reinterpret_cast<float4*>(out + head + CW * v + 4 * q) =
          make_float4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
    y += ystep;
    x0 += xstep;
    if (x0 >= W) {
      x0 -= W;
      ++y;
    }
  }
  const int tail = head + CW * nvec;
  for (int f = threadIdx.x; f < head; f += OCCL_THREADS)
    out[f] = mask_at(src, y0 + f / W, f % W, H, W, r, thresh);
  for (int f = tail + threadIdx.x; f < n; f += OCCL_THREADS)
    out[f] = mask_at(src, y0 + f / W, f % W, H, W, r, thresh);
}

// The fused stage: a band of `band` rows of one eye (blockIdx.y: 0 the
// left mask, 1 the right) with the hits scattered from the disparities
// (the left eye's from dr with x - trunc(d), the right eye's from dl with
// x + trunc(d)).  Shared memory: the window's bit rows, then a scratch of
// `group` byte rows: the window's rows are scattered into it `group` at a
// time and packed into their bit rows (the scratch zeroed as it is read).
template <int RC>
__global__ void __launch_bounds__(OCCL_THREADS)
occl_masks_kernel(const float* __restrict__ dl, const float* __restrict__ dr,
                  float* __restrict__ m0, float* __restrict__ m1, int H,
                  int W, int r, int band, int group, int vec, float thresh) {
  extern __shared__ uint4 sm4[];
  const int e = blockIdx.y;
  const int y0 = blockIdx.x * band;
  const int y1 = min(H, y0 + band);
  const int lo = max(0, y0 - r), rows = min(H, y1 + r) - lo;
  const int stride = bit_stride(W), pitch = byte_pitch(W);
  const int nw = stride - 1, nch = (W + 127) / 128;
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm4);
  uint8_t* scratch = reinterpret_cast<uint8_t*>(sm4) +
                     round16((size_t)rows * stride * 4);
  zero_smem(sm4, round16((size_t)rows * stride * 4) +
                     (size_t)min(group, rows) * pitch);
  const float* d = e ? dl : dr;
  const int sign = e ? +1 : -1;
  for (int g0 = 0; g0 < rows; g0 += group) {
    const int gn = min(group, rows - g0);
    __syncthreads();
    // a warp's items OCCL_LOADS at a time: their loads in flight together
    for (int i0 = threadIdx.x >> 5; i0 < gn * nch;
         i0 += OCCL_WARPS * OCCL_LOADS) {
      float v[OCCL_LOADS][4];
#pragma unroll
      for (int u = 0; u < OCCL_LOADS; ++u) {
        const int it = min(i0 + u * OCCL_WARPS, gn * nch - 1);
        const int k = it / nch, c0 = (it - k * nch) * 128;
        load4(d + (size_t)(lo + g0 + k) * W, c0, W, vec, v[u]);
      }
#pragma unroll
      for (int u = 0; u < OCCL_LOADS; ++u) {
        const int it = i0 + u * OCCL_WARPS;
        if (it < gn * nch) {
          const int k = it / nch, c0 = (it - k * nch) * 128;
          scatter4(v[u], c0, W, sign, scratch + (size_t)k * pitch, 0, W);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < gn * nw; i += OCCL_THREADS) {
      const int k = i / nw, w = i - k * nw;
      uint4* q = reinterpret_cast<uint4*>(scratch + (size_t)k * pitch +
                                          32 * w);
      bits[(g0 + k) * stride + w] = pack16(q[0]) | pack16(q[1]) << 16;
      q[0] = q[1] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  count_store<RC>(BitRows{bits, lo, stride}, e ? m1 : m0, y0, y1, H, W, r,
                  thresh);
}

// B11's u8 entry: bands of OCCL_U8_ROWS rows of the planes o0 (blockIdx.y
// = 0) and o1, the hits read from device memory (no halo to recompute:
// small bands give many blocks).
template <int RC>
__global__ void __launch_bounds__(OCCL_THREADS)
bleed_u8_kernel(const uint8_t* __restrict__ o0,
                const uint8_t* __restrict__ o1, float* __restrict__ m0,
                float* __restrict__ m1, int H, int W, int r, float thresh) {
  const int e = blockIdx.y;
  const int y0 = blockIdx.x * OCCL_U8_ROWS;
  count_store<RC>(ByteRows{e ? o1 : o0, W}, e ? m1 : m0, y0,
                  min(H, y0 + OCCL_U8_ROWS), H, W, r, thresh);
}

static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Both eyes' hits or labels into out_l, out_r: (H, W) u8, 16-byte
// aligned; dl, dr: (H, W) f32.
static int launch_dcc(const float* dl, const float* dr, uint8_t* out_l,
                      uint8_t* out_r, int H, int W, float thresh, bool labels,
                      cudaStream_t s) {
  if (H <= 0 || W <= 0 || !aligned16(out_l) || !aligned16(out_r))
    return (int)cudaErrorInvalidValue;
  const int seg = min(W, OCCL_SEG);
  const size_t hits = 2 * round16((size_t)seg + 16);
  const size_t floats = 2 * round16((size_t)W * 4);
  const bool staged = labels && seg == W && hits + floats <= OCCL_SMEM_MAX;
  const size_t smem = hits + (staged ? floats : 0);
  const int vec = W % 4 == 0 && aligned16(dl) && aligned16(dr);
  dim3 grid(H, (W + seg - 1) / seg);
  const auto kernel = !labels ? dcc_kernel<0>
                      : staged ? dcc_kernel<1> : dcc_kernel<2>;
  const cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, OCCL_THREADS, smem, s>>>(dl, dr, out_l, out_r, W, thresh,
                                          seg, vec);
  return (int)cudaGetLastError();
}

// dl, dr: (H, W) f32; out_l, out_r: (H, W) u8.  labels != 0: dr_dcc
// labels; labels == 0: dibr_occl hits (thresh unused).
STM_API int stm_dcc(const void* dl, const void* dr, void* out_l, void* out_r,
                    int H, int W, float thresh, int labels, void* stream) {
  return launch_dcc((const float*)dl, (const float*)dr, (uint8_t*)out_l,
                    (uint8_t*)out_r, H, W, thresh, labels != 0,
                    (cudaStream_t)stream);
}

// The fused stage's shared memory for a window of `rows` bit rows and a
// scratch of one byte row; it runs where this fits.
static inline size_t occl_smem_min(int W, int rows) {
  return round16((size_t)rows * bit_stride(W) * 4) + byte_pitch(W);
}

// The largest radius the fused stage runs in one launch at width W: its
// window of 2r + 1 bit rows (rounded to 16 bytes) and a byte row fit.
STM_API int stm_occl_masks_rmax(int W) {
  if (W <= 0 || (size_t)byte_pitch(W) >= OCCL_SMEM_MAX) return -1;
  const size_t rows = (OCCL_SMEM_MAX - byte_pitch(W)) / (bit_stride(W) * 4);
  return rows < 1 ? -1 : (int)(rows - 1) / 2;
}

// The fused stage's band: about three blocks a streaming multiprocessor,
// all in one wave (larger bands leave SMs idle or unevenly loaded,
// smaller ones re-read more halo rows and run a second wave), 4 to 16
// rows, shrunk where the window's bit rows and a byte row would not fit.
static int occl_band(int H, int W, int r) {
  int dev = 0, nsm = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    nsm = 132;
  int band = min(16, max(4, (2 * H + 3 * nsm - 1) / (3 * nsm)));
  while (band > 1 && occl_smem_min(W, min(H, band + 2 * r)) > OCCL_SMEM_MAX)
    --band;
  return band;
}

static int launch_bleed_u8(const uint8_t* o0, const uint8_t* o1, float* m0,
                           float* m1, int eyes, int H, int W, int r,
                           float thresh, cudaStream_t s) {
  dim3 grid((H + OCCL_U8_ROWS - 1) / OCCL_U8_ROWS, eyes);
  const auto kernel = r == 1 ? bleed_u8_kernel<1> : bleed_u8_kernel<-1>;
  kernel<<<grid, OCCL_THREADS, 0, s>>>(o0, o1, m0, m1, H, W, r, thresh);
  return (int)cudaGetLastError();
}

// dl, dr: (H, W) f32; mask_l, mask_r: (H, W) f32, 16-byte aligned; r <
// min(H, W).  Above stm_occl_masks_rmax(W), hit_l and hit_r are (H, W) u8
// scratch planes (16-byte aligned) for the two-launch route; else unused.
STM_API int stm_occl_masks(const void* dl, const void* dr, void* hit_l,
                           void* hit_r, void* mask_l, void* mask_r, int H,
                           int W, int r, float thresh, void* stream) {
  if (H <= 0 || W <= 0 || r < 0 || r >= H || r >= W ||
      !aligned16(mask_l) || !aligned16(mask_r))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= stm_occl_masks_rmax(W)) {
    const int band = occl_band(H, W, r);
    const int rows = min(H, band + 2 * r);
    const size_t bits = round16((size_t)rows * bit_stride(W) * 4);
    const int group =
        (int)min((size_t)rows, (OCCL_SMEM_MAX - bits) / byte_pitch(W));
    const size_t smem = bits + (size_t)group * byte_pitch(W);
    const auto kernel = r == 1 ? occl_masks_kernel<1> : occl_masks_kernel<-1>;
    cudaError_t err = stm_smem_cap(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = W % 4 == 0 && aligned16(dl) && aligned16(dr);
    dim3 grid((H + band - 1) / band, 2);
    kernel<<<grid, OCCL_THREADS, smem, s>>>(
        (const float*)dl, (const float*)dr, (float*)mask_l, (float*)mask_r, H,
        W, r, band, group, vec, thresh);
    return (int)cudaGetLastError();
  }
  if (hit_l == nullptr || hit_r == nullptr) return (int)cudaErrorInvalidValue;
  const int rc = launch_dcc((const float*)dl, (const float*)dr,
                            (uint8_t*)hit_l, (uint8_t*)hit_r, H, W, 0.0f,
                            false, s);
  if (rc != 0) return rc;
  return launch_bleed_u8((const uint8_t*)hit_l, (const uint8_t*)hit_r,
                         (float*)mask_l, (float*)mask_r, 2, H, W, r, thresh,
                         s);
}

// occl: (H, W) u8; mask: (H, W) f32, 16-byte aligned; r < min(H, W).
STM_API int stm_bleed_mask(const void* occl, void* mask, int H, int W, int r,
                           float thresh, void* stream) {
  if (H <= 0 || W <= 0 || r < 0 || r >= H || r >= W || !aligned16(mask))
    return (int)cudaErrorInvalidValue;
  return launch_bleed_u8((const uint8_t*)occl, nullptr, (float*)mask,
                         nullptr, 1, H, W, r, thresh, (cudaStream_t)stream);
}
