// B17: the right eye's disparity-major cost volume as per-plane shifts of
// the left eye's.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_shear_kernel` (reached via `_shear_right` from
// `ci_adcensus_kern(shift_extract=True)`).
//
// out[d][y][x] = vol[d][y][x - (d - zd)] where 0 <= x - (d - zd) < W, else 0.
// cost_r(x, d) = cost_l(x - (d - zd), d) wherever that column lies inside
// the image (the same pixel pair), so this is the right eye's cost but for
// the border columns, which the caller recomputes (B16, right-eye mode).
// The TPU kernel rolls each plane of a zero-padded copy by a static lane
// count; here each element is read at its shifted column directly.
//
// Bound on the H100: pure data movement, each element read and written
// once: at 1080p/D=128 265 MB each way in u8 (~0.16 ms at 3.35 TB/s), 1.06
// GB each way in float32 (~0.63 ms).
//
// u8 on rows of whole 16-byte words (W % 16 == 0, both volumes 16-byte
// aligned; `shear_dm_u8_vec_kernel`): a warp takes a (d, y) row and a chunk
// of 32 * SHEAR_V_U = 128 words, lane l the words l + 32 u, so each store
// instruction of the warp writes 512 contiguous bytes.  Output word x (16
// bytes from column 16 x) reads columns 16 x - s .. 16 x - s + 15, s =
// d - zd: bytes r .. r + 15 of the aligned source words x + A and x + A + 1
// (A = floor(-s / 16), r = -s mod 16, both the same for the whole row),
// assembled 4 bytes at a time by funnel shifts of their 32-bit parts;
// source words outside the row read as 0, which fills the zero columns at
// the row's start (s > 0) or end (s < 0).  A persistent grid (as many
// blocks as fit on the card) walks the (row, chunk) items, each warp
// issuing the next item's loads before the current item's stores, so two
// items' loads are in flight a warp.  Other u8 rows (`shear_dm_u8_kernel`):
// one thread per (d, y, 4 consecutive x), a block of 128 threads 512
// columns of one row; where the four source bytes lie inside the row and
// rows are 4-byte aligned (W % 4 == 0), two aligned 32-bit loads and a
// funnel shift assemble them whatever the shift, one 32-bit store; else
// byte by byte.  float32 (`shear_dm_f32_kernel`, 90% of its bound): four
// loads (consecutive threads read consecutive 16-byte groups) and one
// 16-byte store a thread; rows of W % 4 != 0 element by element.

#include "stm_common.cuh"

#define SHEAR_DM_TX 128
#define SHEAR_V_WARPS 8     // warps a block of the 16-byte path
#define SHEAR_V_U 4         // 16-byte words a lane and item

// Output word at byte rotation r of the 32 source bytes (a, b): bytes
// r .. r + 15, r = 4 q + k, each 32-bit part a funnel shift of two
// neighbouring parts by 8 k bits.
__device__ __forceinline__ uint4 funnel5(uint32_t w0, uint32_t w1,
                                         uint32_t w2, uint32_t w3,
                                         uint32_t w4, int sh) {
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__device__ __forceinline__ uint4 shear_word(const uint4& a, const uint4& b,
                                            int r) {
  const int sh = 8 * (r & 3);
  switch (r >> 2) {           // the same for every lane of the row
    case 0: return funnel5(a.x, a.y, a.z, a.w, b.x, sh);
    case 1: return funnel5(a.y, a.z, a.w, b.x, b.y, sh);
    case 2: return funnel5(a.z, a.w, b.x, b.y, b.z, sh);
    default: return funnel5(a.w, b.x, b.y, b.z, b.w, sh);
  }
}

// One (row, chunk) item of the 16-byte path: the row's first word in both
// volumes, lane l's first output word, and the row's source offset A and
// rotation r.
struct ShearItem {
  size_t row;
  int w0, A, r;
};

__device__ __forceinline__ ShearItem shear_item(long long item, int nchunks,
                                                int H, int nw, int zd) {
  const long long row = item / nchunks;
  const int c = (int)(item - row * nchunks);
  const int ns = zd - (int)(row / H);            // -s
  return {(size_t)row * nw, c * 32 * SHEAR_V_U + (int)(threadIdx.x & 31),
          ns >> 4, ns & 15};
}

__device__ __forceinline__ void shear_load(const uint4* __restrict__ vol,
                                           const ShearItem& it, int nw,
                                           uint4 (&a)[SHEAR_V_U],
                                           uint4 (&b)[SHEAR_V_U]) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < SHEAR_V_U; ++u) {
    const int ow = it.w0 + 32 * u, sa = ow + it.A;
    const bool out = ow < nw;
    a[u] = out && sa >= 0 && sa < nw ? __ldg(vol + it.row + sa) : zero;
    b[u] = out && it.r != 0 && sa + 1 >= 0 && sa + 1 < nw
               ? __ldg(vol + it.row + sa + 1)
               : zero;
  }
}

__global__ void __launch_bounds__(32 * SHEAR_V_WARPS)
shear_dm_u8_vec_kernel(const uint4* __restrict__ vol, uint4* __restrict__ out,
                       int H, int nw, int zd, int nchunks, long long items) {
  const long long stride = (long long)gridDim.x * SHEAR_V_WARPS;
  long long item = (long long)blockIdx.x * SHEAR_V_WARPS + threadIdx.x / 32;
  if (item >= items) return;
  ShearItem it = shear_item(item, nchunks, H, nw, zd);
  uint4 a[SHEAR_V_U], b[SHEAR_V_U];
  shear_load(vol, it, nw, a, b);
  for (;;) {
    const long long next = item + stride;
    const bool more = next < items;
    ShearItem nit;
    uint4 na[SHEAR_V_U], nb[SHEAR_V_U];
    if (more) {
      nit = shear_item(next, nchunks, H, nw, zd);
      shear_load(vol, nit, nw, na, nb);
    }
#pragma unroll
    for (int u = 0; u < SHEAR_V_U; ++u) {
      const int ow = it.w0 + 32 * u;
      if (ow < nw) out[it.row + ow] = shear_word(a[u], b[u], it.r);
    }
    if (!more) break;
    item = next;
    it = nit;
#pragma unroll
    for (int u = 0; u < SHEAR_V_U; ++u) {
      a[u] = na[u];
      b[u] = nb[u];
    }
  }
}

__global__ void __launch_bounds__(SHEAR_DM_TX)
shear_dm_u8_kernel(const uint8_t* __restrict__ vol, uint8_t* __restrict__ out,
                   int H, int W, int zd) {
  const int x = (blockIdx.x * SHEAR_DM_TX + threadIdx.x) * 4;
  if (x >= W) return;
  const int d = blockIdx.z;
  const int xs = x - (d - zd);               // source column of x
  const size_t row = ((size_t)d * H + blockIdx.y) * W;
  const uint8_t* src = vol + row;
  uint8_t* dst = out + row;
  const bool aligned = (W & 3) == 0;
  const int a = xs & ~3;                      // aligned word holding xs
  if (aligned && xs >= 0 && a + 8 <= W) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(src + a);
    *reinterpret_cast<uint32_t*>(dst + x) =
        __funnelshift_r(w[0], w[1], 8 * (xs & 3));
    return;
  }
  uint8_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = xs + j;
    v[j] = (c >= 0 && c < W) ? src[c] : (uint8_t)0;
  }
  if (aligned) {                              // x + 3 < W
    *reinterpret_cast<uint32_t*>(dst + x) =
        v[0] | (v[1] << 8) | (v[2] << 16) | ((uint32_t)v[3] << 24);
  } else {
    for (int j = 0; j < 4 && x + j < W; ++j) dst[x + j] = v[j];
  }
}

__global__ void __launch_bounds__(SHEAR_DM_TX)
shear_dm_f32_kernel(const float* __restrict__ vol, float* __restrict__ out,
                    int H, int W, int zd) {
  const int x = (blockIdx.x * SHEAR_DM_TX + threadIdx.x) * 4;
  if (x >= W) return;
  const int d = blockIdx.z;
  const int xs = x - (d - zd);
  const size_t row = ((size_t)d * H + blockIdx.y) * W;
  const float* src = vol + row;
  float* dst = out + row;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = xs + j;
    v[j] = (c >= 0 && c < W) ? src[c] : 0.0f;
  }
  if ((W & 3) == 0) {                         // x + 3 < W, 16-byte aligned
    *reinterpret_cast<float4*>(dst + x) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && x + j < W; ++j) dst[x + j] = v[j];
  }
}

// The 16-byte path: a persistent grid of as many blocks as fit on the
// card, or fewer where the items are fewer.
static int shear_dm_u8_vec(const void* vol, void* out, int H, int W, int D,
                           int zd, cudaStream_t stream) {
  const int nw = W / 16;
  const int nchunks = (nw + 32 * SHEAR_V_U - 1) / (32 * SHEAR_V_U);
  const long long items = (long long)D * H * nchunks;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, shear_dm_u8_vec_kernel, 32 * SHEAR_V_WARPS, 0)) !=
          cudaSuccess)
    return (int)err;
  const long long need = (items + SHEAR_V_WARPS - 1) / SHEAR_V_WARPS;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  shear_dm_u8_vec_kernel<<<(unsigned)(need < fit ? need : fit),
                           32 * SHEAR_V_WARPS, 0, stream>>>(
      (const uint4*)vol, (uint4*)out, H, nw, zd, nchunks, items);
  return (int)cudaGetLastError();
}

// vol, out: (D, H, W) contiguous, elem_size 1 (u8) or 4 (f32); 0 <= zd.
STM_API int stm_shear_dm(const void* vol, void* out, int H, int W, int D,
                         int zd, int elem_size, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || H > 65535 || D > 65535 ||
      (elem_size != 1 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 1 && W % 16 == 0 &&
      (((uintptr_t)vol | (uintptr_t)out) & 15) == 0)
    return shear_dm_u8_vec(vol, out, H, W, D, zd, st);
  dim3 grid((W + 4 * SHEAR_DM_TX - 1) / (4 * SHEAR_DM_TX), H, D);
  if (elem_size == 1)
    shear_dm_u8_kernel<<<grid, SHEAR_DM_TX, 0, st>>>(
        (const uint8_t*)vol, (uint8_t*)out, H, W, zd);
  else
    shear_dm_f32_kernel<<<grid, SHEAR_DM_TX, 0, st>>>(
        (const float*)vol, (float*)out, H, W, zd);
  return (int)cudaGetLastError();
}
