// B3: the right eye's cost volume, sheared out of the pair volume.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_shear_kernel_xm` (reached via `ci_adcensus_kern_xm`, shear=True).
//
// out[y][x][d] = P[y][x - (d - zd) + M][d] for x in [0, W), which equals
// cost(L(clamp(x - (d - zd))), R(x)), with M = max(zd, D - zd).  The
// elements are u8, int16 (the band_qscale dial) or float32 (quant=False).
//
// Bound on the H100: pure data movement (283 MB read, 265 MB written at
// 1080p/D=128 in u8, ~0.16 ms at 3.35 TB/s; twice and four times that in
// int16 and float32).  The per-d shift makes a direct gather uncoalesced
// (neighbouring d read addresses D-1 elements apart), so the pair volume
// is staged in shared memory and the outputs are assembled from there.
//
// Design (D % 4 == 0): a stream, not tiles.  One warp walks one row's x
// range for one chunk of 128 bytes of d (128 d in u8, 64 in int16, 32 in
// float32; dc of them in the chunk).  Output x reads the pair columns
// x + M + zd - d0 - (dc - 1) .. x + M + zd - d0 of the chunk; the warp
// keeps a ring of them in shared memory and slides it along x, so each
// pair column is read from device memory once (1.0 of the bytes written,
// against 1.66 for tiles of 192 columns).  Where the rows and chunks are
// too few for one warp on each of the card's slots, each row is cut into
// up to W / (2 dc) segments of x, which read dc - 1 columns more each.  Lane l copies and reads back
// only word l of each column (4 bytes: elements E*l .. E*l+E-1, E = 4 /
// sizeof(T)), so no barrier is needed beyond the copy's own wait: each
// column arrives by one coalesced 128-byte cp.async of the warp, in tiles
// of TX columns, SHEAR_PF tiles ahead of those the outputs read.  Output
// element E*l + j of column x is element j of word l of pair column
// x + dc - 1 - E*l - j (ring-relative): the lane keeps the last E words
// it read in registers, and each output word is E masked selections of
// them (one shared-memory load and one 4-byte store an output word).
// A D that is no multiple of 4 leaves the rows unaligned for such words:
// then a block stages SHEAR_TX + dc - 1 columns of single elements for
// SHEAR_TX outputs and writes single elements, the last quad of a
// position cut at the chunk's end.

#include "stm_common.cuh"

#define SHEAR_CHUNK_BYTES 128       // d of a warp or block: 128 bytes
#define SHEAR_PF 1                  // tiles loading beyond those in use
#define SHEAR_TX 192                // output columns of a scalar block
#define SHEAR_THREADS 256

// Streamed: warp item = blockIdx.x * WPB + warp takes row y, chunk z of
// d and the g-th of `nxs` segments of `xlen` output columns, item = (y *
// nchunk + z) * nxs + g; `nt` ring tiles of TX columns each.
template <typename T, int TX, int WPB>
__global__ void __launch_bounds__(32 * WPB)
shear_stream_kernel(const T* __restrict__ pair, T* __restrict__ out, int H,
                    int W, int D, int zd, int M, int nchunk, int nt, int nxs,
                    int xlen) {
  constexpr int E = 4 / (int)sizeof(T);          // elements of a word
  constexpr int DC = SHEAR_CHUNK_BYTES / (int)sizeof(T);
  extern __shared__ __align__(16) uint32_t ring_all[];
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (item >= H * nchunk * nxs) return;
  const int yz = item / nxs;
  const int xa = (item - yz * nxs) * xlen;       // the segment's first x
  const int y = yz / nchunk;
  const int d0 = (yz - y * nchunk) * DC;
  const int dc = min(DC, D - d0);
  const int nx = min(xlen, W - xa);              // the segment's outputs
  if (nx <= 0) return;
  const int nr = 1 + (dc + TX - 2) / TX;         // tiles an output tile reads
  const int R = nt * TX;                          // ring columns
  uint32_t* ring = ring_all + (threadIdx.x >> 5) * R * 32 + lane;
  const int ns = nx + dc - 1;                     // pair columns read
  const bool act = lane < dc / E;
  const size_t colw = (size_t)(D / E);            // words between columns
  // word `lane` of the first pair column read (ring-relative column 0)
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(
          pair + ((size_t)y * (W + 2 * M) + xa + M + zd - d0 - (dc - 1)) * D +
          d0) +
      lane;
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(out + ((size_t)y * W + xa) * D + d0) + lane;

  auto fill = [&](int t) {        // ring-relative columns [t*TX, t*TX+TX)
    if (act) {
      uint32_t* r = ring + (t % nt) * TX * 32;
#pragma unroll
      for (int i = 0; i < TX; ++i)
        if (t * TX + i < ns)
          stm_cp4(r + i * 32, src + (size_t)(t * TX + i) * colw);
    }
    stm_cp_commit();
  };

  for (int t = 0; t < nr + SHEAR_PF - 1; ++t) fill(t);
  const int p0 = dc - 1 - E * lane;   // column of element 0 of output 0
  int q = act ? p0 : 0;               // ring slot of the next word to read
  uint32_t win[E];                    // win[j]: the word for element j
  const int nu = (nx + TX - 1) / TX;
  for (int u = 0; u < nu; ++u) {
    fill(u + nr - 1 + SHEAR_PF);
    stm_cp_wait<SHEAR_PF>();
    if (!act) continue;
    if (u == 0) {
#pragma unroll
      for (int j = 0; j + 1 < E; ++j) win[j] = ring[(p0 - 1 - j) * 32];
    }
#pragma unroll
    for (int i = 0; i < TX; ++i) {
      const int x = u * TX + i;
      if (x < nx) {
#pragma unroll
        for (int j = E - 1; j > 0; --j) win[j] = win[j - 1];
        win[0] = ring[q * 32];
        q = q + 1 == R ? 0 : q + 1;
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const uint32_t mask = (0xFFFFFFFFu >> (32 - 32 / E))
                                << (32 / E * j);
          v |= win[j] & mask;
        }
        dst[(size_t)x * colw] = v;
      }
    }
  }
}

// Scalar (D % 4 != 0): blockIdx (column tile, row, chunk of d).
template <typename T>
__global__ void __launch_bounds__(SHEAR_THREADS)
shear_scalar_kernel(const T* __restrict__ pair, T* __restrict__ out, int W,
                    int D, int zd, int M) {
  constexpr int DC = SHEAR_CHUNK_BYTES / (int)sizeof(T);
  extern __shared__ __align__(16) uint32_t win[];   // [column][DC] of T
  T* wt = reinterpret_cast<T*>(win);
  const int x0 = blockIdx.x * SHEAR_TX;
  const int y = blockIdx.y;
  const int d0 = blockIdx.z * DC;
  const int dc = min(DC, D - d0);          // d of this chunk
  const int wp = W + 2 * M;
  const int lead = d0 + dc - 1 - zd;       // largest reach to the left
  const int c0 = x0 + M - lead;            // first staged pair column
  const int ncol = SHEAR_TX + dc - 1;
  const T* prow = pair + (size_t)y * wp * D + d0;
  for (int i = threadIdx.x; i < ncol * dc; i += blockDim.x) {
    const int j = i / dc, k = i - j * dc;
    const int c = c0 + j;
    wt[j * DC + k] = (c >= 0 && c < wp) ? prow[(size_t)c * D + k] : (T)0;
  }
  __syncthreads();

  const int nx = min(SHEAR_TX, W - x0);
  const int quads = (dc + 3) >> 2;
  T* orow = out + (size_t)y * W * D + d0;
  for (int t = threadIdx.x; t < nx * quads; t += blockDim.x) {
    const int xi = t / quads;
    const int dd0 = (t - xi * quads) * 4;
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = dd0 + j;
      // staged column of (x0 + xi, d0 + dd): in [0, SHEAR_TX + dc - 1)
      v[j] = dd < dc ? wt[(xi + dc - 1 - dd) * DC + dd] : (T)0;
    }
    T* o = orow + (size_t)(x0 + xi) * D + dd0;
    for (int j = 0; j < 4 && dd0 + j < dc; ++j) o[j] = v[j];
  }
}

template <typename T, int TX, int WPB>
static int launch_stream(const void* pair, void* out, int H, int W, int D,
                         int zd, int M, void* stream) {
  constexpr int DC = SHEAR_CHUNK_BYTES / (int)sizeof(T);
  const int dcmax = D < DC ? D : DC;
  const int nt = 1 + (dcmax + TX - 2) / TX + SHEAR_PF;
  const size_t smem = (size_t)WPB * nt * TX * 32 * 4;
  auto kernel = shear_stream_kernel<T, TX, WPB>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // rows and chunks too few to fill the card (the lowres preset's 540
  // rows) are cut into segments of x, each reading dc - 1 columns more
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 32 * WPB, smem)) != cudaSuccess)
    return (int)err;
  const int nchunk = (D + DC - 1) / DC;
  const long long rows = (long long)H * nchunk;
  long long nxs = (long long)sms * per_sm * WPB / rows;
  const long long most = W / (2 * dcmax);
  nxs = nxs < most ? nxs : most;
  nxs = nxs > 1 ? nxs : 1;
  const int xlen = (int)((W + nxs - 1) / nxs);
  const long long items = rows * nxs;
  if (items > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)((items + WPB - 1) / WPB), 32 * WPB, smem,
           (cudaStream_t)stream>>>((const T*)pair, (T*)out, H, W, D, zd, M,
                                   nchunk, nt, (int)nxs, xlen);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_scalar(const void* pair, void* out, int H, int W, int D,
                         int zd, int M, void* stream) {
  constexpr int DC = SHEAR_CHUNK_BYTES / (int)sizeof(T);
  const size_t smem = (size_t)(SHEAR_TX + DC - 1) * SHEAR_CHUNK_BYTES;
  auto kernel = shear_scalar_kernel<T>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (H > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((W + SHEAR_TX - 1) / SHEAR_TX, H, (D + DC - 1) / DC);
  kernel<<<grid, SHEAR_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)pair, (T*)out, W, D, zd, M);
  return (int)cudaGetLastError();
}

template <typename T, int TX, int WPB>
static int launch_shear(const void* pair, void* out, int H, int W, int D,
                        int zd, int M, void* stream) {
  const bool words = D % 4 == 0 && ((uintptr_t)pair % 4) == 0 &&
                     ((uintptr_t)out % 4) == 0;
  return words ? launch_stream<T, TX, WPB>(pair, out, H, W, D, zd, M, stream)
               : launch_scalar<T>(pair, out, H, W, D, zd, M, stream);
}

// pair: (H, W + 2M, D) with M = max(zd, D - zd); out: (H, W, D); both of
// elem_size 1 (u8), 2 (int16) or 4 (float32) bytes.
STM_API int stm_shear_right(const void* pair, void* out, int H, int W, int D,
                            int zd, int elem_size, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > D)
    return (int)cudaErrorInvalidValue;
  const int M = zd > D - zd ? zd : D - zd;
  // tiles of 32, 16 and 8 columns (24, 12 and 6 KB rings at D = 128) and
  // two warps a block in float32: every row and chunk of a 1080-row frame
  // in one wave
  switch (elem_size) {
    case 1:
      return launch_shear<uint8_t, 32, 1>(pair, out, H, W, D, zd, M, stream);
    case 2:
      return launch_shear<int16_t, 16, 1>(pair, out, H, W, D, zd, M, stream);
    case 4:
      return launch_shear<float, 8, 2>(pair, out, H, W, D, zd, M, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
