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
// int16 and float32).  Design: the per-d shift makes a direct gather
// uncoalesced (neighbouring d read addresses D-1 elements apart), so a
// block stages in shared memory the P columns that its outputs of one row
// can reach, and assembles the outputs from there.  A block takes SHEAR_TX
// columns of one row and one chunk of 128 bytes of d (128 d in u8, 64 in
// int16, 32 in float32): its outputs reach SHEAR_TX + DC - 1 columns of
// that chunk (40.8, 32.6 or 28.5 KB), one 128-byte segment each, loaded
// with coalesced 32-bit loads, so the staged bytes are (SHEAR_TX + DC -
// 1) / SHEAR_TX of the outputs' (1.66, 1.33, 1.16).  Each thread then
// assembles 4 consecutive d of one x from the staged window (diagonal
// reads: lane i takes elements 4i..4i+3 of different columns) and writes
// them as one store of 4, 8 or 16 bytes.  A D that is no multiple of 4
// leaves the rows unaligned for such words: the block then stages and
// writes single elements, the last quad of a position cut at the chunk's
// end.  (A first version staged all D of 64 columns, 24, 49 or 98 KB a
// block: 0.540, 1.289 and 4.444 ms on an H100 at 1080p/D=128.)

#include "stm_common.cuh"

#define SHEAR_TX 192                // output columns of a block
#define SHEAR_THREADS 256
#define SHEAR_CHUNK_BYTES 128       // d of a block: one 128-byte segment

// blockIdx: (column tile, row, chunk of d)
template <typename T, bool VEC>
__global__ void __launch_bounds__(SHEAR_THREADS)
shear_right_kernel(const T* __restrict__ pair, T* __restrict__ out, int W,
                   int D, int zd, int M) {
  constexpr int DC = SHEAR_CHUNK_BYTES / (int)sizeof(T);
  extern __shared__ uint32_t win[];        // [column][DC] of T
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
  if (VEC) {
    // a column's chunk is dc * sizeof(T) bytes, a whole number of words
    constexpr int RW = DC * (int)sizeof(T) / 4;  // words of a staged row
    const int cw = dc * (int)sizeof(T) / 4;
    for (int i = threadIdx.x; i < ncol * cw; i += blockDim.x) {
      const int j = i / cw, k = i - j * cw;
      const int c = c0 + j;
      win[j * RW + k] =
          (c >= 0 && c < wp)
              ? reinterpret_cast<const uint32_t*>(prow + (size_t)c * D)[k]
              : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < ncol * dc; i += blockDim.x) {
      const int j = i / dc, k = i - j * dc;
      const int c = c0 + j;
      wt[j * DC + k] = (c >= 0 && c < wp) ? prow[(size_t)c * D + k] : (T)0;
    }
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
      v[j] = (VEC || dd < dc) ? wt[(xi + dc - 1 - dd) * DC + dd] : (T)0;
    }
    T* o = orow + (size_t)(x0 + xi) * D + dd0;
    if (VEC) {
      stm_store4(o, v);
    } else {
      for (int j = 0; j < 4 && dd0 + j < dc; ++j) o[j] = v[j];
    }
  }
}

template <typename T>
static int launch_shear(const void* pair, void* out, int H, int W, int D,
                        int zd, int M, void* stream) {
  constexpr int DC = SHEAR_CHUNK_BYTES / (int)sizeof(T);
  const size_t smem = (size_t)(SHEAR_TX + DC - 1) * SHEAR_CHUNK_BYTES;
  auto kernel = (D & 3) ? shear_right_kernel<T, false>
                        : shear_right_kernel<T, true>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + SHEAR_TX - 1) / SHEAR_TX, H, (D + DC - 1) / DC);
  kernel<<<grid, SHEAR_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)pair, (T*)out, W, D, zd, M);
  return (int)cudaGetLastError();
}

// pair: (H, W + 2M, D) with M = max(zd, D - zd); out: (H, W, D); both of
// elem_size 1 (u8), 2 (int16) or 4 (float32) bytes.
STM_API int stm_shear_right(const void* pair, void* out, int H, int W, int D,
                            int zd, int elem_size, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > D || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int M = zd > D - zd ? zd : D - zd;
  switch (elem_size) {
    case 1:
      return launch_shear<uint8_t>(pair, out, H, W, D, zd, M, stream);
    case 2:
      return launch_shear<int16_t>(pair, out, H, W, D, zd, M, stream);
    case 4:
      return launch_shear<float>(pair, out, H, W, D, zd, M, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
