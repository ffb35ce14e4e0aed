// B3: the right eye's cost volume, sheared out of the pair volume.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/costkern.py
// `_shear_kernel_xm` (reached via `ci_adcensus_kern_xm`, shear=True).
//
// out[y][x][d] = P[y][x - (d - zd) + M][d] for x in [0, W), which equals
// cost(L(clamp(x - (d - zd))), R(x)), with M = max(zd, D - zd).
//
// Bound on the H100: pure data movement (283 MB read, 265 MB written at
// 1080p/D=128, ~0.16 ms at 3.35 TB/s).  Design: the per-d shift makes a
// direct gather uncoalesced (neighbouring d read addresses D-1 bytes
// apart), so a block stages the P columns its 64 outputs of one row can
// reach (64 + D - 1 columns of D bytes, 24 KB at D=128) in shared memory
// with coalesced 32-bit loads, then each thread assembles 4 consecutive
// d of one x from the staged window (bank-conflict-free: lane i reads
// bytes 4i..4i+3 of different rows) and writes them as one 32-bit store.
// A D that is no multiple of 4 leaves the rows unaligned for 32-bit
// words: the block then stages and writes single bytes, the last quad of
// a position cut at D.

#include "stm_common.cuh"

#define SHEAR_TX 64
#define SHEAR_THREADS 256

template <bool VEC>
__global__ void __launch_bounds__(SHEAR_THREADS)
shear_right_kernel(const uint8_t* __restrict__ pair, uint8_t* __restrict__ out,
                   int W, int D, int zd, int M) {
  extern __shared__ uint32_t win[];          // (SHEAR_TX + D - 1) x D bytes
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * SHEAR_TX;
  const int wp = W + 2 * M;
  const int lead = D - 1 - zd;               // largest reach to the left
  const int c0 = x0 + M - lead;              // first staged pair column
  const int ncol = SHEAR_TX + D - 1;
  const int quads = (D + 3) >> 2;
  const uint8_t* prow = pair + (size_t)y * wp * D;
  uint8_t* wb = reinterpret_cast<uint8_t*>(win);
  if (VEC) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(prow);
    for (int i = threadIdx.x; i < ncol * quads; i += blockDim.x) {
      const int c = c0 + i / quads;
      win[i] = (c >= 0 && c < wp) ? pw[(size_t)c * quads + (i % quads)] : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < ncol * D; i += blockDim.x) {
      const int c = c0 + i / D;
      wb[i] = (c >= 0 && c < wp) ? prow[(size_t)c * D + (i % D)] : 0;
    }
  }
  __syncthreads();

  const int nx = min(SHEAR_TX, W - x0);
  uint8_t* orow = out + (size_t)y * W * D;
  for (int t = threadIdx.x; t < nx * quads; t += blockDim.x) {
    const int xi = t / quads;
    const int d0 = (t - xi * quads) * 4;
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + j;
      const int col = xi - (d - zd) + lead;  // in [0, SHEAR_TX + D - 1)
      if (VEC || d < D)
        packed |= (uint32_t)wb[(size_t)col * D + d] << (8 * j);
    }
    uint8_t* o = orow + (size_t)(x0 + xi) * D + d0;
    if (VEC) {
      *reinterpret_cast<uint32_t*>(o) = packed;
    } else {
      for (int j = 0; j < 4 && d0 + j < D; ++j)
        o[j] = (uint8_t)(packed >> (8 * j));
    }
  }
}

// pair: (H, W + 2M, D) u8 with M = max(zd, D - zd); out: (H, W, D) u8.
STM_API int stm_shear_right(const void* pair, void* out, int H, int W, int D,
                            int zd, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || zd < 0 || zd > D)
    return (int)cudaErrorInvalidValue;
  const int M = zd > D - zd ? zd : D - zd;
  const size_t smem = (size_t)(SHEAR_TX + D - 1) * D;
  auto kernel = (D & 3) ? shear_right_kernel<false> : shear_right_kernel<true>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + SHEAR_TX - 1) / SHEAR_TX, H);
  kernel<<<grid, SHEAR_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)pair, (uint8_t*)out, W, D, zd, M);
  return (int)cudaGetLastError();
}
