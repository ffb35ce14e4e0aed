// B8 + B9: one round of iterative region voting (IRV).
//
// Replace the TPU kernels stereo_to_multiview_tpu/ops/irvkern.py
// `_rowspan_kernel` (B8) and `_vote_kernel` (B9), reached via
// `irv_round_kern`.
//
// B8, row spans: for every pixel (y, x) and channel c of C = B + 1,
//   cnt[y][x][c] = #{q in [x - LEFT, x + RIGHT] : reliable(y, q) and
//                   (c < B ? trunc(d(y, q)) + zd == c : true)}
// (inclusive window clipped to the row; channel B counts every reliable
// pixel, so the vote's total is exact even for a disparity outside the
// bins).  Counts are <= 2 * reach + 1 and stored as u8.
// B9, vote: hist[c] = sum of cnt over rows [y - UP, y + DOWN] (inclusive,
// clipped); first maximum over the B bins; total = hist[B]; an outlier
// accepts max_d = winner - zd (its own trunc(d) when every bin is 0) iff
// total > thresh_s and (max_d + zd) / max(total, 1) > thresh_h -- the
// reference divides the disparity, not the count.
//
// Bound on the H100: memory.  B8 writes and B9 reads the (H, W, B + 1)
// u8 span volume, 267 MB per eye and round at 1080p/D=128 (~80 us each);
// the planes around it are 8 MB.  Design: the window-prefix scheme of the
// aggregation (window.cuh) with one thread per channel.  B8 stages the
// row's bin keys for the tile plus the arm reach in shared memory, each
// thread builds the prefix counts of its channel from them (the one-hot
// volume never exists), and each output is one difference.  B9 runs down
// one image column per block: prefix counts of each channel over the
// tile's rows plus the reach, the window difference, then the block's
// first-max reduction (warp max + ballot, then warps in order) and the
// vote in the epilogue, so the histogram never reaches device memory.
// Both stage their tile's window bounds (from the arms) in shared memory
// first, so the per-position loop waits on no device-memory load; B9
// keeps 16-bit prefixes so that more blocks fit on an SM.
//
// `need` gating (the TPU kernels' flag-gated DMA, irvkern.py `wflags` /
// `vflags`): with a `need` plane, only outliers at need pixels vote; every
// other pixel keeps its disparity and label.  A B9 block (one column, 64
// rows) with no such pixel copies its inputs through and reads no spans.
// B8 first marks those live (64-row tile, column) cells in a small u8 map
// (`irv_live_kernel`), and a B8 block (one row, 64 columns) whose row no
// live cell of its columns can read (the cell's rows plus the vote reach)
// writes nothing: those spans stay undefined and are never read.  Without
// `need` both kernels do the full round.

#include "stm_common.cuh"

#define IRV_TILE 64

// Bin key of a pixel: its bin in [0, B), B for a reliable pixel outside
// the bins, -1 for an outlier.
__device__ __forceinline__ int irv_key(float d, uint8_t outl, int B, int zd) {
  if (outl != 0) return -1;
  const long long b = (long long)(int)d + zd;
  return (b >= 0 && b < B) ? (int)b : B;
}

// live[t][x] = 1 iff column x has an outlier at a need pixel in rows
// [t * IRV_TILE, (t + 1) * IRV_TILE): the cells whose votes B9 evaluates.
__global__ void irv_live_kernel(const uint8_t* __restrict__ need,
                                const uint8_t* __restrict__ outl,
                                uint8_t* __restrict__ live, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (x >= W) return;
  const int r1 = min((t + 1) * IRV_TILE, H);
  uint8_t any = 0;
  for (int r = t * IRV_TILE; r < r1; ++r) {
    const size_t i = (size_t)r * W + x;
    any |= (need[i] != 0) & (outl[i] != 0);
  }
  live[(size_t)t * W + x] = any;
}

__global__ void irv_rowspan_kernel(const float* __restrict__ disp,
                                   const uint8_t* __restrict__ outl,
                                   const int* __restrict__ left,
                                   const int* __restrict__ right,
                                   const uint8_t* __restrict__ live,
                                   uint8_t* __restrict__ cnt, int H, int W,
                                   int B, int zd, int reach) {
  extern __shared__ int smem[];
  const int C = B + 1;
  const int y = blockIdx.y;
  const int p0 = blockIdx.x * IRV_TILE;
  const int p1 = min(p0 + IRV_TILE, W);
  if (live != nullptr) {
    // a live cell (t, x) reads the rows [t * TILE - reach, (t + 1) * TILE
    // + reach) of column x
    const int nt = (H + IRV_TILE - 1) / IRV_TILE;
    const int t0 = max(y - reach, 0) / IRV_TILE;
    const int t1 = min((y + reach) / IRV_TILE, nt - 1);
    int any = 0;
    for (int i = threadIdx.x; i < (t1 - t0 + 1) * (p1 - p0); i += blockDim.x)
      any |= live[(size_t)(t0 + i / (p1 - p0)) * W + p0 + i % (p1 - p0)];
    if (!__syncthreads_or(any)) return;
  }
  const int lo = max(p0 - reach, 0);
  const int hi = min(p1 + reach, W);
  int* win_a = smem;                                  // IRV_TILE window
  int* win_b = win_a + IRV_TILE;                      // ends (prefix rows)
  int* key = win_b + IRV_TILE;                        // hi - lo keys
  uint16_t* pre = reinterpret_cast<uint16_t*>(key + IRV_TILE + 2 * reach);
  const size_t row = (size_t)y * W;
  for (int q = lo + threadIdx.x; q < hi; q += blockDim.x)
    key[q - lo] = irv_key(disp[row + q], outl[row + q], B, zd);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int an = min(max(left[row + p], 0), reach);
    const int ap = min(max(right[row + p], 0), reach);
    win_a[p - p0] = max(p - an, 0) - lo;
    win_b[p - p0] = min(p + ap + 1, W) - lo;
  }
  __syncthreads();

  const int c = threadIdx.x;
  if (c >= C) return;
  uint16_t acc = 0;
  pre[c] = 0;
  for (int q = 0; q < hi - lo; ++q) {
    const int k = key[q];
    acc += (c < B) ? (k == c) : (k >= 0);
    pre[(q + 1) * C + c] = acc;                       // read back only by c
  }
  for (int p = p0; p < p1; ++p)
    cnt[(row + p) * C + c] = (uint8_t)(pre[win_b[p - p0] * C + c] -
                                       pre[win_a[p - p0] * C + c]);
}

__global__ void irv_vote_kernel(const uint8_t* __restrict__ cnt,
                                const float* __restrict__ disp,
                                const uint8_t* __restrict__ outl,
                                const int* __restrict__ up,
                                const int* __restrict__ down,
                                const uint8_t* __restrict__ need,
                                float* __restrict__ disp_out,
                                uint8_t* __restrict__ outl_out, int H, int W,
                                int B, int zd, int reach, int thresh_s,
                                float thresh_h) {
  extern __shared__ int smem[];
  const int C = B + 1;
  const int x = blockIdx.x;
  const int p0 = blockIdx.y * IRV_TILE;
  const int p1 = min(p0 + IRV_TILE, H);
  if (need != nullptr) {
    int any = 0;
    for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
      const size_t i = (size_t)p * W + x;
      any |= (need[i] != 0) & (outl[i] != 0);
    }
    if (!__syncthreads_or(any)) {       // no vote to evaluate: pass through
      for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
        const size_t i = (size_t)p * W + x;
        disp_out[i] = disp[i];
        outl_out[i] = outl[i];
      }
      return;
    }
  }
  const int lo = max(p0 - reach, 0);
  const int hi = min(p1 + reach, H);
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  int* wmax = smem;                                   // IRV_TILE * nw
  int* warg = wmax + IRV_TILE * nw;                   // IRV_TILE * nw
  int* tot = warg + IRV_TILE * nw;                    // IRV_TILE
  int* win_a = tot + IRV_TILE;                        // IRV_TILE window
  int* win_b = win_a + IRV_TILE;                      // ends (prefix rows)
  uint16_t* pre = reinterpret_cast<uint16_t*>(win_b + IRV_TILE);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const size_t i = (size_t)p * W + x;
    const int au = min(max(up[i], 0), reach);
    const int ad = min(max(down[i], 0), reach);
    win_a[p - p0] = max(p - au, 0) - lo;
    win_b[p - p0] = min(p + ad + 1, H) - lo;
  }

  // Prefix counts mod 2^16: a window's sum is at most (2 * reach + 1)^2
  // (row counts <= 2 * reach + 1 over <= 2 * reach + 1 rows; 4761 at
  // usd = 34), below 2^16 for reach <= 127, so the wrapped difference is
  // exact.
  const int c = threadIdx.x;
  if (c < C) {
    uint16_t acc = 0;
    pre[c] = 0;
#pragma unroll 8
    for (int q = lo; q < hi; ++q) {
      acc += cnt[((size_t)q * W + x) * C + c];
      pre[(q - lo + 1) * C + c] = acc;                // read back only by c
    }
  }
  __syncthreads();
  for (int p = p0; p < p1; ++p) {
    const int v = c < C ? (uint16_t)(pre[win_b[p - p0] * C + c] -
                                     pre[win_a[p - p0] * C + c])
                        : 0;
    if (c == B) tot[p - p0] = v;
    const int key = c < B ? v : -1;
    const int m = __reduce_max_sync(0xFFFFFFFFu, key);
    const unsigned hit = __ballot_sync(0xFFFFFFFFu, key == m);
    if ((threadIdx.x & 31) == 0) {
      wmax[(p - p0) * nw + warp] = m;
      warg[(p - p0) * nw + warp] = (warp << 5) + __ffs(hit) - 1;
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < p1 - p0; t += blockDim.x) {
    int best = wmax[t * nw];
    int arg = warg[t * nw];
    for (int w = 1; w < nw; ++w) {
      if (wmax[t * nw + w] > best) {          // strict: the first maximum wins
        best = wmax[t * nw + w];
        arg = warg[t * nw + w];
      }
    }
    const size_t i = (size_t)(p0 + t) * W + x;
    const float d = disp[i];
    const uint8_t o = outl[i];
    const int total = tot[t];
    const int max_d = best > 0 ? arg - zd : (int)d;
    const float ratio = __fdiv_rn((float)(max_d + zd), (float)max(total, 1));
    const bool accept = o != 0 && (need == nullptr || need[i] != 0) &&
                        total > thresh_s && ratio > thresh_h;
    disp_out[i] = accept ? (float)max_d : d;
    outl_out[i] = accept ? 0 : o;
  }
}

static inline int irv_threads(int C) { return (C + 31) / 32 * 32; }

// disp (H, W) f32, outl (H, W) u8, left/right (H, W) i32; cnt (H, W, B + 1)
// u8.  Arms clamp to [0, reach], reach <= 127.  need (H, W) u8 or null;
// with need, live is a (ceil(H / 64), W) u8 scratch and the spans no
// needed vote reads are left unwritten.
STM_API int stm_irv_rowspan(const void* disp, const void* outl,
                            const void* left, const void* right,
                            const void* need, void* live, void* cnt, int H,
                            int W, int B, int zd, int reach, void* stream) {
  const int threads = irv_threads(B + 1);
  if (H <= 0 || W <= 0 || B <= 0 || threads > 1024 || reach < 0 ||
      reach > 127)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * IRV_TILE + 2 * reach) * sizeof(int) +
                      (size_t)(IRV_TILE + 2 * reach + 1) * (B + 1) *
                          sizeof(uint16_t);
  cudaError_t err = stm_smem_cap(irv_rowspan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (need != nullptr) {
    if (live == nullptr) return (int)cudaErrorInvalidValue;
    dim3 lgrid((W + 127) / 128, (H + IRV_TILE - 1) / IRV_TILE);
    irv_live_kernel<<<lgrid, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)need, (const uint8_t*)outl, (uint8_t*)live, H, W);
  }
  dim3 grid((W + IRV_TILE - 1) / IRV_TILE, H);
  irv_rowspan_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)disp, (const uint8_t*)outl, (const int*)left,
      (const int*)right, need != nullptr ? (const uint8_t*)live : nullptr,
      (uint8_t*)cnt, H, W, B, zd, reach);
  return (int)cudaGetLastError();
}

// cnt (H, W, B + 1) u8 from stm_irv_rowspan (called with the same need);
// disp/outl the round's input; up/down (H, W) i32; need (H, W) u8 or null;
// disp_out (H, W) f32, outl_out (H, W) u8.
STM_API int stm_irv_vote(const void* cnt, const void* disp, const void* outl,
                         const void* up, const void* down, const void* need,
                         void* disp_out, void* outl_out, int H, int W, int B,
                         int zd, int reach, int thresh_s, float thresh_h,
                         void* stream) {
  const int threads = irv_threads(B + 1);
  if (H <= 0 || W <= 0 || B <= 0 || threads > 1024 || reach < 0 ||
      reach > 127)
    return (int)cudaErrorInvalidValue;
  const int nw = threads / 32;
  const size_t smem = (size_t)(2 * IRV_TILE * nw + 3 * IRV_TILE) *
                          sizeof(int) +
                      (size_t)(IRV_TILE + 2 * reach + 1) * (B + 1) *
                          sizeof(uint16_t);
  cudaError_t err = stm_smem_cap(irv_vote_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(W, (H + IRV_TILE - 1) / IRV_TILE);
  irv_vote_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)cnt, (const float*)disp, (const uint8_t*)outl,
      (const int*)up, (const int*)down, (const uint8_t*)need,
      (float*)disp_out, (uint8_t*)outl_out, H, W, B, zd, reach, thresh_s,
      thresh_h);
  return (int)cudaGetLastError();
}
