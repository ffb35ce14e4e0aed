// G1: the feather of the view merge's blend weight, out = max(a,
// blur(a) * post) with a = 1 - mask_r: the lifting Gaussian
// `filter_gaussian_lift(op_invertnormf(mask_r), r, sigma)`.
//
// Replaces the JAX package's XLA glue stereo_to_multiview_tpu/ops/
// filters.py:35 `filter_gaussian_lift` (no Pallas body: on the TPU it is
// 2 x (2r + 1) fused elementwise passes over an edge-padded plane), which
// the port ran as ~90 torch launches on an (H + 2r) x W float32 plane.
//
// The JAX order, to the last bit: the x pass over the 2r extra rows of
// the clamp-to-edge padded plane, acc = acc + k[j] * p from 0.0 in
// ascending tap order, then the y pass the same way over the x pass's
// rows, then acc * post, then the max with a.  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn): nvcc would contract them.
// A padded row is its clamped source row, so the x pass of padded row i
// is the x pass of row clamp(i - r), and every index clamps to the plane:
// any plane size works, also one narrower or shorter than 2r + 1.
//
// Bound on the H100: one plane read and one written (16.6 MB at 1080p,
// ~0.005 ms), or the 2 x (2r + 1) taps' two float32 operations a pixel
// at the rate without contraction (r = 10: 84 a pixel, ~0.005 ms).
// Design: one launch up to r = FEATHER_RMAX (the presets' 10); a block
// takes a tile of 64 x 64 outputs (one wave of blocks at 1080p), stages
// 1 - m of the tile and its halo of r in shared memory (clamped
// indices), runs the x pass over the tile's 64 + 2r rows into shared
// memory and the y pass from there, four rows a thread (each loaded x
// sum feeds four sums), and stores coalesced rows.  The taps are kernel
// parameters read in loops unrolled to 2 FEATHER_RMAX + 1 taps, so they
// cost no load.  Above FEATHER_RMAX the same two passes run as two
// launches through a scratch plane of x sums.  Masks are finite (B11
// gives 0 or 1), so fmaxf is torch.maximum.

#include "stm_common.cuh"

#define FEATHER_THREADS 256
#define FEATHER_TX 64                 // output columns a block, a thread each
#define FEATHER_TY 64                 // output rows a block
#define FEATHER_RY (FEATHER_THREADS / FEATHER_TX)
#define FEATHER_RMAX 10
#define FEATHER_NK (2 * FEATHER_RMAX + 1)   // taps a launch at most

struct FeatherTaps {
  float k[FEATHER_NK];
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// Four consecutive sums of one pass, out[q] = sum_j k[j] * v[(q + j) *
// stride] from 0.0 in ascending j: output q adds k[t - q] * v[t] for t
// ascending, so each loaded value feeds four sums.
__device__ __forceinline__ void taps4(const float (&k)[FEATHER_NK],
                                      const float* v, int stride, int n,
                                      float (&a)[4]) {
  a[0] = a[1] = a[2] = a[3] = 0.0f;
#pragma unroll
  for (int t = 0; t < FEATHER_NK + 3; ++t) {
    if (t < n + 3) {
      const float x = v[t * stride];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = t - q;
        if (j >= 0 && j < n && j < FEATHER_NK)
          a[q] = __fadd_rn(a[q], __fmul_rn(k[j >= 0 ? j : 0], x));
      }
    }
  }
}

// One sum of the x pass, sum_j k[j] * p[j] from 0.0 in ascending j.
__device__ __forceinline__ float taps1(const float (&k)[FEATHER_NK],
                                       const float* p, int n) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < FEATHER_NK; ++j)
    if (j < n) acc = __fadd_rn(acc, __fmul_rn(k[j], p[j]));
  return acc;
}

__global__ void __launch_bounds__(FEATHER_THREADS)
feather_kernel(const float* __restrict__ mask, FeatherTaps taps, float post,
               float* __restrict__ out, int H, int W, int r) {
  extern __shared__ float sm[];
  const int n = 2 * r + 1;
  const int rows = FEATHER_TY + 2 * r;   // padded rows of the x pass
  const int cols = FEATHER_TX + 2 * r;   // staged input columns
  float* in = sm;                        // rows x cols: 1 - m
  float* xs = in + rows * cols;          // rows x FEATHER_TX: x sums
  const int tx = threadIdx.x % FEATHER_TX, ty = threadIdx.x / FEATHER_TX;
  const int x0 = blockIdx.x * FEATHER_TX, y0 = blockIdx.y * FEATHER_TY;
  // several rows' loads in flight a thread (a tile's rows are 84 at r = 10)
#pragma unroll 4
  for (int ry = ty; ry < rows; ry += FEATHER_RY) {
    const float* src = mask + (size_t)clampi(y0 + ry - r, H - 1) * W;
    for (int rx = tx; rx < cols; rx += FEATHER_TX)
      in[ry * cols + rx] = __fsub_rn(1.0f, src[clampi(x0 + rx - r, W - 1)]);
  }
  __syncthreads();
  float k[FEATHER_NK];
#pragma unroll
  for (int j = 0; j < FEATHER_NK; ++j) k[j] = taps.k[j];
#pragma unroll 2
  for (int ry = ty; ry < rows; ry += FEATHER_RY)
    xs[ry * FEATHER_TX + tx] = taps1(k, in + ry * cols + tx, n);
  __syncthreads();
  const int x = x0 + tx;
  // thread row ty takes output rows ty * 16 .. ty * 16 + 15, four at a time
  for (int g = ty * (FEATHER_TY / FEATHER_RY);
       g < (ty + 1) * (FEATHER_TY / FEATHER_RY); g += 4) {
    float acc[4];
    taps4(k, xs + g * FEATHER_TX + tx, FEATHER_TX, n, acc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int y = y0 + g + u;
      if (y < H && x < W)
        out[(size_t)y * W + x] =
            fmaxf(in[(g + u + r) * cols + tx + r], __fmul_rn(acc[u], post));
    }
  }
}

// The two passes of a radius above FEATHER_RMAX: one thread a pixel, the
// x sums of every source row through `xs` (H, W), the taps from device
// memory.
__global__ void __launch_bounds__(FEATHER_THREADS)
feather_xpass_kernel(const float* __restrict__ mask,
                     const float* __restrict__ taps, float* __restrict__ xs,
                     int H, int W, int r) {
  const int x = blockIdx.x * FEATHER_THREADS + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const float* row = mask + (size_t)y * W;
  float acc = 0.0f;
  for (int j = 0; j <= 2 * r; ++j)
    acc = __fadd_rn(acc, __fmul_rn(taps[j], __fsub_rn(
                                                1.0f, row[clampi(x + j - r,
                                                                 W - 1)])));
  xs[(size_t)y * W + x] = acc;
}

__global__ void __launch_bounds__(FEATHER_THREADS)
feather_ypass_kernel(const float* __restrict__ mask,
                     const float* __restrict__ taps,
                     const float* __restrict__ xs, float post,
                     float* __restrict__ out, int H, int W, int r) {
  const int x = blockIdx.x * FEATHER_THREADS + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  float acc = 0.0f;
  for (int j = 0; j <= 2 * r; ++j)
    acc = __fadd_rn(acc, __fmul_rn(taps[j],
                                   xs[(size_t)clampi(y + j - r, H - 1) * W +
                                      x]));
  const size_t i = (size_t)y * W + x;
  out[i] = fmaxf(__fsub_rn(1.0f, mask[i]), __fmul_rn(acc, post));
}

static int launch_tile(const float* mask, const float* taps, float post,
                       float* out, int H, int W, int r, cudaStream_t s) {
  FeatherTaps t = {};
  for (int j = 0; j <= 2 * r; ++j) t.k[j] = taps[j];
  const size_t smem = sizeof(float) * (size_t)(FEATHER_TY + 2 * r) *
                      (FEATHER_TX + 2 * r + FEATHER_TX);
  cudaError_t err = stm_smem_cap(feather_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + FEATHER_TX - 1) / FEATHER_TX,
            (H + FEATHER_TY - 1) / FEATHER_TY);
  feather_kernel<<<grid, FEATHER_THREADS, smem, s>>>(mask, t, post, out, H,
                                                     W, r);
  return (int)cudaGetLastError();
}

// The largest radius that one launch takes; above it the entry needs an
// (H, W) float32 scratch plane and the taps in device memory.
STM_API int stm_feather_rmax() { return FEATHER_RMAX; }

// mask, out: (H, W) f32; taps: the 2r + 1 f32 taps in host memory (copied
// into the kernel's parameters) and, where r > FEATHER_RMAX, `dev_taps`,
// the same in device memory, and `scratch`, an (H, W) f32 plane; post:
// f32(scale / k2d_sum).
STM_API int stm_feather(const void* mask, const float* taps,
                        const void* dev_taps, void* scratch, void* out, int H,
                        int W, int r, float post, void* stream) {
  if (H <= 0 || W <= 0 || r < 0 || taps == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= FEATHER_RMAX)
    return launch_tile((const float*)mask, taps, post, (float*)out, H, W, r,
                       s);
  if (scratch == nullptr || dev_taps == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + FEATHER_THREADS - 1) / FEATHER_THREADS, H);
  feather_xpass_kernel<<<grid, FEATHER_THREADS, 0, s>>>(
      (const float*)mask, (const float*)dev_taps, (float*)scratch, H, W, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  feather_ypass_kernel<<<grid, FEATHER_THREADS, 0, s>>>(
      (const float*)mask, (const float*)dev_taps, (const float*)scratch, post,
      (float*)out, H, W, r);
  return (int)cudaGetLastError();
}
