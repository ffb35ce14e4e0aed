// B5: the two vertical passes of the cross aggregation (passes 2 and 3),
// in one launch.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py `_vv_kernel`
// (reached via `_band_pass_vv` from `band_aggregate_q`): pass 2 sums the
// int32 pass-1 volume over [y - UP, y + DOWN) and rescales by s2; pass 3
// does the same to pass 2's result and rescales by s3.  The order of the
// aggregation is H, V, V, H.
//
// Bound on the H100: memory.  The call reads and writes the (H, W, D)
// int32 volume once each: 1.06 GB a call at 1080p/D=128 (~0.63 ms at
// 3.35 TB/s).  The first version of this kernel ran a tiled window sum
// twice with an int32 scratch volume between the launches and read each
// tile with a halo of 2 * reach rows: ~6.5 GB a call.
//
// Design: every (x, d) column is streamed down the frame once, in the
// lane-major layout as it is.  A thread owns one (x, d); a warp covers 32
// consecutive d of one x, so each of its row loads and stores is 128
// contiguous bytes.  The running prefix of the input goes into a ring of
// N = 2 * reach + 2 slots in shared memory (the thread's own column of
// it: no barrier anywhere); pass 2 of row i - reach is a difference of two
// slots, rescaled, and feeds a second running prefix and ring, from which
// pass 3 of row i - 2 * reach is written.  After the last input row the
// stream runs 2 * reach more steps to flush both lags.  The prefixes are
// uint32 and wrap in a long column; a window sum is below 2^31, so the
// wrapped difference is exact.  Rows go in batches of VP_STEP = 8: the
// next batch's loads are issued before the current one is summed (8 rows
// of 4 bytes in flight a thread; no loaded value is used before its batch
// comes up; 8 measured faster than 4 or 16), and lane k of a warp loads
// the arms of row k of the batch
// for the warp's x and hands the window bounds to the other lanes by
// shuffle, so the arms are read once per x and warp, not once per d.  A
// 128-thread block holds 2 * N * 128 * 4 bytes of rings (70 KB at reach
// 34: 3 blocks, 12 warps an SM); D = 64 puts two columns in a block.  The
// same scheme runs the disparity-major B18b (band_dm.cu) on int16 planes.

#include "stm_common.cuh"

#define VP_STEP 8                      // rows of a batch (<= 32)
#define VP_SMEM_MAX (227 * 1024)       // shared memory a block may hold

// Slot of prefix J - back when prefix J sits in slot w of an N-slot ring
// (0 <= back < N).
__device__ __forceinline__ int vp_slot(int w, int back, int N) {
  const int s = w - back;
  return s < 0 ? s + N : s;
}

// The window [max(y - a, 0), min(y + b, H)) of row y as (hi << 16) | lo,
// from its raw arms a (up) and b (down); 0 for a row outside [0, H).
__device__ __forceinline__ unsigned vp_window(int a, int b, int y, int H,
                                              int reach) {
  if (y < 0 || y >= H) return 0u;
  a = min(max(a, 0), reach);
  b = min(max(b, 0), reach);
  return ((unsigned)min(y + b, H) << 16) | (unsigned)max(y - a, 0);
}

// Raw arms of row y (0 outside [0, H)).
__device__ __forceinline__ void vp_arms(const int* __restrict__ up,
                                        const int* __restrict__ down, int y,
                                        int H, int W, int& a, int& b) {
  a = b = 0;
  if (y >= 0 && y < H) {
    a = up[(size_t)y * W];
    b = down[(size_t)y * W];
  }
}

// Loads of the batch that starts at input row i0: the thread's input
// values, and in lane k the raw arms of pass 2's row i0 + k - reach and
// pass 3's row i0 + k - 2 * reach.  Nothing here uses a loaded value, so
// the loads stay in flight while the previous batch is summed.
__device__ __forceinline__ void vp_load(const int32_t* __restrict__ src,
                                        size_t row, const int* up,
                                        const int* down, bool live, int i0,
                                        int lane, int H, int W, int reach,
                                        int (&v)[VP_STEP], int (&arm)[4]) {
#pragma unroll
  for (int k = 0; k < VP_STEP; ++k)
    v[k] = live && i0 + k < H ? src[(size_t)(i0 + k) * row] : 0;
  arm[0] = arm[1] = arm[2] = arm[3] = 0;
  if (lane < VP_STEP) {
    vp_arms(up, down, i0 + lane - reach, H, W, arm[0], arm[1]);
    vp_arms(up, down, i0 + lane - 2 * reach, H, W, arm[2], arm[3]);
  }
}

// in, out: (H, W, D) i32; up/down (H, W) i32.  Block: TD threads over d
// (a multiple of 32) for each of blockDim.x / TD columns.
__global__ void __launch_bounds__(128)
vpass_kernel(const int32_t* __restrict__ in, const int* __restrict__ up,
             const int* __restrict__ down, int32_t* __restrict__ out, int H,
             int W, int D, int reach, int N, int TD, int s2, int s3) {
  extern __shared__ uint32_t rings[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int x = blockIdx.x * (T / TD) + t / TD;
  const int d = blockIdx.y * TD + t % TD;
  if (x >= W) return;                  // a whole warp: no barrier below
  const bool live = d < D;
  const int lane = t & 31;
  const size_t row = (size_t)W * D;
  const int32_t* src = in + (size_t)x * D + d;
  int32_t* dst = out + (size_t)x * D + d;
  const int* upx = up + x;
  const int* downx = down + x;
  // slot s of this thread's rings: ring1[s * T], ring2[s * T]
  uint32_t* ring1 = rings + t;
  uint32_t* ring2 = ring1 + (size_t)N * T;
  const int half2 = s2 > 0 ? 1 << (s2 - 1) : 0;
  const int half3 = s3 > 0 ? 1 << (s3 - 1) : 0;

  // P1[j] = sum of the input rows before j, P2[j] likewise of pass 2's
  // rows; P[0] = 0 sits in slot 0, and w1/w2 are the slots of the newest.
  ring1[0] = 0u;
  ring2[0] = 0u;
  uint32_t p1 = 0u, p2 = 0u;
  int w1 = 0, w2 = 0;
  const int steps = H + 2 * reach;
  int vnext[VP_STEP], anext[4];
  vp_load(src, row, upx, downx, live, 0, lane, H, W, reach, vnext, anext);
  for (int i0 = 0; i0 < steps; i0 += VP_STEP) {
    int v[VP_STEP];
#pragma unroll
    for (int k = 0; k < VP_STEP; ++k) v[k] = vnext[k];
    // lane k: the windows of pass 2's and pass 3's row k of this batch
    const unsigned c2 = vp_window(anext[0], anext[1], i0 + lane - reach, H,
                                  reach);
    const unsigned c3 = vp_window(anext[2], anext[3],
                                  i0 + lane - 2 * reach, H, reach);
    if (i0 + VP_STEP < steps)
      vp_load(src, row, upx, downx, live, i0 + VP_STEP, lane, H, W, reach,
              vnext, anext);
#pragma unroll
    for (int k = 0; k < VP_STEP; ++k) {
      const int i = i0 + k, y2 = i - reach, y3 = i - 2 * reach;
      const unsigned win2 = __shfl_sync(0xFFFFFFFFu, c2, k);
      const unsigned win3 = __shfl_sync(0xFFFFFFFFu, c3, k);
      if (i < H) {                                   // P1[i + 1]
        p1 += (uint32_t)v[k];
        w1 = w1 + 1 == N ? 0 : w1 + 1;
        ring1[w1 * T] = p1;
      }
      if (y2 >= 0 && y2 < H) {                       // pass 2 of row y2
        const int j1 = min(i + 1, H);                // newest P1
        const uint32_t s =
            ring1[vp_slot(w1, j1 - (int)(win2 >> 16), N) * T] -
            ring1[vp_slot(w1, j1 - (int)(win2 & 0xFFFFu), N) * T];
        p2 += (uint32_t)(((int32_t)s + half2) >> s2);
        w2 = w2 + 1 == N ? 0 : w2 + 1;
        ring2[w2 * T] = p2;                          // P2[y2 + 1]
      }
      if (y3 >= 0 && y3 < H) {                       // pass 3 of row y3
        const int j2 = min(y2 + 1, H);               // newest P2
        const uint32_t s =
            ring2[vp_slot(w2, j2 - (int)(win3 >> 16), N) * T] -
            ring2[vp_slot(w2, j2 - (int)(win3 & 0xFFFFu), N) * T];
        if (live) dst[(size_t)y3 * row] = ((int32_t)s + half3) >> s3;
      }
    }
  }
}

// in, out: (H, W, D) i32 contiguous (values >= 0); up/down (H, W) i32.
STM_API int stm_vv_pass(const void* in, const void* up, const void* down,
                        void* out, int H, int W, int D, int reach, int s2,
                        int s3, void* stream) {
  if (H <= 0 || H > 65535 || W <= 0 || D <= 0 || D > 1024 || reach < 0 ||
      s2 < 0 || s2 > 30 || s3 < 0 || s3 > 30)
    return (int)cudaErrorInvalidValue;
  const int N = 2 * reach + 2;
  const size_t per_thread = 2 * (size_t)N * sizeof(uint32_t);
  int T = 128;
  while (T > 32 && T * per_thread > VP_SMEM_MAX) T /= 2;
  if (T * per_thread > VP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int TD = min((D + 31) / 32 * 32, T);
  const int threads = TD * (T / TD);
  const size_t smem = threads * per_thread;
  cudaError_t err = stm_smem_cap(vpass_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + T / TD - 1) / (T / TD), (D + TD - 1) / TD);
  vpass_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in, (const int*)up, (const int*)down, (int32_t*)out,
      H, W, D, reach, N, TD, s2, s3);
  return (int)cudaGetLastError();
}
