// B18b: passes 2 and 3 of the cross aggregation in the disparity-major
// (2D, H, W) int16 layout, both eyes in one launch (left eye on planes
// [0, D), right eye on [D, 2D)).
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py
// `_vv_dm_kernel` (reached via `band_aggregate_q_dm` and
// `band_stereo_core_dm`): two sums over [y - UP, y + DOWN), each rescaled
// by floor(v * 2^-s + 0.5) = (v + 2^(s-1)) >> s and stored as int16, the
// second on the first's result.  Windows are half-open and clipped to the
// image; arms are clamped to [0, reach].  The TPU kernel multiplies bf16
// digit planes with 0/1 band matrices on a (2D, W, H) transpose; here
// the integers are prefix-sum differences in the layout as it is.
//
// Bound on the H100: bytes.  1080p/D=128, both eyes: the call reads and
// writes 1.06 GB each (~0.63 ms at 3.35 TB/s) and the arms of both eyes.
//
// Every (column, plane) is streamed down the frame once, in batches of
// S = VDM_S = 8 rows.  Its running prefix P1 goes into a ring of
// N = 2 * reach + S + 1 u32 slots in shared memory, P1[j] in slot j % N;
// pass 2 of row i - reach is a difference of two slots, is
// rescaled and feeds a second running prefix P2 and ring, from which pass
// 3 of row i - 2 * reach is stored; 2 * reach more steps after the last
// row flush both lags.  The prefixes wrap in a long column; a window sum
// is below 2^31, so the wrapped difference is exact.
//
// The first version (a thread a column of one plane, 4 planes a block,
// one row at a time) held 4 rows in flight and read four int32 arms for
// each element: 3.79 ms a 1080p call.  This one:
//  - takes each pass of a batch in turn (P1 of its S input rows, then
//    pass 2 of S rows, then pass 3), so that the S rows' shared-memory
//    reads are independent and in flight together (the rings hold S - 1
//    more slots for it), and runs the batches whose every step has a row
//    in each pass, in warps whose columns all lie in the image, without a
//    single test;
//  - shares the window bounds: a block is P warps, P planes of one eye on
//    the same 32 columns (a lane a column), and each (row, column)'s
//    window is computed once for all of them, a batch ahead, as the byte
//    offsets in a ring of the slots of P[lo] and P[hi] (the same slots in
//    both rings), into a ring of window rows (a power of two of them)
//    that pass 2 reads at its row and pass 3 reach rows later; one
//    barrier a batch publishes them;
//  - stages the volume 56 rows ahead (this warp's 64-byte row segments)
//    and the arms 16 rows ahead with cp.async, one group a batch, where
//    rows are 16-byte aligned (W % 8 == 0); else each thread loads its
//    elements a batch at a time;
//  - chooses P at launch for the most resident warps an SM (at reach 34,
//    two blocks of four: the rings take 19.7 KB a warp).
// On the card, one column a lane ran faster than two (one 128-byte line a
// warp row, as B5 moves), and batches of 8 rows faster than 16.  What
// bounds it now is not identified (no stall profiler runs on the card
// here): staging deeper, fewer instructions a step, another block order
// and dropping the barrier each left its time as it was; the suspect is
// the rate of its ~50 integer instructions an element (half the float
// rate) at the 8 warps an SM that the rings allow.

#include <type_traits>

#include "stm_common.cuh"

#define VDM_PMAX 6       // warps (planes) a block at most
#define VDM_VROWS 64     // rows of the volume staged a warp (S fewer
                         // ahead of the batch summed)
#define VDM_ASTAGES 4    // batches of arms staged (2 ahead)
#define VDM_S 8          // rows a batch

// in, out: (2D, H, W) i16; up/down arms of each eye (H, W) i32.  Block
// (32, P): plane group blockIdx.x (`groups` a eye, eye-major), columns
// [32 * blockIdx.y, + 32), one a lane.  Shared memory: P * 2 rings of N
// slots x 32 u32 (N = 2 * reach + S + 1), WN window rows x 32 u32 (WN >=
// reach + 2 * S, a power of two), VDM_ASTAGES x S rows x 2 arms x 32 i32,
// and each warp's VDM_VROWS rows x 32 i16 of the volume.  `async`: rows
// of 16-byte aligned chunks (W % 8 == 0, aligned bases) copied with
// cp.async; else each thread loads and stores its elements.
__global__ void __launch_bounds__(32 * VDM_PMAX)
vvdm_kernel(const int16_t* __restrict__ in, const int* __restrict__ up_l,
            const int* __restrict__ down_l, const int* __restrict__ up_r,
            const int* __restrict__ down_r, int16_t* __restrict__ out, int H,
            int W, int D, int reach, int N, int WN, int groups, int s2,
            int s3, int async) {
  constexpr int VST = VDM_VROWS / VDM_S;  // batches of the volume staged
  extern __shared__ uint32_t smem[];
  const int P = blockDim.y;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int eye = blockIdx.x / groups;
  const int plane = (blockIdx.x - eye * groups) * P + warp;   // in the eye
  const bool live_p = plane < D;
  const int xs = blockIdx.y * 32;              // the block's columns
  const int x = xs + lane;                     // this lane's column
  const bool live = x < W;
  const int* up = eye ? up_r : up_l;
  const int* down = eye ? down_r : down_l;
  const size_t plane_sz = (size_t)H * W;
  const int16_t* src = in + (size_t)(eye * D + (live_p ? plane : 0)) *
                                plane_sz + xs;
  int16_t* dst = out + (size_t)(eye * D + (live_p ? plane : 0)) * plane_sz +
                 x;
  // ring slot s of this lane: ring[s * 32]
  uint32_t* ring1 = smem + (size_t)(warp * 2) * N * 32 + lane;
  uint32_t* ring2 = ring1 + (size_t)N * 32;
  // window row r of this lane's column: wring[r * 32], the byte offsets
  // in a ring of the slots of P[lo] (low half) and P[hi] (high half)
  uint32_t* wring = smem + (size_t)P * 2 * N * 32 + lane;
  const int wmask = WN - 1;                    // WN is a power of two
  // arms of row r of a batch in stage t: astage[((t * S + r) * 2 + a) * 32
  // + column], a = 0 up, 1 down
  int* astage = reinterpret_cast<int*>(smem + (size_t)P * 2 * N * 32 +
                                       (size_t)WN * 32);
  // this warp's volume rows: vstage[(t * S + k) * 32 + column]
  int16_t* vstage = reinterpret_cast<int16_t*>(
                        astage + VDM_ASTAGES * VDM_S * 2 * 32) +
                    (size_t)warp * VDM_VROWS * 32;
  const int half2 = s2 > 0 ? 1 << (s2 - 1) : 0;
  const int half3 = s3 > 0 ? 1 << (s3 - 1) : 0;
  const int steps = H + 2 * reach;
  const int batches = (steps + VDM_S - 1) / VDM_S;

  // One cp.async group for step g of the pipeline: this warp's volume rows
  // of batch b = g + VST - 1, [b * S, + S), into volume stage b % VST, and
  // the arms of the window rows of batch a = g +
  // VDM_ASTAGES - 1, [a * S - reach, + S), into arm stage a % VDM_ASTAGES
  // (nothing of a batch below 0 or past the last).
  auto stage_batch = [&](int g) {
    const int b = g + VST - 1;
    if (b >= 0 && b < batches) {
      int16_t* vs = vstage + (b % VST) * VDM_S * 32;
      if (async) {
        // 4 chunks of 16 bytes a row
#pragma unroll
        for (int k = 0; k < VDM_S / 8; ++k) {
          const int q = lane + 32 * k;
          const int i = b * VDM_S + q / 4, cx = 8 * (q % 4);
          if (live_p && i < H && xs + cx < W)
            stm_cp16(vs + (q / 4) * 32 + cx, src + (size_t)i * W + cx);
        }
      } else {
        int16_t v[VDM_S];              // all S loads in flight together
#pragma unroll
        for (int k = 0; k < VDM_S; ++k) {
          const int i = b * VDM_S + k;
          v[k] = live_p && i < H && live ? src[(size_t)i * W + lane] : 0;
        }
#pragma unroll
        for (int k = 0; k < VDM_S; ++k) vs[k * 32 + lane] = v[k];
      }
    }
    const int ab = g + VDM_ASTAGES - 1;
    if (ab >= 0 && ab < batches) {
      const int b = ab;
      int* as = astage + (b % VDM_ASTAGES) * VDM_S * 2 * 32;
      if (async) {
        // 8 chunks a row and arm (P >= 2: at most S / 4 a thread)
#pragma unroll
        for (int k = 0; k < VDM_S / 4; ++k) {
          const int q = tid + 32 * P * k;
          if (q >= VDM_S * 16) break;
          const int r = q / 16, a = (q / 8) % 2, cx = 4 * (q % 8);
          const int y = b * VDM_S + r - reach;
          if (y >= 0 && y < H && xs + cx < W)
            stm_cp16(as + (r * 2 + a) * 32 + cx,
                     (a ? down : up) + (size_t)y * W + xs + cx);
        }
      } else {
        int a[VDM_S / 2][2];
#pragma unroll
        for (int k = 0; k < VDM_S / 2; ++k) {
          const int r = warp + k * P;
          const int y = b * VDM_S + r - reach;
          const bool in = r < VDM_S && y >= 0 && y < H && live;
          a[k][0] = in ? up[(size_t)y * W + x] : 0;
          a[k][1] = in ? down[(size_t)y * W + x] : 0;
        }
#pragma unroll
        for (int k = 0; k < VDM_S / 2; ++k) {
          const int r = warp + k * P;
          if (r < VDM_S) {
            as[(r * 2) * 32 + lane] = a[k][0];
            as[(r * 2 + 1) * 32 + lane] = a[k][1];
          }
        }
      }
    }
    stm_cp_commit();
  };
  // The windows of batch b's rows into the window ring (row r of batch b
  // in row (b * S + r) % WN), each thread rows r = warp + k * P < S of its
  // column (P >= 2: at most S / 2).  ym: (b * S - reach) % N, advanced by
  // S a call (S < N).
  int ym = N - reach;
  auto put_windows = [&](int b) {
    const int* as = astage + (b % VDM_ASTAGES) * VDM_S * 2 * 32 + lane;
#pragma unroll
    for (int k = 0; k < VDM_S / 2; ++k) {
      const int r = warp + k * P;
      const int y = b * VDM_S + r - reach;
      if (r < VDM_S && y >= 0 && y < H) {
        const int yr = ym + r >= N ? ym + r - N : ym + r;   // y % N
        const int a = min(min(max(as[(r * 2) * 32], 0), reach), y);
        const int bb = min(min(max(as[(r * 2 + 1) * 32], 0), reach), H - y);
        const int lo = yr - a < 0 ? yr - a + N : yr - a;
        const int hi = yr + bb >= N ? yr + bb - N : yr + bb;
        wring[((b * VDM_S + r) & wmask) * 32] =
            (uint32_t)(lo * 128) | (uint32_t)(hi * 128) << 16;
      }
    }
    ym = ym + VDM_S >= N ? ym + VDM_S - N : ym + VDM_S;
  };

  // the window ring starts as slot 0 everywhere, so that a step whose
  // row lies outside the image reads valid slots (its result is unused)
  for (int r = warp; r < WN; r += P) wring[r * 32] = 0u;
  ring1[0] = ring2[0] = 0u;    // P1[0] = P2[0] = 0 in slot 0
  uint32_t p1 = 0u, p2 = 0u;
  // byte offsets in a ring of the newest P1 and P2's slots
  const int n128 = N * 128;
  int w1 = 0, w2 = 0;
  const char* r1 = reinterpret_cast<const char*>(ring1);
  const char* r2 = reinterpret_cast<const char*>(ring2);
  for (int g = 1 - VST; g < 0; ++g) stage_batch(g);
  stm_cp_wait<1>();            // the volume of batch 0, the arms of 0, 1
  __syncthreads();
  put_windows(0);
  __syncthreads();

  // A warp whose 32 columns all lie in the image runs the batches whose S
  // steps all have a row in each pass without a single test (`fast`).
  const bool whole = live_p && xs + 32 <= W;
  for (int b = 0; b < batches; ++b) {
    const int i0 = b * VDM_S;
    stage_batch(b);
    if (b + 1 < batches) put_windows(b + 1);
    const int16_t* vs = vstage + (b % VST) * VDM_S * 32 + lane;
    // Each pass of the batch in turn, so that its S rows' shared-memory
    // reads are independent and in flight together: P1 of the S input
    // rows, pass 2 of rows i0 - reach + k, pass 3 of rows i0 - 2 reach
    // + k.  The rings hold 2 * reach + S + 1 slots for it.
    auto batch = [&](auto fast_tag) {
      constexpr bool fast = decltype(fast_tag)::value;
#pragma unroll
      for (int k = 0; k < VDM_S; ++k) {
        if (fast || i0 + k < H) {                  // P1[i0 + k + 1]
          w1 = w1 + 128 == n128 ? 0 : w1 + 128;
          p1 += (uint32_t)(int)vs[k * 32];
          *reinterpret_cast<uint32_t*>((char*)ring1 + w1) = p1;
        }
      }
      uint32_t sum[VDM_S];             // the batch's window sums
#pragma unroll
      for (int k = 0; k < VDM_S; ++k) {
        const uint32_t win = wring[((i0 + k) & wmask) * 32];
        sum[k] = *reinterpret_cast<const uint32_t*>(r1 + (win >> 16)) -
                 *reinterpret_cast<const uint32_t*>(r1 + (win & 0xFFFFu));
      }
#pragma unroll
      for (int k = 0; k < VDM_S; ++k) {
        const int y2 = i0 + k - reach;
        if (fast || (y2 >= 0 && y2 < H)) {         // P2[y2 + 1]
          w2 = w2 + 128 == n128 ? 0 : w2 + 128;
          p2 += (uint32_t)(int)(int16_t)(((int)sum[k] + half2) >> s2);
          *reinterpret_cast<uint32_t*>((char*)ring2 + w2) = p2;
        }
      }
#pragma unroll
      for (int k = 0; k < VDM_S; ++k) {
        const uint32_t win = wring[((i0 + k - reach) & wmask) * 32];
        sum[k] = *reinterpret_cast<const uint32_t*>(r2 + (win >> 16)) -
                 *reinterpret_cast<const uint32_t*>(r2 + (win & 0xFFFFu));
      }
      if (fast || (live_p && live)) {
#pragma unroll
        for (int k = 0; k < VDM_S; ++k) {
          const int y3 = i0 + k - 2 * reach;
          if (fast || (y3 >= 0 && y3 < H))         // pass 3 of row y3
            dst[(size_t)y3 * W] = (int16_t)(((int)sum[k] + half3) >> s3);
        }
      }
    };
    if (whole && i0 >= 2 * reach && i0 + VDM_S <= H)
      batch(std::true_type());
    else
      batch(std::false_type());
    stm_cp_wait<1>();          // the volume of batch b + 1, arms of b + 2
    __syncthreads();
  }
}

static size_t vdm_smem(int P, int N, int WN) {
  return ((size_t)P * 2 * N * 32 + (size_t)WN * 32 +
          (size_t)VDM_ASTAGES * VDM_S * 2 * 32) * 4 +
         (size_t)P * VDM_VROWS * 32 * 2;
}

// The block height (warps, planes) with the most resident warps an SM for
// this ring size (of the heights with as many warps, the one with more
// blocks an SM: fewer warps meet at each barrier), and its shared memory;
// 0 if not even two fit.
static int vdm_planes(int N, int WN, size_t* smem) {
  int best = 0, best_warps = 0, best_blocks = 0;
  for (int P = 2; P <= VDM_PMAX; ++P) {
    const size_t bytes = vdm_smem(P, N, WN);
    if (bytes > 227 * 1024) break;
    if (stm_smem_cap(vvdm_kernel, bytes) != cudaSuccess) break;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, vvdm_kernel, 32 * P, bytes) != cudaSuccess)
      break;
    if (blocks * P > best_warps ||
        (blocks * P == best_warps && blocks > best_blocks)) {
      best = P;
      best_warps = blocks * P;
      best_blocks = blocks;
      *smem = bytes;
    }
  }
  return best;
}

// Passes 2 + 3 (B18b): in, out (2D, H, W) i16 (values >= 0); up/down arms
// of each eye (H, W) i32.
STM_API int stm_vv_dm(const void* in, const void* up_l, const void* down_l,
                      const void* up_r, const void* down_r, void* out, int H,
                      int W, int D, int reach, int s2, int s3, void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || reach < 0 || reach > 64 || s2 < 0 ||
      s2 > 30 || s3 < 0 || s3 > 30 || (W + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const int N = 2 * reach + VDM_S + 1;
  int WN = 32;                 // a power of two >= reach + 2 * S
  while (WN < reach + 2 * VDM_S) WN *= 2;
  // the chosen height for each ring size, found once
  static int planes[256];
  static size_t smems[256];
  if (planes[N] == 0) {
    size_t smem = 0;
    const int P = vdm_planes(N, WN, &smem);
    if (P == 0) return (int)cudaErrorInvalidValue;
    smems[N] = smem;
    planes[N] = P;
  }
  const int P = planes[N];
  const size_t smem = smems[N];
  cudaError_t err = stm_smem_cap(vvdm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (D + P - 1) / P;
  const uintptr_t bases = (uintptr_t)in | (uintptr_t)up_l | (uintptr_t)down_l |
                          (uintptr_t)up_r | (uintptr_t)down_r;
  const int async = W % 8 == 0 && bases % 16 == 0;
  dim3 grid(2 * groups, (W + 31) / 32);
  dim3 block(32, P);
  vvdm_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int16_t*)in, (const int*)up_l, (const int*)down_l,
      (const int*)up_r, (const int*)down_r, (int16_t*)out, H, W, D, reach, N,
      WN, groups, s2, s3, async);
  return (int)cudaGetLastError();
}
