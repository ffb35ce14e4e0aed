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
// N >= 2 * reach + 2 slots in shared memory (the thread's own column of
// it); pass 2 of row i - reach is a difference of two slots, rescaled,
// and feeds a second running prefix and ring, from which pass 3 of row
// i - 2 * reach is written.  After the last input row the stream runs
// 2 * reach + 1 more steps to flush both lags.  The prefixes are uint32
// and wrap in a long column; a window sum is below 2^31, so the wrapped
// difference is exact.  A 128-thread block holds 2 * N * 128 * 4 bytes
// of rings (80 KB at reach 34); D = 64 puts two columns in a block.
//
// The stream (`vp_rows`).  A step loads the slots that the next step
// sums (a value is used a step after its load), and both rings are
// written at slot i % N in step i (prefix j of ring1 in slot (j - 1) % N,
// of ring2 in slot (j - 1 + reach) % N), so a batch of rows writes
// consecutive slots when N is a multiple of its length; a batch whose
// rows all lie in the frame tests nothing.  The windows' slots come as
// byte offsets.  This took the stream's own time (no input read, no
// output written) from 1.05 to 0.70 ms a 1080p call.
//
// What feeds the stream (the staged path).  Rows loaded into registers,
// one batch of 8 rows of 4 bytes a thread ahead, at 3 blocks an SM, keep
// ~12 KB of reads in flight an SM (the register path; with a stream of
// twice the instructions that design took 1.24 ms a 1080p call, 52% of
// the bound).  Here the tensor memory accelerator copies each
// block's span of VP_ROWS = 16 input rows (its columns' D values, 512
// bytes a row at D = 128 or 64: a box of a tensor map over the volume)
// into one of K stages of shared memory, completing on the stage's
// mbarrier; no register holds a copy in flight.  One more warp, the
// producer, issues the copies, K batches ahead, and refills a stage once
// every stream warp has taken its words of it into registers and arrived
// on the stage's second mbarrier; it also loads the arms and writes the
// ring slots of each row's window into a slot ring per column, which the
// stream threads read (no arms load, shuffle or division in the stream).
// K: as many stages (at most 8) as fit beside the rings, the barriers and
// the slot rings in half an SM's shared memory (two blocks an SM; K = 3
// at reach 34), else in a whole block's, and as the slot ring's 256 rows
// allow (`vp_plan`).  Measured on the H100 (1080p call): 0.95 ms, 67% of
// the bound (3 to 5 stages alike); without the output stores 0.73 ms.
// Not kept: one 512-byte bulk copy a row issued by thread 0 behind a block
// barrier (1.81 ms with that longer stream); the output rows leaving
// through shared memory by tensor copies (no faster than the stores, and
// a partly out-of-frame box's store faulted); two columns a block (no
// change).  Where D % 4 != 0 or the volume's base is not 16-byte aligned
// (no tensor copy of its rows) or a slot ring or two stages do not fit
// (reach > 88), the register path runs: batches of VP_STEP = 8 rows
// loaded into registers a batch ahead, 3 blocks an SM, each warp's lane k
// loading the arms of its batch's row k and handing the slots to the
// other lanes by shuffle (1.15 ms at 1080p).  Both paths run `vp_rows`,
// so their outputs are equal bit for bit.  The disparity-major B18b
// (vvdm.cu) streams int16 planes by register batches of its own.

#include <cuda.h>                      // CUtensorMap (no driver call)

#include "stm_common.cuh"

#define VP_STEP 8                      // rows of a register batch (<= 32)
#define VP_ROWS 16                     // rows of a stage (<= 32)
#define VP_KMAX 8                      // stages at most
#define VP_BARS 128                    // bytes after the rings: 2K mbarriers
#define VP_SLOTS 256                   // rows of a column's slot ring
#define VP_SMEM_MAX (227 * 1024)       // shared memory a block may hold
#define VP_SMEM_SM (228 * 1024)        // shared memory of an SM
#define VP_BLOCK_RESERVED 1024         // of it held back for each block

// Prefix j of pass 1's input (P1[j]) sits in slot (j - 1) % N of ring1,
// prefix j of pass 2's rows (P2[j]) in slot (j - 1 + reach) % N of ring2:
// step i writes both into slot i % N (P1[i + 1], P2[i - reach + 1]), so a
// batch of rows, N being a multiple of its length, writes consecutive
// slots.  N >= 2 * reach + 2 (every prefix a window of a step can reach).
__device__ __forceinline__ unsigned vp_slot1(int j, int N) {
  return (unsigned)(j + N - 1) % (unsigned)N;
}
__device__ __forceinline__ unsigned vp_slot2(int j, int reach, int N) {
  return (unsigned)(j + N - 1 + reach) % (unsigned)N;
}

// The window [lo, hi) = [max(y - a, 0), min(y + b, H)) of row y, from its
// raw arms a (up) and b (down), clamped to [0, reach].
__device__ __forceinline__ void vp_window(int a, int b, int y, int H,
                                          int reach, int& lo, int& hi) {
  lo = max(y - min(max(a, 0), reach), 0);
  hi = min(y + min(max(b, 0), reach), H);
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

// Register path: in lane k < VP_STEP, the raw arms of the rows whose
// slots step i0 + k loads (`vp_rows`), pass 2's row i0 + k + 1 - reach
// and pass 3's row i0 + k - 2 * reach ...
__device__ __forceinline__ void vp_batch_arms(const int* up, const int* down,
                                              int i0, int lane, int H, int W,
                                              int reach, int (&arm)[4]) {
  arm[0] = arm[1] = arm[2] = arm[3] = 0;
  if (lane < VP_STEP) {
    vp_arms(up, down, i0 + lane + 1 - reach, H, W, arm[0], arm[1]);
    vp_arms(up, down, i0 + lane - 2 * reach, H, W, arm[2], arm[3]);
  }
}

// ... and its windows' slots, packed hi << 16 | lo (0 outside [0, H)).
struct VpLaneSlots {
  unsigned c2, c3;                     // lane k's, of step i0 + k
  int Tb;                              // bytes a slot: 4 * threads
  __device__ __forceinline__ VpLaneSlots(const int (&arm)[4], int i0,
                                         int lane, int H, int reach, int N,
                                         int T)
      : c2(0u), c3(0u), Tb(4 * T) {
    int lo, hi;
    const int y2 = i0 + lane + 1 - reach, y3 = i0 + lane - 2 * reach;
    if (y2 >= 0 && y2 < H) {
      vp_window(arm[0], arm[1], y2, H, reach, lo, hi);
      c2 = vp_slot1(hi, N) << 16 | vp_slot1(lo, N);
    }
    if (y3 >= 0 && y3 < H) {
      vp_window(arm[2], arm[3], y3, H, reach, lo, hi);
      c3 = vp_slot2(hi, reach, N) << 16 | vp_slot2(lo, reach, N);
    }
  }
  // the byte offsets, in the thread's ring column, of the window ends of
  // pass 2's row i0 + k + 1 - reach (ring1) and pass 3's row
  // i0 + k - 2 * reach (ring2)
  __device__ __forceinline__ uint2 pass2(int k) const {
    const unsigned c = __shfl_sync(0xFFFFFFFFu, c2, k);
    return make_uint2((c >> 16) * Tb, (c & 0xFFFFu) * Tb);
  }
  __device__ __forceinline__ uint2 pass3(int k) const {
    const unsigned c = __shfl_sync(0xFFFFFFFFu, c3, k);
    return make_uint2((c >> 16) * Tb, (c & 0xFFFFu) * Tb);
  }
};

// Staged path: the same offsets from the slot ring of the thread's
// column, which the producer warp fills: entry y % VP_SLOTS holds row y's
// {ring1 hi, ring1 lo, ring2 hi, ring2 lo}, and a copy VP_SLOTS further
// for the first VP_ROWS entries, so that a batch's rows never wrap.
struct VpRingSlots {
  const uint4* e2;                     // row i0 + 1 - reach's entry
  const uint4* e3;                     // row i0 - 2 * reach's entry
  __device__ __forceinline__ uint2 pass2(int k) const {
    return reinterpret_cast<const uint2*>(e2 + k)[0];
  }
  __device__ __forceinline__ uint2 pass3(int k) const {
    return reinterpret_cast<const uint2*>(e3 + k)[1];
  }
};

// The producer warp: row y's entry into a column's slot ring.
__device__ __forceinline__ void vp_put_slots(uint4* ring, int y, int a,
                                             int b, int H, int reach, int N,
                                             int T) {
  int lo, hi;
  vp_window(a, b, y, H, reach, lo, hi);
  const unsigned Tb = 4 * T;
  const uint4 v = make_uint4(vp_slot1(hi, N) * Tb, vp_slot1(lo, N) * Tb,
                             vp_slot2(hi, reach, N) * Tb,
                             vp_slot2(lo, reach, N) * Tb);
  const int e = y & (VP_SLOTS - 1);
  ring[e] = v;
  if (e < VP_ROWS) ring[e + VP_SLOTS] = v;
}

// One thread's column stream: its columns of the rings, the newest
// prefixes, the slots' values loaded a step ago, where its output goes.
struct VpStream {
  uint32_t* ring1;
  uint32_t* ring2;
  uint32_t p1, p2;
  uint32_t r_hi, r_lo;                 // P1 at pass 2's next window's ends
  uint32_t q_hi, q_lo;                 // P2 at pass 3's last window's ends
  int32_t* out;                        // pass 3's next output row
  size_t row;
};

__device__ __forceinline__ uint32_t vp_at(const uint32_t* ring,
                                          unsigned bytes) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(ring) + bytes);
}

// Steps i0 .. i0 + STEP - 1 of the stream; ring slot i0 % N is w.  v[k]
// is input row i0 + k (0 past H); sl gives the slot offsets of pass 2's
// row i0 + k + 1 - reach and pass 3's row i0 + k - 2 * reach.  Step i
// (y2 = i - reach, y3 = i - 2 * reach) in this order:
//   D  P1[i + 1] into ring1 (i < H), then the two ring1 slots of pass 2's
//      row y2 + 1 (its window ends at prefix i + 1 at most);
//   C  pass 3 of row y3 - 1, from the two ring2 slots B loaded a step
//      ago, to the output;
//   A  pass 2 of row y2 from the ring1 slots D loaded a step ago, rescaled
//      into P2[y2 + 1] in ring2;
//   B  the two ring2 slots of pass 3's row y3.
// Every loaded value is used a step after its load, so the loads' latency
// overlaps the step's other work (each load still reads its slot before a
// later store overwrites it: the N slots hold every prefix a window of
// the step can reach).  EDGE: the batch has steps where a row lies
// outside the frame; the others test nothing.
template <int STEP, bool EDGE, class Slots>
__device__ __forceinline__ void vp_rows(VpStream& st, const int (&v)[STEP],
                                        const Slots& sl, int i0, int w,
                                        int H, int reach, int T, int s2,
                                        int s3, bool live) {
  const int half2 = s2 > 0 ? 1 << (s2 - 1) : 0;
  const int half3 = s3 > 0 ? 1 << (s3 - 1) : 0;
  uint32_t* w1 = st.ring1 + (size_t)w * T;
  uint32_t* w2 = st.ring2 + (size_t)w * T;
#pragma unroll
  for (int k = 0; k < STEP; ++k) {
    const int i = i0 + k, y2 = i - reach, y3 = i - 2 * reach;
    uint32_t r_hi = 0u, r_lo = 0u;
    if (!EDGE || i < H) {                            // D
      st.p1 += (uint32_t)v[k];
      w1[k * T] = st.p1;
    }
    if (!EDGE || (y2 + 1 >= 0 && y2 + 1 < H)) {
      const uint2 o = sl.pass2(k);
      r_hi = vp_at(st.ring1, o.x);
      r_lo = vp_at(st.ring1, o.y);
    }
    if (!EDGE || (y3 - 1 >= 0 && y3 - 1 < H)) {      // C
      if (live) *st.out = ((int32_t)(st.q_hi - st.q_lo) + half3) >> s3;
      st.out += st.row;
    }
    if (!EDGE || (y2 >= 0 && y2 < H)) {              // A
      st.p2 += (uint32_t)(((int32_t)(st.r_hi - st.r_lo) + half2) >> s2);
      w2[k * T] = st.p2;                             // P2[y2 + 1]
    }
    if (!EDGE || (y3 >= 0 && y3 < H)) {              // B
      const uint2 o = sl.pass3(k);
      st.q_hi = vp_at(st.ring2, o.x);
      st.q_lo = vp_at(st.ring2, o.y);
    }
    st.r_hi = r_hi;
    st.r_lo = r_lo;
  }
}

// vp_rows, without the tests where every step of the batch has all its
// rows in the frame.
template <int STEP, class Slots>
__device__ __forceinline__ void vp_batch(VpStream& st, const int (&v)[STEP],
                                         const Slots& sl, int i0, int w,
                                         int H, int reach, int T, int s2,
                                         int s3, bool live) {
  if (i0 > 2 * reach && i0 + STEP < H + (reach > 0))
    vp_rows<STEP, false>(st, v, sl, i0, w, H, reach, T, s2, s3, live);
  else
    vp_rows<STEP, true>(st, v, sl, i0, w, H, reach, T, s2, s3, live);
}

// The producer warp's arms of batch b's slot rows: lane l takes the
// (row, column) pairs j = l + 32 q (q = 0, 1) of rows b * VP_ROWS + 1 ..
// + VP_ROWS, row b * VP_ROWS + 1 + j / cols of column j % cols, where
// vp_pair tells that the pair lies in the batch and the frame's rows.  A
// column past W takes arms 0: its slots are read, their sums not stored.
__device__ __forceinline__ bool vp_pair(int b, int j, int cols, int H) {
  return j < VP_ROWS * cols && b * VP_ROWS + 1 + j / cols < H;
}

__device__ __forceinline__ void vp_pair_arms(const int* up, const int* down,
                                             int b, int lane, int cols,
                                             int x0, int H, int W,
                                             int (&a)[2], int (&bb)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = lane + 32 * q;
    const size_t at = (size_t)(b * VP_ROWS + 1 + j / cols) * W + x0 +
                      j % cols;
    a[q] = bb[q] = 0;
    if (vp_pair(b, j, cols, H) && x0 + j % cols < W) {
      a[q] = up[at];
      bb[q] = down[at];
    }
  }
}

// in, out: (H, W, D) i32; up/down (H, W) i32.  Block: TD stream threads
// over d (a multiple of 32) for each of T / TD columns; rings of N slots.
// STAGED: the input volume is the tensor map vin over (D, W, H), whose
// box of (boxD = min(D, TD)) x cols x VP_ROWS (SW = cols * boxD words a
// row) is the block's span of VP_ROWS rows.  The input rows come through
// K stages of shared memory, tensor copies that one more warp (the
// producer) issues as the stream threads release the stages; it also
// fills a slot ring per column.  Else the rows come through registers and
// each warp computes its slots.
template <bool STAGED>
__global__ void __launch_bounds__(160)
vpass_kernel(const __grid_constant__ CUtensorMap vin,
             const int32_t* __restrict__ in, const int* __restrict__ up,
             const int* __restrict__ down, int32_t* __restrict__ out, int H,
             int W, int D, int reach, int N, int TD, int K, int s2, int s3) {
  extern __shared__ __align__(1024) uint32_t smem[];
  const int T = STAGED ? blockDim.x - 32 : blockDim.x;   // stream threads
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int cols = T / TD;
  const int x0 = blockIdx.x * cols, d0 = blockIdx.y * TD;
  const int boxD = min(D, TD), SW = cols * boxD;
  // the K stages, the rings, the stages' barriers, the slot rings (the
  // register path: the rings alone)
  const size_t stage = (size_t)VP_ROWS * T;
  uint32_t* stages = smem;
  uint32_t* rings = STAGED ? smem + K * stage : smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(rings + (size_t)2 * N * T);
  uint64_t* empty = full + K;
  uint4* slots = reinterpret_cast<uint4*>(
      reinterpret_cast<char*>(full) + VP_BARS);
  const int nin = (H + VP_ROWS - 1) / VP_ROWS;      // batches of input
  if constexpr (STAGED) {
    if (t == 0) {
      for (int s = 0; s < K; ++s) {
        stm_bar_init(full + s, 1);
        stm_bar_init(empty + s, T / 32);
      }
      stm_bar_init_fence();
    }
    __syncthreads();
    if (t >= T) {                      // the producer warp
      // batch b: input rows b * VP_ROWS .. + VP_ROWS - 1 into stage
      // b % K, and the slots of rows b * VP_ROWS + 1 .. + VP_ROWS (row
      // 0's first), each batch's arms loaded a batch ahead
      const unsigned box = VP_ROWS * SW * sizeof(uint32_t);
      if (lane < cols)
        vp_put_slots(slots + lane * (VP_SLOTS + VP_ROWS), 0,
                     x0 + lane < W ? up[x0 + lane] : 0,
                     x0 + lane < W ? down[x0 + lane] : 0, H, reach, N, T);
      int an[2], bn[2];
      vp_pair_arms(up, down, 0, lane, cols, x0, H, W, an, bn);
      for (int b = 0, s = 0, round = 0; b < nin; ++b) {
        const int a[2] = {an[0], an[1]}, bb[2] = {bn[0], bn[1]};
        if (b + 1 < nin)
          vp_pair_arms(up, down, b + 1, lane, cols, x0, H, W, an, bn);
        if (round > 0) stm_bar_wait(empty + s, (round - 1) & 1);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = lane + 32 * q;
          if (vp_pair(b, j, cols, H))
            vp_put_slots(slots + (j % cols) * (VP_SLOTS + VP_ROWS),
                         b * VP_ROWS + 1 + j / cols, a[q], bb[q], H, reach,
                         N, T);
        }
        __syncwarp();                  // the slots before the arrival
        if (lane == 0) {
          stm_async_fence();           // the stage's reads before the copy
          stm_bar_expect(full + s, box);
          stm_tensor_load_3d(stages + s * stage, &vin, d0, x0, b * VP_ROWS,
                             full + s);
        }
        if (++s == K) {
          s = 0;
          ++round;
        }
      }
      return;
    }
  }
  const int x = x0 + t / TD;
  const int d = d0 + t % TD;
  if (!STAGED && x >= W) return;       // a whole warp: no barrier below
  const bool live = x < W && d < D;
  VpStream st;
  st.ring1 = rings + t;
  st.ring2 = st.ring1 + (size_t)N * T;
  st.ring1[(size_t)vp_slot1(0, N) * T] = 0u;         // P1[0]
  st.ring2[(size_t)vp_slot2(0, reach, N) * T] = 0u;  // P2[0]
  st.p1 = st.p2 = 0u;
  // pass 2's row 0 at step 0 (reach 0: an empty window) and no pass 3
  st.r_hi = st.r_lo = st.q_hi = st.q_lo = 0u;
  st.row = (size_t)W * D;
  st.out = out + (size_t)x * D + d;
  const int steps = H + 2 * reach + 1;           // the last for C alone

  if constexpr (!STAGED) {
    const int32_t* src = in + (size_t)x * D + d;
    const int* upx = up + x;
    const int* downx = down + x;
    int vnext[VP_STEP], anext[4];
#pragma unroll
    for (int k = 0; k < VP_STEP; ++k)
      vnext[k] = live && k < H ? src[(size_t)k * st.row] : 0;
    vp_batch_arms(upx, downx, 0, lane, H, W, reach, anext);
    for (int i0 = 0, w = 0; i0 < steps; i0 += VP_STEP) {
      int v[VP_STEP];
#pragma unroll
      for (int k = 0; k < VP_STEP; ++k) v[k] = vnext[k];
      const VpLaneSlots sl(anext, i0, lane, H, reach, N, T);
      // the next batch's loads, in flight while this one is summed
      if (i0 + VP_STEP < steps) {
#pragma unroll
        for (int k = 0; k < VP_STEP; ++k) {
          const int y = i0 + VP_STEP + k;
          vnext[k] = live && y < H ? src[(size_t)y * st.row] : 0;
        }
        vp_batch_arms(upx, downx, i0 + VP_STEP, lane, H, W, reach, anext);
      }
      vp_batch<VP_STEP>(st, v, sl, i0, w, H, reach, T, s2, s3, live);
      if ((w += VP_STEP) == N) w = 0;
    }
  } else {
    const int word = (x - x0) * boxD + (d - d0);    // the thread's word
    const uint4* cs = slots + (t / TD) * (VP_SLOTS + VP_ROWS);
    int s = 0;
    unsigned parity = 0;
    for (int b = 0, i0 = 0, w = 0; i0 < steps; ++b, i0 += VP_ROWS) {
      int v[VP_ROWS];
      if (b < nin) {
        stm_bar_wait(full + s, parity);
        const uint32_t* in_rows = stages + s * stage + word;
#pragma unroll
        for (int k = 0; k < VP_ROWS; ++k) v[k] = (int)in_rows[k * SW];
        __syncwarp();                  // the warp is past stage s
        if (lane == 0) stm_bar_arrive(empty + s);
        if (++s == K) {
          s = 0;
          parity ^= 1u;
        }
      } else {
#pragma unroll
        for (int k = 0; k < VP_ROWS; ++k) v[k] = 0;
      }
      const VpRingSlots sl = {cs + ((i0 + 1 - reach) & (VP_SLOTS - 1)),
                              cs + ((i0 - 2 * reach) & (VP_SLOTS - 1))};
      vp_batch<VP_ROWS>(st, v, sl, i0, w, H, reach, T, s2, s3, live);
      if ((w += VP_ROWS) == N) w = 0;
    }
  }
}

// The launch of a call: the rings' N slots, block threads, TD, and the
// stages K of the staged path (0: the register path) with the shared
// memory they take.
struct VpPlan {
  int N, TD, threads, K;
  size_t smem;
};

static int vp_plan(int D, int reach, int aligned, VpPlan& p) {
  for (int staged = aligned ? 1 : 0; staged >= 0; --staged) {
    // N: a multiple of the path's batch of rows
    const int step = staged ? VP_ROWS : VP_STEP;
    p.N = (2 * reach + 2 + step - 1) / step * step;
    const long per_thread = 2L * p.N * (long)sizeof(uint32_t);
    int T = 128;
    while (T > 32 && T * per_thread > VP_SMEM_MAX) T /= 2;
    if (T * per_thread > VP_SMEM_MAX) continue;
    p.TD = min((D + 31) / 32 * 32, T);
    p.threads = p.TD * (T / p.TD);
    const long rings = p.threads * per_thread;
    p.K = 0;
    p.smem = (size_t)rings;
    if (!staged) return 0;
    const long stage = (long)VP_ROWS * p.threads * (long)sizeof(uint32_t);
    // the barriers and the columns' slot rings
    const long fixed = VP_BARS + (long)(p.threads / p.TD) *
                                     (VP_SLOTS + VP_ROWS) * sizeof(uint4);
    // two blocks an SM where K >= 2 fit so, else one; a slot ring holds
    // the rows of K + 3 batches and both lags
    long K = (VP_SMEM_SM / 2 - VP_BLOCK_RESERVED - fixed - rings) / stage;
    if (K < 2) K = (VP_SMEM_MAX - fixed - rings) / stage;
    K = min(min(K, (long)VP_KMAX), (VP_SLOTS - 2L * reach) / VP_ROWS - 3);
    if (K >= 2) {
      p.K = (int)K;
      p.smem = (size_t)(K * stage + rings + fixed);
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The stages the staged path takes at D and reach (0: the register path;
// -1: no launch); `aligned`: D % 4 == 0 and the volume's base 16-byte
// aligned (the tensor copies' rows and strides are 16-byte multiples).
// ops/band.py `vv_stages` mirrors it.
STM_API int stm_vv_stages(int D, int reach, int aligned) {
  VpPlan p;
  return vp_plan(D, reach, aligned, p) ? -1 : p.K;
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library).
typedef CUresult (*VpEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);

static VpEncode vp_encoder() {
  static VpEncode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = (VpEncode)fn;
  }
  return encode;
}

// The (H, W, D) i32 volume at v as a tensor map with boxes of
// boxD x cols x VP_ROWS.
static bool vp_map(CUtensorMap* map, VpEncode encode, const void* v, int H,
                   int W, int D, int boxD, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(int32_t),
                                 (cuuint64_t)W * D * sizeof(int32_t)};
  const cuuint32_t box[3] = {(cuuint32_t)boxD, (cuuint32_t)cols, VP_ROWS};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, (void*)v, dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// in, out: (H, W, D) i32 contiguous (values >= 0); up/down (H, W) i32.
STM_API int stm_vv_pass(const void* in, const void* up, const void* down,
                        void* out, int H, int W, int D, int reach, int s2,
                        int s3, void* stream) {
  if (H <= 0 || H > 65535 || W <= 0 || D <= 0 || D > 1024 || reach < 0 ||
      s2 < 0 || s2 > 30 || s3 < 0 || s3 > 30)
    return (int)cudaErrorInvalidValue;
  const int aligned = D % 4 == 0 && (uintptr_t)in % 16 == 0;
  VpPlan p;
  if (vp_plan(D, reach, aligned, p)) return (int)cudaErrorInvalidValue;
  const int cols = p.threads / p.TD;
  CUtensorMap vin = {};
  if (p.K) {
    const VpEncode encode = vp_encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    if (!vp_map(&vin, encode, in, H, W, D, min(D, p.TD), cols))
      return (int)cudaErrorInvalidValue;
  }
  dim3 grid((W + cols - 1) / cols, (D + p.TD - 1) / p.TD);
  auto kernel = p.K ? vpass_kernel<true> : vpass_kernel<false>;
  cudaError_t err = stm_smem_cap(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  // the staged path's producer warp beside the stream threads
  const int threads = p.threads + (p.K ? 32 : 0);
  kernel<<<grid, threads, p.smem, (cudaStream_t)stream>>>(
      vin, (const int32_t*)in, (const int*)up, (const int*)down,
      (int32_t*)out, H, W, D, reach, p.N, p.TD, p.K, s2, s3);
  return (int)cudaGetLastError();
}
