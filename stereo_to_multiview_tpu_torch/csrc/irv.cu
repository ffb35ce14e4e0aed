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
// the planes around it are 8 MB.  B8 streams each row: a warp takes one
// row and segment of <= 256 columns, primed over the reach to its left
// and run reach positions past its right end (the design of B4/B6,
// hpass.cu).  Lane l owns the bins 4l .. 4l + 3 (and 4l + 128 .. above
// B = 128).  A lane's four running counts are the four bytes of one u32:
// a window's count is at most 2 * reach + 1 <= 255 for reach <= 127, so
// the wrapped difference of two prefixes is exact in every byte (the
// carries between the bytes cancel, as between B9's u16 halves).  Pushing
// a position is one shift and one add a group; lane k of a batch loads
// position k's disparity and label (its bin key) and the arms of output
// k, a batch's loads issued one batch ahead.  Its time follows its
// shared-memory operations (on an H100, fewer of them took it from 0.233
// to 0.192 ms at 1080p), so the warp reads the keys, and the outputs'
// window slots, four at a time from shared memory (a broadcast load
// where a shuffle moves one), and the total (channel B) takes one prefix
// a position, which lane k of a batch writes for position k from a
// ballot of the reliable positions and lane k of an output chunk reads
// for its pixel (a lane of its own would cost three shared accesses a
// pixel).  The prefixes go into a ring of 2 * reach + 33 slots in shared
// memory; a window is one difference of two slots.  A pixel's B + 1
// outputs are contiguous bytes: a batch's 32 pixels are staged in shared
// memory at the alignment they have in the volume and go out as 16-byte
// stores.
//
// B9 streams the span volume down the columns.  A warp owns one column of
// a 256-row segment (2 adjacent columns a block, no barrier); per row it
// reads the pixel's B + 1 contiguous bytes as aligned 32-bit words (a
// funnel shift realigns them: B + 1 = 129 is odd), lane l taking bins
// 4l .. 4l + 3 (and 4l + 128 .. above B = 128), and the total's byte in
// one broadcast load.  The running prefixes of a lane's 4 bins are two
// u32 words of packed u16 halves in a ring in shared memory (u16
// differences are exact: a window's sum is at most (2 * reach + 1)^2 =
// 4761 at usd = 34, below 2^16 for reach <= 127, so carries between the
// halves cancel); the total's prefix is one u32 a slot.  Rows go in
// batches of 8: the next batch's span words and planes (lane k loads row
// k's) are loaded before the current one is summed, and no loaded value
// is used before its batch comes up.  A batch first pushes its 8 rows
// into the ring (independent rows: instruction-level parallelism), then
// takes the votes of its rows that vote (an outlier, at a need pixel
// under `need`), each reach rows behind its newest span row: the ring
// holds 2 * reach + 2 + 8 rows.  Each lane takes the maximum of its keys
// count << 16 | (0xFFFF - bin), one __reduce_max_sync gives the warp's
// (the largest key is the first maximum), and lane 0 writes the pixel if
// the vote accepts.  The kernel that maps the runs (below) copies disp
// and labels to the outputs (coalesced), so the vote writes only the
// pixels that accept.  Row
// segments keep the grid at several waves (whole-column streams would
// give 1920 warps of serial work, 1.2 waves of the card's resident
// warps), at the cost of priming each segment's rings over reach rows.
// 78 rows x (32 x 8 + 4) bytes = 20 KB of rings a warp at usd = 34: 5
// blocks, 10 warps an SM.
//
// Runs and `need` gating (the TPU kernels' flag-gated DMA, irvkern.py
// `wflags` / `vflags`): with a `need` plane, only outliers at need pixels
// vote; every other pixel keeps its disparity and label.  One live map
// (`irv_live_kernel`, coalesced along x) gives, for each (64-row tile,
// column), the first and last row of a voting pixel (every outlier votes
// without `need`).  A B9 warp streams only the rows from a tile's first
// to its last voting row, with reach rows either side, continuing into
// the next live tile and restarting its rings where the two tiles' voters
// lie more than 2 * reach rows apart (a prefix difference does not depend
// on where the prefix started): it reads only spans of the live cells'
// reach.  With `need`, B8 computes a span (y, x) only where a vote may
// read it, at B9's own grain: y in [t * 64 + first - reach, t * 64 + last
// + reach] for a live cell (t, x) of the map, with first and last its
// voting rows (a pixel looks up at most 2 * ceil(reach / 64) + 1 cells).
// These are exactly the rows B9 streams.  A batch of 32 columns whose
// pixels no vote reads is skipped, and so are its pushes where no later
// batch needs them; a store that holds no byte of a read pixel is
// skipped.  The other spans stay undefined and are never read.  Without
// `need` B8 writes every span.

#include "stm_common.cuh"

#define IRV_TILE 64

// Bin key of a pixel: its bin in [0, B), B for a reliable pixel outside
// the bins, -1 for an outlier.
__device__ __forceinline__ int irv_key(float d, uint8_t outl, int B, int zd) {
  if (outl != 0) return -1;
  const long long b = (long long)(int)d + zd;
  return (b >= 0 && b < B) ? (int)b : B;
}

#define IRV_ROWS_X 64             // columns of a live-map block
#define IRV_ROWS_Q 4              // row quarters of a tile, a thread each

// The live map: live[t][x] = 0 if column x has no voting pixel (an
// outlier, at a need pixel when `need` is given) in the tile's rows
// [t * IRV_TILE, (t + 1) * IRV_TILE), else (last + 1) << 8 | (first + 1)
// with the first and last voting rows' offsets in the tile.  B8 gates its
// spans on it, B9 takes its runs from it.  With disp_out, it also copies
// disp and outl to the vote's outputs (coalesced), where the vote then
// writes only the pixels that accept.  A thread takes a quarter of a
// tile's rows in one column.
__global__ void __launch_bounds__(IRV_ROWS_X * IRV_ROWS_Q)
irv_live_kernel(const uint8_t* __restrict__ need,
                const uint8_t* __restrict__ outl,
                const float* __restrict__ disp, uint16_t* __restrict__ live,
                float* __restrict__ disp_out, uint8_t* __restrict__ outl_out,
                int H, int W) {
  __shared__ int first_q[IRV_ROWS_Q][IRV_ROWS_X];
  __shared__ int last_q[IRV_ROWS_Q][IRV_ROWS_X];
  const int cx = threadIdx.x % IRV_ROWS_X, q = threadIdx.x / IRV_ROWS_X;
  const int x = blockIdx.x * IRV_ROWS_X + cx;
  const int t = blockIdx.y;
  constexpr int QR = IRV_TILE / IRV_ROWS_Q;
  const int r0 = t * IRV_TILE + q * QR, n = max(min(QR, H - r0), 0);
  int first = IRV_TILE + 1, last = 0;     // offsets in the tile, + 1
  if (x < W) {
#pragma unroll 8
    for (int r = 0; r < n; ++r) {
      const size_t i = (size_t)(r0 + r) * W + x;
      const uint8_t o = outl[i];
      if (disp_out != nullptr) {
        disp_out[i] = disp[i];
        outl_out[i] = o;
      }
      const bool v = (o != 0) & (need == nullptr || need[i] != 0);
      first = v ? min(first, q * QR + r + 1) : first;
      last = v ? q * QR + r + 1 : last;
    }
  }
  first_q[q][cx] = first;
  last_q[q][cx] = last;
  __syncthreads();
  if (q != 0 || x >= W) return;
  for (int k = 1; k < IRV_ROWS_Q; ++k) {
    first = min(first, first_q[k][cx]);
    last = max(last, last_q[k][cx]);
  }
  live[(size_t)t * W + x] = (uint16_t)(last == 0 ? 0 : last << 8 | first);
}

static inline void irv_live(const void* need, const void* outl,
                            const void* disp, void* live, void* disp_out,
                            void* outl_out, int H, int W,
                            cudaStream_t stream) {
  dim3 grid((W + IRV_ROWS_X - 1) / IRV_ROWS_X, (H + IRV_TILE - 1) / IRV_TILE);
  irv_live_kernel<<<grid, IRV_ROWS_X * IRV_ROWS_Q, 0, stream>>>(
      (const uint8_t*)need, (const uint8_t*)outl, (const float*)disp,
      (uint16_t*)live, (float*)disp_out, (uint8_t*)outl_out, H, W);
}

// ---- B8: the row spans -------------------------------------------------

#define IRV_RS_STEP 32            // positions pushed (and outputs) a batch
#define IRV_RS_SEG 256            // most output columns of a segment
#define IRV_RS_TILES 5            // most live cells a pixel looks up
#define IRV_SMEM_MAX (227 * 1024)  // shared memory a block may hold

// One pixel's bins into the stage at o (the lane's first group): the window
// differences of the lane's groups between the slots packed in sk, stored
// a byte at a time (the stage is at the volume's alignment; aligned stores
// chosen at compile time by C % 4 took the same time on an H100).
template <int GJ>
__device__ __forceinline__ void irv_emit_px(const uint32_t* ring, int GB,
                                            int lane,
                                            const unsigned (&nbin)[GJ],
                                            uint8_t* o, unsigned sk) {
  const uint32_t* ph = ring + (sk >> 16) * GB + lane;
  const uint32_t* pl = ring + (sk & 0xFFFFu) * GB + lane;
#pragma unroll
  for (int j = 0; j < GJ; ++j) {
    uint8_t* q = o + 128 * j;
    if (nbin[j] == 4u) {
      const uint32_t v = ph[32 * j] - pl[32 * j];
      q[0] = (uint8_t)v;
      q[1] = (uint8_t)(v >> 8);
      q[2] = (uint8_t)(v >> 16);
      q[3] = (uint8_t)(v >> 24);
    } else if (nbin[j] != 0u) {              // the last group, partial
      const uint32_t v = ph[32 * j] - pl[32 * j];
      for (unsigned k = 0; k < nbin[j]; ++k) q[k] = (uint8_t)(v >> (8 * k));
    }
  }
}

// The n <= 32 pixels of an output chunk into the stage st, four at a time
// (their slots one 16-byte broadcast load of sbuf); pixel k starts at st +
// k C.  FULLC: n = 32.
template <int GJ, bool FULLC>
__device__ __forceinline__ void irv_emit_chunk(const uint32_t* ring,
                                               const unsigned* sbuf, int GB,
                                               int C, int lane,
                                               const unsigned (&nbin)[GJ],
                                               uint8_t* st, int n) {
  auto emit4 = [&](int i) {
    const uint4 sq = reinterpret_cast<const uint4*>(sbuf)[i];
    uint8_t* o = st + 4 * i * C + 4 * lane;
    irv_emit_px<GJ>(ring, GB, lane, nbin, o, sq.x);
    if (FULLC || 4 * i + 1 < n)
      irv_emit_px<GJ>(ring, GB, lane, nbin, o + C, sq.y);
    if (FULLC || 4 * i + 2 < n)
      irv_emit_px<GJ>(ring, GB, lane, nbin, o + 2 * C, sq.z);
    if (FULLC || 4 * i + 3 < n)
      irv_emit_px<GJ>(ring, GB, lane, nbin, o + 3 * C, sq.w);
  };
  if constexpr (GJ == 1 && FULLC) {          // the main path
#pragma unroll 2
    for (int i = 0; i < IRV_RS_STEP / 4; ++i) emit4(i);
  } else {
#pragma unroll 1
    for (int i = 0; 4 * i < n; ++i) emit4(i);
  }
}

// One warp a (row, segment of S columns): blockIdx.x = y * nseg + seg.
// Bin group g holds the bins 4g .. 4g + 3 (of GB = ceil(B / 4)); lane l
// owns the groups g = l + 32 j, j < GJ, each group's running counts the
// four bytes of one u32 (see the header).  The total (channel B) has a
// prefix of its own a slot: lane k of a batch takes the prefix after
// position k from a ballot of the reliable positions, and lane k of an
// output chunk takes pixel k's total.
//
// Output chunk m is the 32 columns x0 + 32 m ..; batch b = m + K pushes
// the 32 positions x0 + reach + 32 m .. (K = ceil(2 reach / 32) priming
// batches first, m < 0), after which every window of chunk m is in the
// ring: the newest boundary x0 + reach + 32 (m + 1) sits in slot w, and
// the oldest a window needs, x0 + 32 m - reach, at most 2 reach + 32 slots
// behind it.  A position outside [x0 - reach, x1 + reach) or the row
// counts nothing (key -1), so every batch pushes 32 positions without a
// branch.  With `need`, chunk m is live iff a vote reads one of its
// pixels (the live cells' rows, see the header), a batch runs iff one of
// the chunks m .. m + K it feeds is live, and the prefixes restart at 0
// after a batch that did not run.  The outputs of a live chunk are
// staged in shared memory at the alignment they have in the volume and
// go out as 16-byte stores, with a byte head and tail; under `need` a
// store that holds no byte of a pixel a vote reads is skipped.  A batch's
// keys, and an output chunk's window slots, go through shared memory
// (kbuf, sbuf) and are read four at a time by broadcast 16-byte loads: a
// quarter of the shared-memory operations of a shuffle each.
template <int GJ>
__global__ void __launch_bounds__(32)
irv_rowspan_kernel(const float* __restrict__ disp,
                   const uint8_t* __restrict__ outl,
                   const int* __restrict__ left,
                   const int* __restrict__ right,
                   const uint16_t* __restrict__ live,
                   uint8_t* __restrict__ cnt, int H, int W, int B, int zd,
                   int reach, int S, int nseg, int N) {
  extern __shared__ __align__(16) unsigned char rs_smem[];
  const unsigned FULL = 0xFFFFFFFFu;
  const int C = B + 1, GB = (B + 3) / 4;
  const int lane = threadIdx.x;
  uint32_t* ring = reinterpret_cast<uint32_t*>(rs_smem);   // [slot][group]
  uint32_t* ringt = ring + (size_t)N * GB;                 // [slot]
  int* kbuf = reinterpret_cast<int*>(
      rs_smem + ((size_t)N * (GB + 1) * 4 + 15) / 16 * 16);
  unsigned* sbuf = reinterpret_cast<unsigned*>(kbuf + IRV_RS_STEP);
  uint8_t* stage = reinterpret_cast<uint8_t*>(sbuf + IRV_RS_STEP);
  const int y = blockIdx.x / nseg;
  const int x0 = (blockIdx.x % nseg) * S, x1 = min(x0 + S, W);
  const int M = (x1 - x0 + IRV_RS_STEP - 1) / IRV_RS_STEP;
  const int K = (2 * reach + IRV_RS_STEP - 1) / IRV_RS_STEP;
  const size_t row = (size_t)y * W;

  // bit m of `mine`: pixel x0 + 32 m + lane is read by a vote; bit m of
  // `chunks`: one of chunk m's pixels is
  unsigned mine = 0u, chunks = 0u;
  const int t0 = max(y - reach, 0) / IRV_TILE;
  const int t1 = min(y + reach, H - 1) / IRV_TILE;
#pragma unroll
  for (int m = 0; m < IRV_RS_SEG / IRV_RS_STEP; ++m) {
    if (m >= M) break;
    const int p = x0 + IRV_RS_STEP * m + lane;
    bool v = p < x1;
    if (live != nullptr) {
      bool any = false;
#pragma unroll
      for (int i = 0; i < IRV_RS_TILES; ++i) {
        const int t = t0 + i;
        if (v && t <= t1) {
          const unsigned c = live[(size_t)t * W + p];
          const int base = t * IRV_TILE - 1;
          any |= c != 0u && base + (int)(c & 0xFFu) - reach <= y &&
                 y <= base + (int)(c >> 8) + reach;
        }
      }
      v = any;
    }
    mine |= (unsigned)v << m;
    chunks |= (unsigned)__any_sync(FULL, v) << m;
  }
  if (chunks == 0u) return;                  // the whole warp

  const unsigned feed = chunks << K;         // batch b runs iff a bit of
  const unsigned kmask = (2u << K) - 1u;     // feed in [b, b + K] is set
  const int nb = K + M;
  const int q0 = max(x0 - reach, 0), q1 = min(x1 + reach, W);
  const int gj = (GB + 31) / 32;             // groups a lane, <= GJ
  unsigned nbin[GJ];                         // the lane's bins a group
#pragma unroll
  for (int j = 0; j < GJ; ++j)
    nbin[j] = (unsigned)min(max(B - 4 * (lane + 32 * j), 0), 4);
  // floor(j / C) = __umulhi(j, magic) for every staged byte j
  const unsigned magic = (unsigned)((0x100000000ull + C - 1) / C);
  const unsigned le = (2u << lane) - 1u;     // lanes 0 .. lane

  uint32_t acc[GJ], acct = 0u;
  int w = 0;                                 // slot of the newest boundary
  // the next batch, raw: the key's planes of position x0 + reach + 32 m +
  // lane, the arms of output x0 + 32 m + lane
  float n_d = 0.f;
  int n_o = 1, n_l = 0, n_r = 0;
  auto load = [&](int b) {
    const int m = b - K;
    const int q = x0 + reach + IRV_RS_STEP * m + lane;
    const int p = x0 + IRV_RS_STEP * m + lane;
    n_d = 0.f;
    n_o = 1;
    n_l = n_r = 0;
    if (q >= q0 && q < q1) {
      n_d = disp[row + q];
      n_o = outl[row + q];
    }
    if (m >= 0 && p < x1) {
      n_l = left[row + p];
      n_r = right[row + p];
    }
  };
  auto runs = [&](int b) { return ((feed >> b) & kmask) != 0u; };

  int b = 0;
  while (!runs(b)) ++b;
  load(b);
  int prev = -2;
  while (b < nb) {
    int bn = b + 1;
    while (bn < nb && !runs(bn)) ++bn;
    const float d_raw = n_d;
    const int o_raw = n_o, l_raw = n_l, r_raw = n_r;
    if (bn < nb) load(bn);                   // in flight during this batch
    if (b != prev + 1) {                     // (re)start: P = 0 at the
      acct = 0u;                             // batch's first boundary
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        acc[j] = 0u;
        if (nbin[j] != 0u) ring[w * GB + lane + 32 * j] = 0u;
      }
      if (lane == 0) ringt[w] = 0u;
    }
    const int key = irv_key(d_raw, (uint8_t)o_raw, B, zd);
    const int w0 = w;
    __syncwarp();                            // the last batch read kbuf
    kbuf[lane] = key;
    // the totals: lane k writes the prefix after position k
    const unsigned rel = __ballot_sync(FULL, key >= 0);
    {
      const int s = w0 + lane + 1;
      ringt[s < N ? s : s - N] = acct + __popc(rel & le);
      acct += __popc(rel);
    }
    __syncwarp();
    // the bins: push the batch's 32 positions
    auto push = [&](int k, int kk) {
      const int s = w0 + k + 1;
      uint32_t* rs = ring + (s < N ? s : s - N) * GB + lane;
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        if (GJ > 1 && j >= gj) break;        // the groups this B has
        const unsigned dk = (unsigned)(kk - 4 * (lane + 32 * j));
        acc[j] += dk < nbin[j] ? 1u << (dk << 3) : 0u;
        if (nbin[j] != 0u) rs[32 * j] = acc[j];
      }
    };
    auto push4 = [&](int i) {
      const int4 kq = reinterpret_cast<const int4*>(kbuf)[i];
      push(4 * i, kq.x);
      push(4 * i + 1, kq.y);
      push(4 * i + 2, kq.z);
      push(4 * i + 3, kq.w);
    };
    if constexpr (GJ == 1) {                 // the main path: unrolled
#pragma unroll
      for (int i = 0; i < IRV_RS_STEP / 4; ++i) push4(i);
    } else {                                 // B > 128: a smaller build
#pragma unroll 1
      for (int i = 0; i < IRV_RS_STEP / 4; ++i) push4(i);
    }
    w = w0 + IRV_RS_STEP < N ? w0 + IRV_RS_STEP : w0 + IRV_RS_STEP - N;

    const int m = b - K;
    if (m >= 0 && ((chunks >> m) & 1u)) {
      const int xc = x0 + IRV_RS_STEP * m;
      const int n = min(IRV_RS_STEP, x1 - xc);
      const int bnew = xc + reach + IRV_RS_STEP;   // boundary in slot w
      int sh = w, sl = w;                    // this lane's output window
      if (lane < n) {
        const int p = xc + lane;
        const int an = min(max(l_raw, 0), reach);
        const int ap = min(max(r_raw, 0), reach);
        sh = w - (bnew - min(p + ap + 1, W));
        sl = w - (bnew - max(p - an, 0));
        sh += sh < 0 ? N : 0;
        sl += sl < 0 ? N : 0;
      }
      uint8_t* dst = cnt + (row + xc) * C;
      const int off = (int)((uintptr_t)dst & 15u);
      uint8_t* st = stage + off;
      __syncwarp();                          // the last chunk's copy is done
      sbuf[lane] = (unsigned)sh << 16 | (unsigned)sl;
      if (lane < n) st[lane * C + B] = (uint8_t)(ringt[sh] - ringt[sl]);
      __syncwarp();
      if (n == IRV_RS_STEP)
        irv_emit_chunk<GJ, true>(ring, sbuf, GB, C, lane, nbin, st, n);
      else
        irv_emit_chunk<GJ, false>(ring, sbuf, GB, C, lane, nbin, st, n);
      __syncwarp();
      // out: a byte head to the 16-byte boundary, 16-byte stores, a byte
      // tail; under `need` only the stores that hold a read pixel's byte
      const unsigned reads = __ballot_sync(FULL, (mine >> m) & 1u);
      const bool every = live == nullptr;
      auto read = [&](int j0, int j1) {      // bytes j0 .. j1 of the chunk
        const unsigned k0 = __umulhi((unsigned)j0, magic);
        const unsigned k1 = __umulhi((unsigned)j1, magic);
        return every || ((reads >> k0) & ((2u << (k1 - k0)) - 1u)) != 0u;
      };
      const int nbytes = n * C;
      const int head = min((16 - off) & 15, nbytes);
      const int body = (nbytes - head) >> 4;
      const int tail = nbytes - head - 16 * body;
      if (lane < head && read(lane, lane)) dst[lane] = st[lane];
      if (lane >= 16 && lane - 16 < tail) {
        const int j = head + 16 * body + lane - 16;
        if (read(j, j)) dst[j] = st[j];
      }
      for (int c = lane; c < body; c += 32) {
        const int j = head + 16 * c;
        if (read(j, j + 15))
          *reinterpret_cast<uint4*>(dst + j) =
              *reinterpret_cast<const uint4*>(st + j);
      }
    }
    prev = b;
    b = bn;
  }
}

template <int GJ>
static cudaError_t irv_rowspan_launch(int blocks, size_t smem,
                                      cudaStream_t stream, const void* disp,
                                      const void* outl, const void* left,
                                      const void* right, const void* live,
                                      void* cnt, int H, int W, int B, int zd,
                                      int reach, int S, int nseg, int N) {
  auto kernel = irv_rowspan_kernel<GJ>;
  cudaError_t err = stm_smem_cap(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32, smem, stream>>>(
      (const float*)disp, (const uint8_t*)outl, (const int*)left,
      (const int*)right, (const uint16_t*)live, (uint8_t*)cnt, H, W, B, zd,
      reach, S, nseg, N);
  return cudaGetLastError();
}

// disp (H, W) f32, outl (H, W) u8, left/right (H, W) i32; cnt (H, W, B + 1)
// u8, B + 1 <= 1024.  Arms clamp to [0, reach], reach <= 127.  need (H, W)
// u8 or null; with need, live is a (ceil(H / 64), W) u16 scratch and the
// spans no needed vote reads may be left unwritten.
STM_API int stm_irv_rowspan(const void* disp, const void* outl,
                            const void* left, const void* right,
                            const void* need, void* live, void* cnt, int H,
                            int W, int B, int zd, int reach, void* stream) {
  const int C = B + 1;
  if (H <= 0 || W <= 0 || B <= 0 || C > 1024 || reach < 0 || reach > 127)
    return (int)cudaErrorInvalidValue;
  const int GB = (B + 3) / 4, GJ = (GB + 31) / 32;
  const int N = 2 * reach + IRV_RS_STEP + 1;
  const size_t smem = ((size_t)N * (GB + 1) * 4 + 15) / 16 * 16 +
                      2 * IRV_RS_STEP * 4 +
                      ((size_t)IRV_RS_STEP * C + 16 + 15) / 16 * 16;
  if (smem > IRV_SMEM_MAX) return (int)cudaErrorInvalidValue;
  int nseg = (W + IRV_RS_SEG - 1) / IRV_RS_SEG;
  const int S = ((W + nseg - 1) / nseg + IRV_RS_STEP - 1) / IRV_RS_STEP *
                IRV_RS_STEP;
  nseg = (W + S - 1) / S;
  if ((long long)H * nseg > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (need != nullptr) {
    if (live == nullptr) return (int)cudaErrorInvalidValue;
    irv_live(need, outl, disp, live, nullptr, nullptr, H, W, s);
  }
  const void* lv = need != nullptr ? live : nullptr;
  const int blocks = H * nseg;
  // One lane group (C <= 129, every preset), or one kernel of 8 that runs
  // the GJ this B has (fewer kernels to build).
  return (int)(GJ == 1
      ? irv_rowspan_launch<1>(blocks, smem, s, disp, outl, left, right, lv,
                              cnt, H, W, B, zd, reach, S, nseg, N)
      : irv_rowspan_launch<8>(blocks, smem, s, disp, outl, left, right, lv,
                              cnt, H, W, B, zd, reach, S, nseg, N));
}

// ---- B9: the vote ------------------------------------------------------

#define IRV_SEG (4 * IRV_TILE)   // rows of a vote block's segment
#define IRV_VOTE_WARPS 2         // columns (one warp each) of a vote block

// Rows of a batch for GJ word groups a lane (<= 32: lane k loads row k's
// planes); the raw words of two batches live in registers.
template <int GJ>
struct IrvStep {
  static constexpr int value = GJ <= 2 ? 8 : 4;
};

// Word wi of the span volume (`total` bytes, 4-byte aligned); the last
// word may be partial and is read byte by byte.
__device__ __forceinline__ uint32_t irv_word(const uint8_t* __restrict__ cnt,
                                             size_t wi, size_t total) {
  if (wi * 4 + 4 <= total) return reinterpret_cast<const uint32_t*>(cnt)[wi];
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    if (wi * 4 + k < total) v |= (uint32_t)cnt[wi * 4 + k] << (8 * k);
  return v;
}

// One warp, one column x: the votes of rows [a, b), streaming the span
// rows [max(a - reach, 0), min(b + reach, H)) once.  Lane l owns the bin
// groups g = l + 32 j (bins 4g .. 4g + 3 of the GB = ceil(B / 4)): their
// running prefixes are two u32 words, each packing two u16 bin prefixes.
// A window's packed difference is exact in both halves, because each
// bin's window sum is below 2^16: the wrapped carries between the halves
// cancel.  The total channel B has a u32 prefix of its own, the same in
// every lane.  Ring slot s: bin group g at ring[s * GB + g], the total at
// ringt[s].
//
// A pixel's bins are the bytes [o, o + B) of the volume; lane l loads the
// aligned words (o >> 2) + l + 32 j that hold them (lane 0 also the word
// after the last group, when it is needed), and its group's 4 bytes are a
// funnel shift of its word and the next one, which the next lane loaded.
// The total's byte is one broadcast load.  Nothing in a batch's loads
// uses a loaded value: the loads of batch n + 1 are in flight while batch
// n is summed and voted.
template <int GJ>
__device__ __forceinline__ void irv_vote_run(
    const uint8_t* __restrict__ cnt, const float* __restrict__ disp,
    const uint8_t* __restrict__ outl, const int* __restrict__ up,
    const int* __restrict__ down, const uint8_t* __restrict__ need,
    float* __restrict__ disp_out, uint8_t* __restrict__ outl_out, int H,
    int W, int B, int zd, int reach, int N, int thresh_s, float thresh_h,
    int x, int a, int b, uint2* ring, uint32_t* ringt) {
  constexpr int STEP = IrvStep<GJ>::value;
  const unsigned FULL = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int C = B + 1, GB = (B + 3) / 4;
  const size_t total = (size_t)H * W * C;
  const size_t rowb = (size_t)W * C;     // bytes from a row to the next
  const int r0 = max(a - reach, 0), r1 = min(b + reach, H);
  const int i_end = b + reach;           // the vote of row b - 1 is step
                                         // b - 1 + reach
  // the bytes of each owned group that are bins (the rest belong to the
  // total or the next pixel)
  uint32_t mask[GJ];
#pragma unroll
  for (int j = 0; j < GJ; ++j) {
    const int g = lane + 32 * j, left = B - 4 * g;
    mask[j] = g >= GB ? 0u : left >= 4 ? FULL : (1u << (8 * left)) - 1u;
    if (g < GB) ring[g] = make_uint2(0u, 0u);    // P[0] in slot 0
  }
  if (lane == 0) ringt[0] = 0u;
  uint2 acc[GJ];
#pragma unroll
  for (int j = 0; j < GJ; ++j) acc[j] = make_uint2(0u, 0u);
  uint32_t acct = 0u;
  int w = 0;                             // slot of the newest prefix

  // the next batch: raw span words and total bytes of rows i0 .. i0 +
  // STEP - 1, and in lane k the raw planes of vote row i0 + k - reach
  uint32_t wn[STEP][GJ], xn[STEP], tn[STEP];
  int n_o = 0, n_n = 0, n_up = 0, n_dn = 0;
  float n_d = 0.f;
  auto load = [&](int i0) {
    const size_t ob = ((size_t)i0 * W + x) * C;
    // a batch near the end of the volume reads its last word bytewise
    const bool tail = ob + (STEP - 1) * rowb + 4 * (32 * GJ + 2) > total;
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
      const size_t o = ob + k * rowb;
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(cnt) + (o >> 2);
      const int nw = (((int)(o & 3) + B - 1) >> 2) + 1;   // words of bins
      const bool row = i0 + k < r1;
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        const int idx = lane + 32 * j;
        wn[k][j] = !row || idx >= nw ? 0u
                   : tail ? irv_word(cnt, (o >> 2) + idx, total) : wp[idx];
      }
      xn[k] = !row || lane != 0 || 32 * GJ >= nw ? 0u
              : tail ? irv_word(cnt, (o >> 2) + 32 * GJ, total)
                     : wp[32 * GJ];
      tn[k] = row ? cnt[o + B] : 0u;
    }
    const int y = i0 + lane - reach;
    n_o = 0;
    if (lane < STEP && y >= a && y < b) {
      const size_t p = (size_t)y * W + x;
      n_o = outl[p];
      n_n = need == nullptr ? 1 : need[p];
      n_up = up[p];
      n_dn = down[p];
      n_d = disp[p];
    }
  };

  load(r0);
  for (int i0 = r0; i0 < i_end; i0 += STEP) {
    uint32_t wc[STEP][GJ], xc[STEP], tc[STEP];
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
#pragma unroll
      for (int j = 0; j < GJ; ++j) wc[k][j] = wn[k][j];
      xc[k] = xn[k];
      tc[k] = tn[k];
    }
    // lane k: does row k's pixel vote, and its window [lo, hi) of rows
    const int yl = i0 + lane - reach;
    const bool vot = n_o != 0 && n_n != 0;
    const unsigned win =
        ((unsigned)min(yl + min(max(n_dn, 0), reach) + 1, H) << 16) |
        (unsigned)max(yl - min(max(n_up, 0), reach), 0);
    const float dv = n_d;
    const unsigned voters = __ballot_sync(FULL, vot);
    const unsigned ob = (unsigned)(((size_t)i0 * W + x) * C);  // low bits
    if (i0 + STEP < i_end) load(i0 + STEP);
    // the batch's span rows into the rings (rows past the frame are zero
    // rows: their prefixes repeat the last)
#pragma unroll
    for (int k = 0; k < STEP; ++k) {                  // P[i0 + k + 1 - r0]
      const int sh = 8 * (int)((ob + (unsigned)k * (unsigned)rowb) & 3u);
      w = w + 1 == N ? 0 : w + 1;
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        // lane 0 hands lane 31 the first word after its group
        const uint32_t give =
            lane != 0 ? wc[k][j]
                      : j + 1 < GJ ? wc[k][min(j + 1, GJ - 1)] : xc[k];
        const uint32_t nxt = __shfl_sync(FULL, give, (lane + 1) & 31);
        const uint32_t v = __funnelshift_r(wc[k][j], nxt, sh) & mask[j];
        acc[j].x += __byte_perm(v, 0u, 0x4140);
        acc[j].y += __byte_perm(v, 0u, 0x4342);
        if (mask[j] != 0u) ring[w * GB + lane + 32 * j] = acc[j];
      }
      acct += tc[k];
      if (lane == 0) ringt[w] = acct;
    }
    // then the batch's votes: the newest prefix, row i0 + STEP, sits in
    // slot w, and a window reaches back at most STEP + 2 * reach < N rows
    for (unsigned vb = voters; vb != 0u; vb &= vb - 1u) {
      const int k = __ffs(vb) - 1;
      const int y = i0 + k - reach;
      const unsigned wk = __shfl_sync(FULL, win, k);
      const float d = __shfl_sync(FULL, dv, k);
      const int shi = w - (i0 + STEP - (int)(wk >> 16));
      const int slo = w - (i0 + STEP - (int)(wk & 0xFFFFu));
      const int s_hi = shi < 0 ? shi + N : shi;
      const int s_lo = slo < 0 ? slo + N : slo;
      // key = count << 16 | (0xFFFF - bin): the largest key is the first
      // maximum of the counts (a masked byte counts 0 and never wins)
      unsigned key = 0u;
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        const int g = lane + 32 * j;
        if (mask[j] == 0u) continue;
        const uint2 ph = ring[s_hi * GB + g], pl = ring[s_lo * GB + g];
        const uint32_t h01 = ph.x - pl.x, h23 = ph.y - pl.y;
        const unsigned c0 = 0xFFFFu - 4u * g;
        key = max(key, max(max((h01 << 16) | c0, (h01 & 0xFFFF0000u) |
                                                      (c0 - 1u)),
                           max((h23 << 16) | (c0 - 2u),
                               (h23 & 0xFFFF0000u) | (c0 - 3u))));
      }
      const unsigned kmax = __reduce_max_sync(FULL, key);
      const int total_k = (int)(ringt[s_hi] - ringt[s_lo]);
      const int m = (int)(kmax >> 16);
      const int max_d = m > 0 ? 0xFFFF - (int)(kmax & 0xFFFFu) - zd : (int)d;
      const float ratio =
          __fdiv_rn((float)(max_d + zd), (float)max(total_k, 1));
      if (lane == 0 && total_k > thresh_s && ratio > thresh_h) {
        const size_t p = (size_t)y * W + x;
        disp_out[p] = (float)max_d;
        outl_out[p] = 0;
      }
    }
  }
}

// Grid: (ceil(W / warps), ceil(H / IRV_SEG)); a warp takes one column of
// the block's row segment and streams its runs of voting rows.
template <int GJ>
__global__ void __launch_bounds__(32 * IRV_VOTE_WARPS, 5)
irv_vote_kernel(const uint8_t* __restrict__ cnt,
                const float* __restrict__ disp,
                const uint8_t* __restrict__ outl, const int* __restrict__ up,
                const int* __restrict__ down, const uint8_t* __restrict__ need,
                const uint16_t* __restrict__ live,
                float* __restrict__ disp_out, uint8_t* __restrict__ outl_out,
                int H, int W, int B, int zd, int reach, int N, int thresh_s,
                float thresh_h) {
  extern __shared__ uint2 vrings[];
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.x * (blockDim.x >> 5) + warp;
  if (x >= W) return;                    // a whole warp: no barrier below
  const int GB = (B + 3) / 4;
  uint2* ring = reinterpret_cast<uint2*>(
      reinterpret_cast<uint8_t*>(vrings) + (size_t)warp * N * (8 * GB + 4));
  uint32_t* ringt = reinterpret_cast<uint32_t*>(ring + (size_t)N * GB);
  const int y1 = min((blockIdx.y + 1) * IRV_SEG, H);
  const int t1 = (y1 + IRV_TILE - 1) / IRV_TILE;
  // runs [a, b) from a tile's first to a later tile's last voting row:
  // the next tile joins the run when the rows between their voters are
  // at most 2 * reach (no row is streamed that a restart would skip)
  int a = -1, b = -1;
  for (int t = blockIdx.y * (IRV_SEG / IRV_TILE); t < t1; ++t) {
    const unsigned v = live[(size_t)t * W + x];
    if (v == 0u) continue;
    const int f = t * IRV_TILE + (int)(v & 0xFFu) - 1;
    const int l = t * IRV_TILE + (int)(v >> 8);
    if (a >= 0 && f - b > 2 * reach) {
      irv_vote_run<GJ>(cnt, disp, outl, up, down, need, disp_out, outl_out,
                       H, W, B, zd, reach, N, thresh_s, thresh_h, x, a, b,
                       ring, ringt);
      a = -1;
    }
    if (a < 0) a = f;
    b = l;
  }
  if (a >= 0)
    irv_vote_run<GJ>(cnt, disp, outl, up, down, need, disp_out, outl_out, H,
                     W, B, zd, reach, N, thresh_s, thresh_h, x, a, b, ring,
                     ringt);
}

// cnt (H, W, B + 1) u8 from stm_irv_rowspan (called with the same need),
// 4-byte aligned; disp/outl the round's input; up/down (H, W) i32; need
// (H, W) u8 or null; live a (ceil(H / 64), W) u16 scratch; disp_out (H, W)
// f32, outl_out (H, W) u8.
STM_API int stm_irv_vote(const void* cnt, const void* disp, const void* outl,
                         const void* up, const void* down, const void* need,
                         void* live, void* disp_out, void* outl_out, int H,
                         int W, int B, int zd, int reach, int thresh_s,
                         float thresh_h, void* stream) {
  const int GB = (B + 3) / 4;
  const int GJ = (GB + 31) / 32;
  if (H <= 0 || H > 65535 || W <= 0 || B <= 0 || GJ > 8 || reach < 0 ||
      reach > 127 || ((uintptr_t)cnt & 3) != 0 ||
      live == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  irv_live(need, outl, disp, live, disp_out, outl_out, H, W, s);
  // a ring of N = 2 * reach + 2 + STEP rows (even: every warp's rings
  // stay 8-byte aligned) of GB bin groups and the total
#define IRV_VOTE_LAUNCH(J)                                                  \
  case J: {                                                                 \
    const int N = 2 * reach + 2 + IrvStep<J>::value;                        \
    const size_t per_warp = (size_t)N * (8 * GB + 4);                       \
    const int warps =                                                       \
        (int)min((size_t)IRV_VOTE_WARPS, IRV_SMEM_MAX / per_warp);          \
    if (warps == 0) return (int)cudaErrorInvalidValue;                      \
    const size_t smem = warps * per_warp;                                   \
    cudaError_t err = stm_smem_cap(irv_vote_kernel<J>, smem);               \
    if (err != cudaSuccess) return (int)err;                                \
    dim3 grid((W + warps - 1) / warps, (H + IRV_SEG - 1) / IRV_SEG);        \
    irv_vote_kernel<J><<<grid, 32 * warps, smem, s>>>(                      \
        (const uint8_t*)cnt, (const float*)disp, (const uint8_t*)outl,      \
        (const int*)up, (const int*)down, (const uint8_t*)need,             \
        (const uint16_t*)live, (float*)disp_out,                            \
        (uint8_t*)outl_out, H, W, B, zd, reach, N, thresh_s, thresh_h);     \
    break;                                                                  \
  }
  switch (GJ) {
    IRV_VOTE_LAUNCH(1)
    IRV_VOTE_LAUNCH(2)
    IRV_VOTE_LAUNCH(3)
    IRV_VOTE_LAUNCH(4)
    IRV_VOTE_LAUNCH(5)
    IRV_VOTE_LAUNCH(6)
    IRV_VOTE_LAUNCH(7)
    IRV_VOTE_LAUNCH(8)
  }
#undef IRV_VOTE_LAUNCH
  return (int)cudaGetLastError();
}
