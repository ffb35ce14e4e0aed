// B8 + B9: one round of iterative region voting (IRV); G3, the frontier
// between rounds, at the end of this file.
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
// B9 streams the span volume down the columns.  A warp owns one column of a
// row segment; per row it takes the pixel's B + 1 contiguous bytes as
// aligned 32-bit words (a funnel shift realigns them: B + 1 = 129 is odd),
// lane l taking bins 4l .. 4l + 3 (and 4l + 128 .. above B = 128), and the
// total's byte in one broadcast load.  The running prefixes of a lane's 4
// bins are two u32 words of packed u16 halves in a ring in shared memory
// (u16 differences are exact: a window's sum is at most (2 * reach + 1)^2 =
// 4761 at usd = 34, below 2^16 for reach <= 127, so carries between the
// halves cancel); the total's prefix is one u32 a slot.  Rows go in batches
// of 8 (4 on the register path): a batch first pushes its rows into the ring
// (independent rows: instruction-level parallelism), then takes the votes of
// its rows that vote (an outlier, at a need pixel under `need`), each reach
// rows behind its newest span row: the ring holds 2 * reach + 2 + 8 rows (80
// at usd = 34: 20.8 KB a column).  Each lane takes the maximum of its keys
// count << 16 | (0xFFFF - bin), one __reduce_max_sync gives the warp's (the
// largest key is the first maximum); the windows of four voters go through
// the warp side by side, and each voting lane then applies the rule to its
// own pixel.  The live map's kernel (below) copies disp and labels to the
// outputs (coalesced), so the vote writes only the pixels that accept.  Row
// segments keep the grid at several waves, at the cost of priming each
// segment's rings over reach rows.
//
// What feeds the stream (the staged path).  Its rows loaded into registers,
// a batch a warp ahead, 2 columns a block and 5 blocks an SM, B9 took 0.35
// ms a 1080p call on an H100.  That register path stays for shapes whose
// rings leave no room for two stages, which only B >= 425 at a long reach
// gives (B = 1023 at reach 48-53; B = 128 at reach 127 takes 71 KB of rings
// and two stages): one kernel, built for eight lane groups, that runs all
// eight (the masks zero those past B), in batches of 4 rows.  Here a block
// takes a strip of S adjacent columns (S consumer warps) and a segment of up
// to 256 rows, and one more warp, the producer, brings each span row's strip
// bytes ((i * W + x0) * C, S * C bytes, rounded out to 16-byte bounds inside
// the volume) into shared memory by one bulk copy (`cp.async.bulk`), a stage
// of 8 rows at a time, K stages ahead, each stage completing on its
// mbarrier; the consumers push the rows from shared memory and release the
// stage before voting.  The bulk copies alone left it at 0.35 ms: the
// consumers' instructions bound the kernel, as they bound B5 (vpass.cu).
// What took it to 0.21 ms: the strip's offset in its 16 bytes is the same in
// every row where W * C % 16 == 0 (every preset), so a batch inside the
// frame computes no address; a batch's rows fill consecutive ring slots; the
// stage ring is counted, not divided; the votes go four at a time and apply
// their rule lane-parallel (0.12 -> 0.05 ms of votes); more consumer warps
// an SM (10, not 8) and segments of 256 rows, not 384.  S and K
// (`irv_plan`): of the strips whose rings and two stages fit, the one with
// the most consumer warps an SM, two blocks an SM on a tie (S = 5, K = 2 at
// B = 128, reach 34: 104 KB of rings, 11 KB of stages a block), S <= W / 240
// (the lowres preset's 960 columns: S = 4, K = 8).  Both paths push and vote
// alike, so their outputs are equal bit for bit.
//
// Runs and `need` gating (the TPU kernels' flag-gated DMA, irvkern.py
// `wflags` / `vflags`): with a `need` plane, only outliers at need pixels
// vote; every other pixel keeps its disparity and label.  One live map
// (`irv_live_kernel`, coalesced along x) gives, for each (64-row tile,
// column), the first and last row of a voting pixel (every outlier votes
// without `need`).  B9 streams only the rows from a tile's first to its
// last voting row, with reach rows either side, continuing into the next
// live tile and restarting its rings where the two tiles' voters lie more
// than 2 * reach rows apart (a prefix difference does not depend on where
// the prefix started): a register-path warp the runs of its column, a
// staged block those of its strip's columns taken together (a tile's
// first and last voting rows over the strip).  With `need`, B8 computes a
// span (y, x) only where a vote may read it, at B9's own grain: y in [t *
// 64 + first - reach, t * 64 + last + reach] for a live cell (t, x) of the
// map, with first and last its voting rows (a pixel looks up at most 2 *
// ceil(reach / 64) + 1 cells): the rows of column x's own runs.  A batch
// of 32 columns whose pixels no vote reads is skipped, and so are its
// pushes where no later batch needs them; a store that holds no byte of a
// read pixel is skipped.  The other spans stay undefined: a staged
// consumer pushes those of its strip's other runs into its prefixes, but
// no window of its column's votes spans them, so their values cancel.
// Without `need` B8 writes every span.

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

#define IRV_SEG (4 * IRV_TILE)   // rows of a register-path block's segment
#define IRV_VOTE_WARPS 2         // columns (one warp each) of such a block
#define IRV_ROWS 8               // rows of a stage (the staged path's batch)
#define IRV_STRIP 8              // most columns (consumer warps) of a strip
#define IRV_MIN_STRIPS 240       // strips of a frame at least (when W allows)
#define IRV_KMIN 2               // stages at least
#define IRV_KMAX 8               // stages at most
#define IRV_VOTE_GROUP 4         // windows of a batch reduced side by side
#define IRV_SSEG 256             // most rows of a staged block's segment
#define IRV_SMEM_SM (228 * 1024)  // shared memory of an SM
#define IRV_BLOCK_RESERVED 1024  // of it held back for each block

#define IRV_STEP 4  // rows of a register-path batch (lane k loads row k's
                    // planes; the raw words of two batches in registers)

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

// The runs [a, b) of the n <= 32 columns x0 .. in the rows [y0, y1) (whole
// tiles): from a tile's first voting row in any of the columns to a later
// tile's last, the next tile joining the run when the rows between their
// voters are at most 2 * reach (no row is streamed that a restart would
// skip); fn(a, b) for each.  Every lane of the warp gets the same runs.
template <class F>
__device__ __forceinline__ void irv_runs(const uint16_t* __restrict__ live,
                                         int W, int x0, int n, int y0,
                                         int y1, int reach, F&& fn) {
  const unsigned FULL = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  int a = -1, b = -1;
  for (int t = y0 / IRV_TILE; t < (y1 + IRV_TILE - 1) / IRV_TILE; ++t) {
    const unsigned v = lane < n ? live[(size_t)t * W + x0 + lane] : 0u;
    const unsigned l = __reduce_max_sync(FULL, v >> 8);
    if (l == 0u) continue;
    const unsigned f = __reduce_min_sync(FULL, v != 0u ? v & 0xFFu : 0xFFu);
    const int fr = t * IRV_TILE + (int)f - 1, lr = t * IRV_TILE + (int)l;
    if (a >= 0 && fr - b > 2 * reach) {
      fn(a, b);
      a = -1;
    }
    if (a < 0) a = fr;
    b = lr;
  }
  if (a >= 0) fn(a, b);
}

// The bytes of each owned group (g = lane + 32 j) that are bins (the rest
// belong to the total or the next pixel).
template <int GJ>
__device__ __forceinline__ void irv_masks(int B, int lane,
                                          uint32_t (&mask)[GJ]) {
  const int GB = (B + 3) / 4;
#pragma unroll
  for (int j = 0; j < GJ; ++j) {
    const int g = lane + 32 * j, left = B - 4 * g;
    mask[j] = g >= GB ? 0u : left >= 4 ? 0xFFFFFFFFu : (1u << (8 * left)) - 1u;
  }
}

// One span row into the rings as the prefix in slot w.  wc: the lane's
// aligned words of the row's bins (the first gj <= GJ groups), xc: lane
// 0's word after the last group, sh: the bit offset of the first bin in
// them, tc: the row's total.  A group's 4 bytes are a funnel shift of its
// word and the next one, which the next lane holds; the packed u16 halves
// of the running prefixes then take them apart.
template <int GJ>
__device__ __forceinline__ void irv_push(uint2* ring, uint32_t* ringt,
                                         int GB, int gj, int w, int lane,
                                         const uint32_t (&wc)[GJ],
                                         uint32_t xc, int sh, uint32_t tc,
                                         const uint32_t (&mask)[GJ],
                                         uint2 (&acc)[GJ], uint32_t& acct) {
  const unsigned FULL = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < GJ; ++j) {
    if (GJ > 1 && j >= gj) break;        // the groups this B has
    // lane 0 hands lane 31 the first word after its group
    const uint32_t give =
        lane != 0 ? wc[j] : j + 1 < gj ? wc[min(j + 1, GJ - 1)] : xc;
    const uint32_t nxt = __shfl_sync(FULL, give, (lane + 1) & 31);
    const uint32_t v = __funnelshift_r(wc[j], nxt, sh) & mask[j];
    acc[j].x += __byte_perm(v, 0u, 0x4140);
    acc[j].y += __byte_perm(v, 0u, 0x4342);
    if (mask[j] != 0u) ring[w * GB + lane + 32 * j] = acc[j];
  }
  acct += tc;
  if (lane == 0) ringt[w] = acct;
}

// The lane's largest key count << 16 | (0xFFFF - bin) of the window
// between ring slots s_hi and s_lo (the largest key is the first maximum
// of the counts; a masked byte counts 0 and never wins).
template <int GJ>
__device__ __forceinline__ unsigned irv_window_key(const uint2* ring, int GB,
                                                   int gj, int lane,
                                                   const uint32_t (&mask)[GJ],
                                                   int s_hi, int s_lo) {
  unsigned key = 0u;
#pragma unroll
  for (int j = 0; j < GJ; ++j) {
    if (GJ > 1 && j >= gj) break;
    const int g = lane + 32 * j;
    if (mask[j] == 0u) continue;
    const uint2 ph = ring[s_hi * GB + g], pl = ring[s_lo * GB + g];
    const uint32_t h01 = ph.x - pl.x, h23 = ph.y - pl.y;
    const unsigned c0 = 0xFFFFu - 4u * g;
    key = max(key, max(max((h01 << 16) | c0, (h01 & 0xFFFF0000u) | (c0 - 1u)),
                       max((h23 << 16) | (c0 - 2u),
                           (h23 & 0xFFFF0000u) | (c0 - 3u))));
  }
  return key;
}

// The vote rule of pixel p from the warp's largest key and its window's
// total: an outlier accepts max_d = winner - zd (its own trunc(d) when
// every bin is 0) iff total > thresh_s and (max_d + zd) / max(total, 1) >
// thresh_h.
__device__ __forceinline__ void irv_accept(unsigned kmax, uint32_t total,
                                           float d, int zd, int thresh_s,
                                           float thresh_h, size_t p,
                                           float* __restrict__ disp_out,
                                           uint8_t* __restrict__ outl_out) {
  const int m = (int)(kmax >> 16);
  const int max_d = m > 0 ? 0xFFFF - (int)(kmax & 0xFFFFu) - zd : (int)d;
  const int total_k = (int)total;
  const float ratio =
      __fdiv_rn((float)(max_d + zd), (float)max(total_k, 1));
  if (total_k > thresh_s && ratio > thresh_h) {
    disp_out[p] = (float)max_d;
    outl_out[p] = 0;
  }
}

// The votes of a batch whose newest prefix, of row i_new, sits in slot w:
// bit k of `voters` says that the pixel of row y0 + k votes, lane k of
// `win` holds its window [lo, hi) of rows as hi << 16 | lo and lane k of
// `dv` its disparity.  A window reaches back at most the batch's rows + 2
// * reach < N rows.  The voters' windows go through the warp VG at a time,
// side by side (independent chains of loads and reductions; a group short
// of voters repeats its first window), lane k keeps the largest key of
// window k, and each voting lane then applies the rule to its own pixel.
// The staged path takes IRV_VOTE_GROUP; the register path one (its
// batches of 4 rows rarely hold four voters, and at eight word groups a
// lane one window's loads are many).
template <int GJ, int VG>
__device__ __forceinline__ void irv_votes(
    const uint2* ring, const uint32_t* ringt, int GB, int gj, int N, int w,
    int i_new, unsigned voters, unsigned win, float dv,
    const uint32_t (&mask)[GJ], int lane, int y0, int x, int W, int zd,
    int thresh_s, float thresh_h, float* __restrict__ disp_out,
    uint8_t* __restrict__ outl_out) {
  const unsigned FULL = 0xFFFFFFFFu;
  if (voters == 0u) return;
  auto slot = [&](unsigned row) {
    const int s = w - (i_new - (int)row);
    return s < 0 ? s + N : s;
  };
  unsigned kmax = 0u;
  auto reduce = [&](int v) {
    const unsigned wv = __shfl_sync(FULL, win, v);
    const unsigned m = __reduce_max_sync(
        FULL, irv_window_key<GJ>(ring, GB, gj, lane, mask, slot(wv >> 16),
                                 slot(wv & 0xFFFFu)));
    kmax = lane == v ? m : kmax;
  };
  for (unsigned rest = voters; rest != 0u;) {   // a group of voters (the
    int ks[VG];                                   // first again where fewer
#pragma unroll                                    // are left)
    for (int q = 0; q < VG; ++q) {
      ks[q] = rest != 0u ? __ffs(rest) - 1 : ks[0];
      rest &= rest - 1u;
    }
#pragma unroll
    for (int q = 0; q < VG; ++q) reduce(ks[q]);
  }
  if ((voters >> lane) & 1u)
    irv_accept(kmax, ringt[slot(win >> 16)] - ringt[slot(win & 0xFFFFu)], dv,
               zd, thresh_s, thresh_h, (size_t)(y0 + lane) * W + x,
               disp_out, outl_out);
}

// The planes of a batch's votes: lane k < STEP loads those of row i0 + k -
// reach of column x where that row lies in the run [a, b).
struct IrvPlanes {
  int o, n, up, dn;
  float d;
  __device__ __forceinline__ void load(
      const float* __restrict__ disp, const uint8_t* __restrict__ outl,
      const int* __restrict__ up_, const int* __restrict__ down,
      const uint8_t* __restrict__ need, int i0, int step, int reach, int a,
      int b, int x, int W) {
    const int lane = threadIdx.x & 31;
    const int y = i0 + lane - reach;
    o = 0;
    if (lane < step && y >= a && y < b) {
      const size_t p = (size_t)y * W + x;
      o = outl[p];
      n = need == nullptr ? 1 : need[p];
      up = up_[p];
      dn = down[p];
      d = disp[p];
    }
  }
  // does lane k's pixel (row yl) vote, and its window, hi << 16 | lo
  __device__ __forceinline__ bool votes() const { return o != 0 && n != 0; }
  __device__ __forceinline__ unsigned window(int yl, int reach,
                                             int H) const {
    return ((unsigned)min(yl + min(max(dn, 0), reach) + 1, H) << 16) |
           (unsigned)max(yl - min(max(up, 0), reach), 0);
  }
};

// Register path.  One warp, one column x: the votes of rows [a, b),
// streaming the span rows [max(a - reach, 0), min(b + reach, H)) once.
// Lane l owns the bin groups g = l + 32 j (bins 4g .. 4g + 3 of the GB =
// ceil(B / 4)): their running prefixes are two u32 words, each packing two
// u16 bin prefixes.  A window's packed difference is exact in both
// halves, because each bin's window sum is below 2^16: the wrapped carries
// between the halves cancel.  The total channel B has a u32 prefix of its
// own, the same in every lane.  Ring slot s: bin group g at ring[s * GB +
// g], the total at ringt[s].
//
// A pixel's bins are the bytes [o, o + B) of the volume; lane l loads the
// aligned words (o >> 2) + l + 32 j that hold them (lane 0 also the word
// after the last group, when it is needed).  The total's byte is one
// broadcast load.  Nothing in a batch's loads uses a loaded value: the
// loads of batch n + 1 are in flight while batch n is summed and voted.
template <int GJ>
__device__ __forceinline__ void irv_vote_run(
    const uint8_t* __restrict__ cnt, const float* __restrict__ disp,
    const uint8_t* __restrict__ outl, const int* __restrict__ up,
    const int* __restrict__ down, const uint8_t* __restrict__ need,
    float* __restrict__ disp_out, uint8_t* __restrict__ outl_out, int H,
    int W, int B, int zd, int reach, int N, int thresh_s, float thresh_h,
    int x, int a, int b, uint2* ring, uint32_t* ringt) {
  constexpr int STEP = IRV_STEP;
  const int lane = threadIdx.x & 31;
  // every group of the GJ, whatever B has (the masks zero the groups past
  // B): testing for the groups B has cost more than they save (D=1023 at
  // reach 50 on 200x301: 0.79 ms against 0.55, and 0.74 against 0.55 at
  // D=511, H100)
  const int C = B + 1, GB = (B + 3) / 4, gj = GJ;
  const size_t total = (size_t)H * W * C;
  const size_t rowb = (size_t)W * C;     // bytes from a row to the next
  const int r0 = max(a - reach, 0), r1 = min(b + reach, H);
  const int i_end = b + reach;           // the vote of row b - 1 is step
                                         // b - 1 + reach
  uint32_t mask[GJ];
  irv_masks<GJ>(B, lane, mask);
#pragma unroll
  for (int j = 0; j < GJ; ++j)
    if (mask[j] != 0u) ring[lane + 32 * j] = make_uint2(0u, 0u);  // P[0]
  if (lane == 0) ringt[0] = 0u;
  uint2 acc[GJ];
#pragma unroll
  for (int j = 0; j < GJ; ++j) acc[j] = make_uint2(0u, 0u);
  uint32_t acct = 0u;
  int w = 0;                             // slot of the newest prefix

  // the next batch: raw span words and total bytes of rows i0 .. i0 +
  // STEP - 1, and in lane k the raw planes of vote row i0 + k - reach
  uint32_t wn[STEP][GJ], xn[STEP], tn[STEP];
  IrvPlanes pn{};
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
        wn[k][j] = !row || j >= gj || idx >= nw ? 0u
                   : tail ? irv_word(cnt, (o >> 2) + idx, total) : wp[idx];
      }
      xn[k] = !row || lane != 0 || 32 * gj >= nw ? 0u
              : tail ? irv_word(cnt, (o >> 2) + 32 * gj, total)
                     : wp[32 * gj];
      tn[k] = row ? cnt[o + B] : 0u;
    }
    pn.load(disp, outl, up, down, need, i0, STEP, reach, a, b, x, W);
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
    const IrvPlanes pc = pn;
    const unsigned voters = __ballot_sync(0xFFFFFFFFu, pc.votes());
    const unsigned win = pc.window(i0 + lane - reach, reach, H);
    const unsigned ob = (unsigned)(((size_t)i0 * W + x) * C);  // low bits
    if (i0 + STEP < i_end) load(i0 + STEP);
    // the batch's span rows into the rings (rows past the frame are zero
    // rows: their prefixes repeat the last)
#pragma unroll
    for (int k = 0; k < STEP; ++k) {                  // P[i0 + k + 1 - r0]
      const int sh = 8 * (int)((ob + (unsigned)k * (unsigned)rowb) & 3u);
      w = w + 1 == N ? 0 : w + 1;
      irv_push<GJ>(ring, ringt, GB, gj, w, lane, wc[k], xc[k], sh, tc[k],
                   mask, acc, acct);
    }
    // then the batch's votes: the newest prefix, row i0 + STEP, sits in
    // slot w
    irv_votes<GJ, 1>(ring, ringt, GB, gj, N, w, i0 + STEP, voters, win,
                     pc.d, mask, lane, i0 - reach, x, W, zd, thresh_s,
                     thresh_h, disp_out, outl_out);
  }
}

// Where a staged block's stream of batches stands: the stage of the
// batch, its phase (the times the stage was filled before, mod 2), and
// whether the stage was filled before.
struct IrvStageAt {
  int s;
  unsigned phase;
  bool reused;
  __device__ __forceinline__ void next(int K) {
    if (++s == K) {
      s = 0;
      phase ^= 1u;
      reused = true;
    }
  }
};

// Staged path, the producer warp: the span rows of the strip's run [a, b)
// (the rows [max(a - reach, 0), min(b + reach, H))), batch by batch in the
// consumers' order: each batch into the next stage (`at`, counted over
// the block's runs) once the consumers have released its last use.  Lane k takes the
// batch's row k: its strip's bytes [s0, e0) = [(i * W + x0) * C, + nS * C)
// rounded out to 16-byte bounds [lo, hi) inside the volume, one bulk copy
// to the stage's row k at lo, where the volume's first or last bytes
// leave no 16-byte piece the lane copies bytes by hand (before the
// arrival that releases them); lane 0 arms the stage's `full` barrier
// with the copies' bytes.
__device__ __forceinline__ void irv_produce_run(
    const uint8_t* __restrict__ cnt, uint8_t* stages, uint64_t* full,
    uint64_t* empty, int K, int RB, int H, int W, int C, int reach, int x0,
    int nS, int a, int b, IrvStageAt& at) {
  const unsigned FULL = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const uintptr_t vol = reinterpret_cast<uintptr_t>(cnt);
  const uintptr_t vlo = (vol + 15) & ~(uintptr_t)15;
  const uintptr_t vhi = (vol + (size_t)H * W * C) & ~(uintptr_t)15;
  const int r0 = max(a - reach, 0), r1 = min(b + reach, H);
  for (int i0 = r0; i0 < b + reach; i0 += IRV_ROWS, at.next(K)) {
    const int s = at.s;
    if (at.reused) stm_bar_wait(empty + s, at.phase ^ 1u);
    uint8_t* row = stages + ((size_t)s * IRV_ROWS + lane) * RB;
    const int i = i0 + lane;
    unsigned bytes = 0u;
    uintptr_t b0 = 0, lo = 0;
    if (lane < IRV_ROWS && i < r1) {
      const uintptr_t s0 = vol + ((size_t)i * W + x0) * C;
      const uintptr_t e0 = s0 + (size_t)nS * C;
      const uintptr_t hi = (e0 + 15) & ~(uintptr_t)15;
      lo = s0 & ~(uintptr_t)15;
      b0 = lo > vlo ? lo : vlo;
      uintptr_t b1 = hi < vhi ? hi : vhi;
      if (b1 <= b0) b0 = b1 = e0;         // every byte by hand
      for (uintptr_t q = s0; q < b0; ++q)
        row[q - lo] = *reinterpret_cast<const uint8_t*>(q);
      for (uintptr_t q = b1 > s0 ? b1 : s0; q < e0; ++q)
        row[q - lo] = *reinterpret_cast<const uint8_t*>(q);
      bytes = (unsigned)(b1 - b0);
    }
    __syncwarp();                        // the bytes by hand are in
    const unsigned tx = __reduce_add_sync(FULL, bytes);
    if (lane == 0) stm_bar_expect(full + s, tx);
    __syncwarp();                        // armed before any copy lands
    if (bytes != 0u) {
      stm_async_fence();                 // the stage's reads before the copy
      stm_bulk_load(row + (b0 - lo), reinterpret_cast<const void*>(b0),
                    bytes, full + s);
    }
  }
}

// Staged path, a consumer warp: column x's votes of rows [a, b) as
// irv_vote_run takes them, its span rows from the stages.  Row i of a
// stage holds the strip's bytes from the 16-byte bound below (i * W + x0)
// * C, so the column's pixel starts at off = that byte's offset in its 16
// bytes + (x - x0) * C: the same in every row where W * C % 16 == 0
// (every preset; a batch whose rows all lie in the frame then computes no
// address), else taken row by row.  Its words are read from shared memory
// and realigned by the same funnel shift.  P[j] sits in slot (j - 1) % N,
// N a multiple of the batch, so that a batch's rows fill consecutive
// slots.  The warp releases the stage (`empty`) once the batch is pushed,
// before its votes.
template <int GJ>
__device__ __forceinline__ void irv_vote_staged_run(
    const uint8_t* stages, uint64_t* full, uint64_t* empty, int K, int RB,
    unsigned vol_lo, int x0, const float* __restrict__ disp,
    const uint8_t* __restrict__ outl, const int* __restrict__ up,
    const int* __restrict__ down, const uint8_t* __restrict__ need,
    float* __restrict__ disp_out, uint8_t* __restrict__ outl_out, int H,
    int W, int B, int zd, int reach, int N, int thresh_s, float thresh_h,
    int x, int a, int b, uint2* ring, uint32_t* ringt, IrvStageAt& at) {
  const int lane = threadIdx.x & 31;
  const int C = B + 1, GB = (B + 3) / 4, gj = (GB + 31) / 32;
  const int r0 = max(a - reach, 0), r1 = min(b + reach, H);
  const int i_end = b + reach;
  const int col = (x - x0) * C;
  const bool fixed = ((unsigned)W * (unsigned)C & 15u) == 0u;
  // the offset, its words of bins and shift where it is fixed
  const int off0 = (int)((vol_lo + (unsigned)x0 * (unsigned)C) & 15u) + col;
  const int nw0 = (((off0 & 3) + B - 1) >> 2) + 1;
  const int RB4 = RB >> 2;
  uint32_t mask[GJ];
  irv_masks<GJ>(B, lane, mask);
#pragma unroll
  for (int j = 0; j < GJ; ++j)                     // P[0]
    if (mask[j] != 0u) ring[(N - 1) * GB + lane + 32 * j] = make_uint2(0u, 0u);
  if (lane == 0) ringt[N - 1] = 0u;
  uint2 acc[GJ];
#pragma unroll
  for (int j = 0; j < GJ; ++j) acc[j] = make_uint2(0u, 0u);
  uint32_t acct = 0u;
  int w0 = 0;                            // the batch's first slot
  IrvPlanes pn{};
  pn.load(disp, outl, up, down, need, r0, IRV_ROWS, reach, a, b, x, W);
  for (int i0 = r0; i0 < i_end; i0 += IRV_ROWS, at.next(K)) {
    const IrvPlanes pc = pn;
    const unsigned voters = __ballot_sync(0xFFFFFFFFu, pc.votes());
    const unsigned win = pc.window(i0 + lane - reach, reach, H);
    if (i0 + IRV_ROWS < i_end)
      pn.load(disp, outl, up, down, need, i0 + IRV_ROWS, IRV_ROWS, reach, a,
              b, x, W);
    const int s = at.s;
    stm_bar_wait(full + s, at.phase);
    const uint8_t* st = stages + (size_t)s * IRV_ROWS * RB;
    if (fixed && i0 + IRV_ROWS <= r1) {
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(st) + (off0 >> 2);
#pragma unroll
      for (int k = 0; k < IRV_ROWS; ++k) {           // P[i0 + k + 1 - r0]
        uint32_t wc[GJ], xc = 0u;
#pragma unroll
        for (int j = 0; j < GJ; ++j)
          wc[j] = j < gj && lane + 32 * j < nw0 ? wp[k * RB4 + lane + 32 * j]
                                                : 0u;
        if (lane == 0 && 32 * gj < nw0) xc = wp[k * RB4 + 32 * gj];
        irv_push<GJ>(ring, ringt, GB, gj, w0 + k, lane, wc, xc,
                     8 * (off0 & 3), st[k * RB + off0 + B], mask, acc, acct);
      }
    } else {
#pragma unroll
      for (int k = 0; k < IRV_ROWS; ++k) {
        const int i = i0 + k;
        uint32_t wc[GJ], xc = 0u, tc = 0u;
        int sh = 0;
#pragma unroll
        for (int j = 0; j < GJ; ++j) wc[j] = 0u;
        if (i < r1) {                    // rows past the frame: zero rows
          const int off = (int)((vol_lo + (unsigned)((size_t)i * W + x0) *
                                              (unsigned)C) & 15u) + col;
          const uint8_t* pr = st + k * RB;
          const uint32_t* wp =
              reinterpret_cast<const uint32_t*>(pr) + (off >> 2);
          const int nw = (((off & 3) + B - 1) >> 2) + 1;
#pragma unroll
          for (int j = 0; j < GJ; ++j)
            if (j < gj && lane + 32 * j < nw) wc[j] = wp[lane + 32 * j];
          if (lane == 0 && 32 * gj < nw) xc = wp[32 * gj];
          tc = pr[off + B];
          sh = 8 * (off & 3);
        }
        irv_push<GJ>(ring, ringt, GB, gj, w0 + k, lane, wc, xc, sh, tc, mask,
                     acc, acct);
      }
    }
    __syncwarp();                        // the warp is past stage s
    if (lane == 0) stm_bar_arrive(empty + s);
    // the newest prefix, row i0 + IRV_ROWS, sits in slot w0 + IRV_ROWS - 1
    irv_votes<GJ, IRV_VOTE_GROUP>(
        ring, ringt, GB, gj, N, w0 + IRV_ROWS - 1, i0 + IRV_ROWS, voters,
        win, pc.d, mask, lane, i0 - reach, x, W, zd, thresh_s, thresh_h,
        disp_out, outl_out);
    w0 = w0 + IRV_ROWS == N ? 0 : w0 + IRV_ROWS;
  }
}

// Register path: grid (ceil(W / warps), ceil(H / IRV_SEG)), a warp takes
// one column of the block's row segment and streams its runs.  Staged
// path: grid (ceil(W / S), ceil(H / seg)), a block takes a strip of S
// columns and a segment of seg rows (whole tiles): S consumer warps, one a
// column, and the producer warp, which streams the strip's runs (those of
// its columns' voters taken together: a consumer also pushes rows its own
// column's votes do not read, whose spans the gated B8 may have left
// undefined; a prefix difference never spans them) through K stages of
// IRV_ROWS rows of RB bytes.  Shared memory: the stages, then each
// consumer's rings, then the stages' full and empty barriers.
template <int GJ, bool STAGED>
__global__ void __launch_bounds__(STAGED ? 32 * (IRV_STRIP + 1)
                                         : 32 * IRV_VOTE_WARPS,
                                  STAGED ? 1 : 5)
irv_vote_kernel(const uint8_t* __restrict__ cnt,
                const float* __restrict__ disp,
                const uint8_t* __restrict__ outl, const int* __restrict__ up,
                const int* __restrict__ down, const uint8_t* __restrict__ need,
                const uint16_t* __restrict__ live,
                float* __restrict__ disp_out, uint8_t* __restrict__ outl_out,
                int H, int W, int B, int zd, int reach, int N, int thresh_s,
                float thresh_h, int S, int K, int RB, int seg) {
  extern __shared__ __align__(16) unsigned char vsmem[];
  const int warp = threadIdx.x >> 5;
  const int GB = (B + 3) / 4;
  const size_t ring_bytes = (size_t)N * (8 * GB + 4);
  if constexpr (!STAGED) {
    const int x = blockIdx.x * (blockDim.x >> 5) + warp;
    if (x >= W) return;                  // a whole warp: no barrier below
    uint2* ring = reinterpret_cast<uint2*>(vsmem + warp * ring_bytes);
    uint32_t* ringt = reinterpret_cast<uint32_t*>(ring + (size_t)N * GB);
    const int y0 = blockIdx.y * IRV_SEG;
    irv_runs(live, W, x, 1, y0, min(y0 + IRV_SEG, H), reach,
             [&](int a, int b) {
               irv_vote_run<GJ>(cnt, disp, outl, up, down, need, disp_out,
                                outl_out, H, W, B, zd, reach, N, thresh_s,
                                thresh_h, x, a, b, ring, ringt);
             });
  } else {
    const int x0 = blockIdx.x * S, nS = min(S, W - x0);
    uint8_t* stages = vsmem;
    unsigned char* rings = vsmem + (size_t)K * IRV_ROWS * RB;
    uint64_t* full = reinterpret_cast<uint64_t*>(rings + S * ring_bytes);
    uint64_t* empty = full + K;
    if (threadIdx.x == 0) {
      for (int s = 0; s < K; ++s) {
        stm_bar_init(full + s, 1);
        stm_bar_init(empty + s, nS);
      }
      stm_bar_init_fence();
    }
    __syncthreads();
    const int y0 = blockIdx.y * seg, y1 = min(y0 + seg, H);
    IrvStageAt at = {0, 0u, false};      // the block's batches so far
    if (warp == S) {                     // the producer
      irv_runs(live, W, x0, nS, y0, y1, reach, [&](int a, int b) {
        irv_produce_run(cnt, stages, full, empty, K, RB, H, W, B + 1, reach,
                        x0, nS, a, b, at);
      });
      return;
    }
    if (warp >= nS) return;              // past the frame's last column
    uint2* ring = reinterpret_cast<uint2*>(rings + warp * ring_bytes);
    uint32_t* ringt = reinterpret_cast<uint32_t*>(ring + (size_t)N * GB);
    const unsigned vol_lo =
        (unsigned)(reinterpret_cast<uintptr_t>(cnt) & 15u);
    irv_runs(live, W, x0, nS, y0, y1, reach, [&](int a, int b) {
      irv_vote_staged_run<GJ>(stages, full, empty, K, RB, vol_lo, x0, disp,
                              outl, up, down, need, disp_out, outl_out, H, W,
                              B, zd, reach, N, thresh_s, thresh_h, x0 + warp,
                              a, b, ring, ringt, at);
    });
  }
}

// The launch at B, reach and W (0: any).  Staged path (K >= IRV_KMIN):
// strips of S <= IRV_STRIP columns, rings of N >= 2 * reach + 2 +
// IRV_ROWS slots (a multiple of IRV_ROWS) for each, K <= IRV_KMAX stages
// of IRV_ROWS rows of RB bytes (a strip's bytes rounded out to 16-byte
// bounds); of the (blocks an SM, S) whose rings and IRV_KMIN stages fit,
// the most consumer warps an SM, two blocks an SM on a tie, with as many
// stages as fit, and S <= W / IRV_MIN_STRIPS where W allows (a narrow
// frame gives the card more, smaller blocks).  Else the register path (K
// = 0): `warps` columns a block, rings of N = 2 * reach + 2 + its batch.
struct IrvPlan {
  int S, K, N, RB, warps;
  size_t smem;
};

static int irv_plan(int B, int reach, int W, IrvPlan& p) {
  const int C = B + 1, GB = (B + 3) / 4;
  const size_t slot = 8 * (size_t)GB + 4;
  p.N = (2 * reach + 2 + 2 * IRV_ROWS - 1) / IRV_ROWS * IRV_ROWS;
  p.K = 0;
  int best = 0;
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    const size_t budget = per_sm == 2
        ? IRV_SMEM_SM / 2 - IRV_BLOCK_RESERVED : (size_t)IRV_SMEM_MAX;
    for (int S = W > 0 ? min(IRV_STRIP, max(W / IRV_MIN_STRIPS, 1))
                       : IRV_STRIP;
         S >= 1; --S) {
      const int RB = (S * C + 30) / 16 * 16;
      const size_t rings = (size_t)S * p.N * slot;
      const size_t stage = (size_t)IRV_ROWS * RB + 16;   // and 2 barriers
      if (per_sm * S <= best || rings + IRV_KMIN * stage > budget) continue;
      best = per_sm * S;
      p.S = S;
      p.RB = RB;
      p.K = (int)min((budget - rings) / stage, (size_t)IRV_KMAX);
      p.smem = rings + p.K * stage;
      p.warps = S + 1;
    }
  }
  if (p.K > 0) return 0;
  p.N = 2 * reach + 2 + IRV_STEP;
  const size_t per_warp = p.N * slot;
  p.warps = (int)min((size_t)IRV_VOTE_WARPS, IRV_SMEM_MAX / per_warp);
  p.smem = p.warps * per_warp;
  return p.warps > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// The stages the staged path takes at B and reach (0: the register path;
// -1: no launch): the path that `irv_vote.staged` counts (ops/irv.py).
STM_API int stm_irv_vote_stages(int B, int reach) {
  IrvPlan p;
  return irv_plan(B, reach, 0, p) ? -1 : p.K;
}

// Rows of a staged block's segment: whole tiles, about equal, at most
// IRV_SSEG.
static int irv_segment(int H) {
  const int nseg = (H + IRV_SSEG - 1) / IRV_SSEG;
  return ((H + nseg - 1) / nseg + IRV_TILE - 1) / IRV_TILE * IRV_TILE;
}

template <int GJ, bool STAGED>
static cudaError_t irv_vote_launch(const IrvPlan& p, cudaStream_t s,
                                   const void* cnt, const void* disp,
                                   const void* outl, const void* up,
                                   const void* down, const void* need,
                                   const void* live, void* disp_out,
                                   void* outl_out, int H, int W, int B,
                                   int zd, int reach, int thresh_s,
                                   float thresh_h) {
  auto kernel = irv_vote_kernel<GJ, STAGED>;
  cudaError_t err = stm_smem_cap(kernel, p.smem);
  if (err != cudaSuccess) return err;
  int seg = IRV_SEG;
  dim3 grid((W + p.warps - 1) / p.warps, (H + IRV_SEG - 1) / IRV_SEG);
  if (STAGED) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    seg = irv_segment(H);
    grid = dim3((W + p.S - 1) / p.S, (H + seg - 1) / seg);
  }
  kernel<<<grid, 32 * p.warps, p.smem, s>>>(
      (const uint8_t*)cnt, (const float*)disp, (const uint8_t*)outl,
      (const int*)up, (const int*)down, (const uint8_t*)need,
      (const uint16_t*)live, (float*)disp_out, (uint8_t*)outl_out, H, W, B,
      zd, reach, p.N, thresh_s, thresh_h, p.S, p.K, p.RB, seg);
  return cudaGetLastError();
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
  IrvPlan p;
  if (H <= 0 || H > 65535 || W <= 0 || B <= 0 || GJ > 8 || reach < 0 ||
      reach > 127 || ((uintptr_t)cnt & 3) != 0 || live == nullptr ||
      irv_plan(B, reach, W, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  irv_live(need, outl, disp, live, disp_out, outl_out, H, W, s);
  // staged: one lane group (C <= 129, every preset), two (C <= 257), or
  // one kernel of eight that runs the groups this B has; the register
  // path (only B >= 425 at a long reach takes it): one kernel of eight
#define IRV_VOTE_ARGS                                                       \
  p, s, cnt, disp, outl, up, down, need, live, disp_out, outl_out, H, W, B, \
      zd, reach, thresh_s, thresh_h
  const cudaError_t err =
      p.K > 0 ? (GJ == 1   ? irv_vote_launch<1, true>(IRV_VOTE_ARGS)
                 : GJ == 2 ? irv_vote_launch<2, true>(IRV_VOTE_ARGS)
                           : irv_vote_launch<8, true>(IRV_VOTE_ARGS))
              : irv_vote_launch<8, false>(IRV_VOTE_ARGS);
#undef IRV_VOTE_ARGS
  return (int)err;
}

// ---- G3: the frontier between rounds ------------------------------------
//
// Replaces the XLA glue stereo_to_multiview_tpu/ops/band.py:1238
// `_dilate_cheb` (no Pallas body), which the port ran as about seven torch
// ops a round and eye (`dilate_frontier(after != before, usd)`, ops/irv.py).
// need[y][x] = 1 iff a pixel whose label differs between `before` and
// `after` lies in an 8x8 block (partial at the right and bottom edges)
// within r = ceil(usd / 8) + 1 blocks of block (y / 8, x / 8) on both
// axes (Chebyshev), else 0.
// Bound: bytes, two u8 planes read and one written (6.2 MB at 1080p, 1.9 us
// at 3.35 TB/s); one launch in place of seven.  A block takes a tile of 16 x
// 16 blocks (128 x 128 pixels) and its halo of r blocks: a warp a halo
// block row, each lane two adjacent blocks (16 bytes of each of their 8
// rows in both planes: one 16-byte load each where W % 16 == 0 and the
// planes are 16-byte aligned, else byte loads), the lanes' changed bits
// joined by two OR reductions into one 64-bit mask a block row (bit j:
// block column hx0 + j, hx0 the tile's first block column less r rounded
// up to even, so that a lane's 16 bytes are aligned).  One thread an output
// block row then ORs the 2r + 1 masks of its reach and the 2r + 1 shifts of
// that; the tile goes out 16 bytes (one row of two blocks) a store.  The
// halo's bytes are read again by the tiles beside it, mostly from L2.  Its
// time is the chain of those three steps, not bytes: 32 warps a block, so
// that each takes one halo row up to r = 8, took a 1080p call from 6.6 to
// 5.1 us on an H100 (16 warps, two rows each; a 1x1 frame takes 2.6 us).

#define G3_GRAIN 8                // pixels a block side
#define G3_TILE 16                // blocks a tile side
#define G3_THREADS 1024
#define G3_RMAX 17                // r at usd 127

template <bool VEC>
__global__ void __launch_bounds__(G3_THREADS)
irv_frontier_kernel(const uint8_t* __restrict__ before,
                    const uint8_t* __restrict__ after,
                    uint8_t* __restrict__ need, int H, int W, int r) {
  __shared__ unsigned long long rows[G3_TILE + 2 * G3_RMAX];
  __shared__ unsigned tile[G3_TILE];
  const int nbh = (H + G3_GRAIN - 1) / G3_GRAIN;
  const int by0 = blockIdx.y * G3_TILE, bx0 = blockIdx.x * G3_TILE;
  const int s = r + (r & 1);      // block columns from hx0 to the tile
  const int hx0 = bx0 - s;
  const int pairs = (s + G3_TILE + r + 1) / 2;    // <= 26 lanes
  const int lane = threadIdx.x % 32;
  const int x0 = (hx0 + 2 * lane) * G3_GRAIN;
  for (int hy = threadIdx.x / 32; hy < G3_TILE + 2 * r;
       hy += G3_THREADS / 32) {
    const int by = by0 - r + hy;
    unsigned bits = 0;            // bit 0: block 2 lane, bit 1: the next
    if (by >= 0 && by < nbh && lane < pairs && x0 >= 0 && x0 < W) {
      const int y0 = by * G3_GRAIN, n = min(G3_GRAIN, H - y0);
      if (VEC) {
        unsigned lo = 0, hi = 0;
#pragma unroll
        for (int k = 0; k < G3_GRAIN; ++k) {
          if (k < n) {
            const size_t i = (size_t)(y0 + k) * W + x0;
            const uint4 a = *reinterpret_cast<const uint4*>(before + i);
            const uint4 b = *reinterpret_cast<const uint4*>(after + i);
            lo |= (a.x ^ b.x) | (a.y ^ b.y);
            hi |= (a.z ^ b.z) | (a.w ^ b.w);
          }
        }
        bits = (lo != 0) | (hi != 0) << 1;
      } else {
        const int nx = min(2 * G3_GRAIN, W - x0);
        for (int k = 0; k < n; ++k) {
          const size_t i = (size_t)(y0 + k) * W + x0;
          for (int c = 0; c < nx; ++c)
            bits |= (before[i + c] != after[i + c]) << (c / G3_GRAIN);
        }
      }
    }
    const unsigned lo = __reduce_or_sync(0xFFFFFFFFu,
                                         lane < 16 ? bits << 2 * lane : 0u);
    const unsigned hi = __reduce_or_sync(
        0xFFFFFFFFu, lane < 16 ? 0u : bits << 2 * (lane - 16));
    if (lane == 0) rows[hy] = (unsigned long long)hi << 32 | lo;
  }
  __syncthreads();
  if (threadIdx.x < G3_TILE) {
    unsigned long long v = 0;
    for (int k = 0; k <= 2 * r; ++k) v |= rows[threadIdx.x + k];
    unsigned long long d = v;
    for (int k = 1; k <= r; ++k) d |= v >> k | v << k;
    tile[threadIdx.x] = (unsigned)(d >> s) & 0xFFFFu;
  }
  __syncthreads();
  constexpr int CHUNKS = G3_TILE / 2;     // 16-byte chunks a tile row
  for (int t = threadIdx.x; t < G3_TILE * G3_GRAIN * CHUNKS;
       t += G3_THREADS) {
    const int y = by0 * G3_GRAIN + t / CHUNKS;
    const int x = (bx0 + 2 * (t % CHUNKS)) * G3_GRAIN;
    if (y >= H || x >= W) continue;
    const unsigned m = tile[t / CHUNKS / G3_GRAIN] >> 2 * (t % CHUNKS);
    const size_t i = (size_t)y * W + x;
    if (VEC) {
      const unsigned lo = m & 1 ? 0x01010101u : 0u;
      const unsigned hi = m & 2 ? 0x01010101u : 0u;
      *reinterpret_cast<uint4*>(need + i) = make_uint4(lo, lo, hi, hi);
    } else {
      const int nx = min(2 * G3_GRAIN, W - x);
      for (int c = 0; c < nx; ++c) need[i + c] = m >> (c / G3_GRAIN) & 1;
    }
  }
}

// before, after (H, W) u8: a round's labels before and after it; need (H,
// W) u8 out, 0 or 1 a pixel; 0 <= usd <= 127.
STM_API int stm_irv_frontier(const void* before, const void* after,
                             void* need, int H, int W, int usd,
                             void* stream) {
  if (H <= 0 || W <= 0 || usd < 0 || usd > 127)
    return (int)cudaErrorInvalidValue;
  const int r = (usd + G3_GRAIN - 1) / G3_GRAIN + 1;
  const int nbh = (H + G3_GRAIN - 1) / G3_GRAIN;
  const int nbw = (W + G3_GRAIN - 1) / G3_GRAIN;
  const dim3 grid((nbw + G3_TILE - 1) / G3_TILE,
                  (nbh + G3_TILE - 1) / G3_TILE);
  const bool vec = W % 16 == 0 &&
                   (((uintptr_t)before | (uintptr_t)after | (uintptr_t)need)
                    & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    irv_frontier_kernel<true><<<grid, G3_THREADS, 0, s>>>(
        (const uint8_t*)before, (const uint8_t*)after, (uint8_t*)need, H, W,
        r);
  else
    irv_frontier_kernel<false><<<grid, G3_THREADS, 0, s>>>(
        (const uint8_t*)before, (const uint8_t*)after, (uint8_t*)need, H, W,
        r);
  return (int)cudaGetLastError();
}
