// B15: window sums of a float volume along one axis, in bf16 terms.
//
// Replaces the TPU kernel stereo_to_multiview_tpu/ops/band.py `_res_kernel`
// in mode "float" (reached via `band_span_sum_h` / `band_span_sum_v`, and
// through them `dr_irv_band` / `dr_irv_band_lr`).
//
// vol is (H, W, D) float32; the summed axis is x (the H pass) or y (the V
// pass), the other image axis indexes independent lines, d is innermost.
//   out[p] = sum over j in [max(p - an, 0), min(p + ap + incl, n)) of t[j]
//   t = recombination of nsplit successive bf16 remainders of vol:
//       r = x; t = bf16(r); r -= bf16(r); t += bf16(r); ...   (each
//       bf16() rounds to nearest even, every add rounded on its own)
// with an, ap the (H, W) arms of p clamped to [0, max_arm].  The TPU kernel
// takes the same terms into banded 0/1 bf16 matrix products on the MXU;
// here each window is summed directly in float32 from 0.0 in ascending
// position order, no prefix differences (a 1920-long float prefix loses
// the last bits of a short window) and no FMA, so the plain PyTorch
// version that adds the shifted planes in the same order is bit-equal.
//
// Bound on the H100: bytes.  At 1080p/D=128 with both eyes stacked (2160
// lines) the call reads and writes 2.12 GB each, ~1.27 ms at 3.35 TB/s;
// the adds (window length x elements) stay under a fifth of that at 67 T/s.
// Design: a block takes 128 positions of one line for 32 consecutive d
// (one warp's lanes, so every load and store is 128 contiguous bytes in
// either pass) and stages its window, 128 + 2 * (max_arm + 1) positions,
// in shared memory, splitting each element into its bf16 terms once as it
// is staged.  Each of the 8 warps then owns every 8th position: the
// window bounds depend on (y, x) only, so a warp's 32 lanes share them and
// loop without divergence, one shared-memory read and one add a step.

#include <cuda_bf16.h>

#include "stm_common.cuh"

#define SPAN_TN 128        // positions along the summed axis a block
#define SPAN_LANES 32      // d a block
#define SPAN_WARPS 8
#define SPAN_MAX_ARM 64

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The float32 recombination of x's nsplit bf16 terms.
__device__ __forceinline__ float split_terms(float x, int nsplit) {
  float part = bf16_rn(x);
  float t = part;
  float r = x;
  for (int k = 1; k < nsplit; ++k) {
    r = __fsub_rn(r, part);
    part = bf16_rn(r);
    t = __fadd_rn(t, part);
  }
  return t;
}

// n positions along the summed axis at element stride sn; line o starts at
// element o * so; the arm of (line o, position p) is at o * ao + p * ap_.
__global__ void __launch_bounds__(SPAN_LANES * SPAN_WARPS)
span_sum_kernel(const float* __restrict__ vol, const int* __restrict__ arm_neg,
                const int* __restrict__ arm_pos, float* __restrict__ out,
                int n, long long sn, long long so, int ao, int ap_, int D,
                int max_arm, int incl, int nsplit) {
  extern __shared__ float stage[];       // (SPAN_TN + 2R) x SPAN_LANES
  const int R = max_arm + 1;
  const int p0 = blockIdx.x * SPAN_TN;
  const size_t line = (size_t)blockIdx.y * so;
  const int lane = threadIdx.x;
  const int d = blockIdx.z * SPAN_LANES + lane;
  const bool live = d < D;
  const int rows = SPAN_TN + 2 * R;
  for (int r = threadIdx.y; r < rows; r += SPAN_WARPS) {
    const int p = p0 - R + r;
    float v = 0.0f;
    if (live && p >= 0 && p < n)
      v = split_terms(vol[line + (size_t)p * sn + d], nsplit);
    stage[r * SPAN_LANES + lane] = v;
  }
  __syncthreads();

  const int np = min(SPAN_TN, n - p0);
  const float* col = stage + lane;
  for (int i = threadIdx.y; i < np; i += SPAN_WARPS) {
    const int p = p0 + i;
    const size_t a = (size_t)blockIdx.y * ao + (size_t)p * ap_;
    const int neg = min(max(arm_neg[a], 0), max_arm);
    const int pos = min(max(arm_pos[a], 0), max_arm);
    const int lo = max(p - neg, 0);
    const int hi = min(p + pos + incl, n);
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j)
      acc = __fadd_rn(acc, col[(j - p0 + R) * SPAN_LANES]);
    if (live) out[line + (size_t)p * sn + d] = acc;
  }
}

// vol, out: (H, W, D) f32 contiguous; arm_neg, arm_pos: (H, W) i32;
// axis 1 sums along x (the H pass), axis 0 along y (the V pass);
// incl != 0 closes the window's right end; 1 <= nsplit <= 3;
// max_arm <= 64.
STM_API int stm_span_sum(const void* vol, const void* arm_neg,
                         const void* arm_pos, void* out, int H, int W, int D,
                         int axis, int max_arm, int incl, int nsplit,
                         void* stream) {
  if (H <= 0 || W <= 0 || D <= 0 || (axis != 0 && axis != 1) ||
      max_arm < 0 || max_arm > SPAN_MAX_ARM || nsplit < 1 || nsplit > 3)
    return (int)cudaErrorInvalidValue;
  const long long row = (long long)W * D;
  // H pass: lines are rows y, positions x; V pass: lines are columns x.
  const int n = axis == 1 ? W : H;
  const int lines = axis == 1 ? H : W;
  const long long sn = axis == 1 ? D : row;
  const long long so = axis == 1 ? row : D;
  const int ao = axis == 1 ? W : 1;
  const int ap_ = axis == 1 ? 1 : W;
  if (lines > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(SPAN_TN + 2 * (max_arm + 1)) * SPAN_LANES * sizeof(float);
  cudaError_t err = stm_smem_cap(span_sum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + SPAN_TN - 1) / SPAN_TN, lines,
            (D + SPAN_LANES - 1) / SPAN_LANES);
  dim3 block(SPAN_LANES, SPAN_WARPS);
  span_sum_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)vol, (const int*)arm_neg, (const int*)arm_pos,
      (float*)out, n, sn, so, ao, ap_, D, max_arm, incl ? 1 : 0, nsplit);
  return (int)cudaGetLastError();
}
