// Ablations of kernel B1 (csrc/dh_score.cu) for the roofline path, written
// by hand for Hopper.
//
// Replaces: scripts/roofline_fk_score.py::_ablation_call (bodies
// make_ablations and make_mv_full), the TPU kernels that attribute B1's
// time to its stages. Each rung is a prefix of B1's production kernel,
// dh_score_tc_kernel: the same block of 128 configurations and 256
// threads with two blocks per SM, the same FK into the block's rows
// (dh_tc_rows.cuh), the same cp.async double buffer and product 1 in
// 3xTF32 with the near-pair guard (tc_score_block.cuh, stopped after
// the rung's stage by its kStage). Each rung writes one float per
// configuration, which depends on all the work the rung claims, so that
// nvcc removes none of it:
//
//   kFkOnly      sum over the points' components x + y + z   (FK)
//   kDot         sum_j s_j . x, from the centred products     (+ product 1)
//   kDotRsqrt    sum_j (r_j + 1 / r_j), d2 from the expanded
//                square with the guard, one rsqrt a pair      (+ d2, rsqrt)
//   kFwd         B1's score, sum_j w_j r_j with TwoSum       (+ the score)
//   kFullF32Mv   B1's score + sum_i dq_i                     (B1 in full)
//   kFullBf16Mv  kFullF32Mv with product 2 as one mma.sync.m16n8k16 bf16
//                product of bf16(1/r) and the uncentred bf16([s w | w])
//                (fp32 accumulation), and the score of bf16(r) bf16(w):
//                the reference's make_mv_full(mv_f32=False)
//
// kDot is the reference's second rung again (its matrix-unit dot, summed);
// the block computes x~ . s~ for centred rows and supports and adds the
// centre back: sum_j s~_j . x~ + c . sum_j s~_j + S c . x~ + S |c|^2.
// Only the kFull rungs run product 2 and the backward, as B1 does.
//
// What bounds it on this card: the products on the tensor cores with the
// pair work beside them on the fp32 CUDA cores for every rung past
// kFkOnly (ops/bounds.py::ablation_tc_bound), the bytes in and out (~2 MB)
// for kFkOnly. Built for FP = 24 only (DH robots with 6 to 8 control
// points, PandaFK's 21 components padded): measurement kernels of the
// roofline path's one shape.
#include <cuda_runtime.h>

#include "dh_tc_rows.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {
namespace {

constexpr int kAblFP = 24;

enum AblationMode : int {
  kFkOnly = 0,
  kDot = 1,
  kDotRsqrt = 2,
  kFwd = 3,
  kFullF32Mv = 4,
  kFullBf16Mv = 5,
};

// the block's stage for each rung past kFkOnly
template <int MODE>
constexpr int kAblStage = MODE == kDot        ? kTcStageDot
                          : MODE == kDotRsqrt ? kTcStageRsqrt
                          : MODE == kFwd      ? kTcStageScore
                                              : kTcStageFull;

template <int MODE>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
dh_ablation_kernel(const float* __restrict__ q, const float* __restrict__ s,
                   const float* __restrict__ w, float* __restrict__ out,
                   int B, int S, const __grid_constant__ DHSpec sp) {
  constexpr int FP = kAblFP;
  constexpr bool kBf16 = MODE == kFullBf16Mv;
  using L = TcSmem<FP>;
  using M = DhSmem<FP>;
  float* smem = diffco_tc_smem;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kTcRows + tid;
  const bool live = b < B;
  const int F = 3 * sp.P;
  float* xrow = smem + L::kX + tid * L::kXS;
  float* axes = smem + M::kAxes + tid * M::kAxesStride;
  if constexpr (MODE == kFkOnly) {
    if (tid < kTcRows) {
      dh_row_fk<FP>(q, b, live, sp, xrow, axes);
      // x is zero past 3P, so this is the reference's sum over the points
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < FP; ++f) acc += xrow[f];
      if (live) out[b] = acc;
    }
  } else {
    if (S > 0) tc_stage<FP>(s, w, 0, S, F, smem, 0);
    if (tid < kTcRows) dh_row_fk<FP>(q, b, live, sp, xrow, axes);
    tc_score_block<FP, false, kDhSums<FP>, kAblStage<MODE>,
                   kBf16 ? kTcP2Bf16 : kTcP2Tf32x3>(
        s, w, S, F, smem, kTcGuard, nullptr, smem + M::kRun);
    if (tid < kTcRows) {
      float acc = smem[L::kScore + tid];
      if constexpr (kAblStage<MODE> == kTcStageFull) {
        float dqr[kMaxJ];
        dh_row_backward<FP, !kBf16>(smem, tid, sp, xrow, axes, dqr);
#pragma unroll
        for (int j = kMaxJ - 1; j >= 0; --j)
          if (j < sp.J) acc += dqr[j];
      }
      if (live) out[b] = acc;
    }
  }
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

namespace diffco {
namespace {

// Launches rung MODE over B configurations on `st`; the cudaError_t.
template <int MODE>
int ablation_launch(const float* q, const float* s, const float* w,
                    float* out, int B, int S, const DHSpec& sp,
                    cudaStream_t st) {
  const auto kernel = dh_ablation_kernel<MODE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DhSmem<kAblFP>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kTcRows - 1) / kTcRows, kTcThreads, DhSmem<kAblFP>::kBytes,
           st>>>(q, s, w, out, B, S, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace diffco

// out [B] = the mode's one float per configuration (modes as the enum
// above). Returns the cudaError_t of the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int dh_ablation(const float* q, const float* s, const float* w,
                           float* out, int B, int S, int mode,
                           const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || sp.J < 1 || sp.J > diffco::kMaxJ ||
      (3 * sp.P + 7) / 8 * 8 != diffco::kAblFP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_ABL_CASE(M) \
  case diffco::M:          \
    return diffco::ablation_launch<diffco::M>(q, s, w, out, B, S, sp, st);
  switch (mode) {
    DIFFCO_ABL_CASE(kFkOnly)
    DIFFCO_ABL_CASE(kDot)
    DIFFCO_ABL_CASE(kDotRsqrt)
    DIFFCO_ABL_CASE(kFwd)
    DIFFCO_ABL_CASE(kFullF32Mv)
    DIFFCO_ABL_CASE(kFullBf16Mv)
    default:
      return cudaErrorInvalidValue;
  }
#undef DIFFCO_ABL_CASE
}
