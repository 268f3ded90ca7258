// B1's rows on the tensor-core block (tc_score_block.cuh): the shared
// memory a DH kernel adds to the block, and the FK into a row, the
// backward from its sums and its stores, run by one thread a row. B1 (dh_score.cu), B6
// (dh_dual_score.cu) and B7 (dh_ablation.cu) run on them.
#pragma once

#include "dh_chain.cuh"
#include "tc_score_block.cuh"

namespace diffco {

// How product 2 sums over the chunks at each FP (tc_score_block.cuh's
// kSums). One accumulator over all supports lost dq precision as S grew
// (PERF.md section 6): per-chunk sums in registers where ptxas keeps the
// kernel within 128 registers unspilled, else with the running sums in
// shared memory.
template <int FP>
constexpr int kDhSums = FP == 24 ? kTcSumsShared : kTcSumsRegs;

// The kernel's dynamic shared memory: the block's (TcSmem<FP>), then each
// row's joint axes and origins (az, ao: 3 kMaxJ floats each) at an odd
// stride, then kTcSumsShared's running sums where kSums takes them.
template <int FP, int kSums = kDhSums<FP>>
struct DhSmem {
  static constexpr int kAxesStride = 6 * kMaxJ + 1;
  static constexpr int kAxes = TcSmem<FP>::kFloats;
  static constexpr int kRun = kAxes + kTcRows * kAxesStride;
  static constexpr int kFloats =
      kRun + (kSums == kTcSumsShared ? TcSmem<FP>::kRunFloats : 0);
  static constexpr int kBytes = 4 * kFloats;
};

// FK of configuration b (q = 0 where !live) into its row's points xrow
// [FP] (zeros past F) and its joint axes and origins, axes [6 kMaxJ]
template <int FP>
__device__ __forceinline__ void dh_row_fk(const float* __restrict__ q, int b,
                                          bool live, const DHSpec& sp,
                                          float* xrow, float* axes) {
  constexpr int KP = FP / 3 < kMaxP ? FP / 3 : kMaxP;
  float qr[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = (live && j < sp.J) ? q[static_cast<size_t>(b) * sp.J + j] : 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) xrow[f] = 0.f;
  dh_chain<KP>(qr, sp, xrow, axes, axes + 3 * kMaxJ);
}

// The backward of row `row` after tc_score_block on the block at smem:
// its points back in their own frame (x~ + c), then dq from its sums.
// kCentred: the sums are su~ (tc_row_sums turns them into su); false for
// the bf16 product 2, whose sums are su already.
template <int FP, bool kCentred = true>
__device__ __forceinline__ void dh_row_backward(float* smem, int row,
                                                const DHSpec& sp, float* xrow,
                                                const float* axes,
                                                float (&dqr)[kMaxJ]) {
  using L = TcSmem<FP>;
  constexpr int KP = FP / 3 < kMaxP ? FP / 3 : kMaxP;
  const int F = 3 * sp.P;
#pragma unroll
  for (int f = 0; f < FP; ++f) xrow[f] += smem[L::kCen + f];  // x~ + c
  const float* su = kCentred ? tc_row_sums<FP>(smem, row, F)
                             : smem + L::kSu + row * L::kSuS;
  dh_backward<KP>(sp, xrow, axes, axes + 3 * kMaxJ, su[F], su, dqr);
}

// Row `row`'s score (after tc_score_block on the block at smem) and dq,
// stored as configuration b's where live
template <int FP>
__device__ __forceinline__ void dh_row_store(const float* smem, int row,
                                             int b, bool live,
                                             const DHSpec& sp,
                                             const float (&dqr)[kMaxJ],
                                             float* __restrict__ score,
                                             float* __restrict__ dq) {
  if (live) {
    score[b] = smem[TcSmem<FP>::kScore + row];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < sp.J) dq[static_cast<size_t>(b) * sp.J + j] = dqr[j];
  }
}

}  // namespace diffco
