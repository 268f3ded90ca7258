// Point-space polyharmonic score + gradient, written by hand for Hopper.
//
// Replaces: diffco_tpu/ops/fused_score.py::_poly_score_grad_pallas (body
// _make_fwdgrad_kernel), the TPU kernel behind polyharmonic_score at
// batch >= 16384.
//
// Computes, for x [B, F], s [S, F], w [S] (fp32, row-major, F <= 64):
//   score[b] = sum_j w_j ||x_b - s_j||,  dx[b] = x_b * sum_j w_j / r_bj
//                                               - sum_j s_j w_j / r_bj.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, F = 21) the function needs about B*S*(4F + 11)
// operations, rsqrt included (~3.2 GFLOP, counted in the TPU kernel's
// expanded form ||x||^2 + ||s||^2 - 2 x.s), and moves ~11 MB in and out.
// ~4F of the per-pair operations are the two matrix products that the
// TPU kernel runs on its MXU (the cross term x . s and the [s w | w]
// sums); on this card they run on the tensor cores, and the ~15 others
// per pair on the CUDA cores (ops/bounds.py::tc_times).
//
// Design (poly_score_tc_kernel): the score block of tc_score_block.cuh,
// B1's without the FK and the backward. 128 rows and 256 threads per
// block, two blocks (16 warps) per SM; both products on the tensor cores
// in 3xTF32. The block's threads copy its rows of x into the block's
// shared rows (components F..FP-1 zero, FP = F padded to a multiple of 8,
// 8 to 64); rows past B are copies of row B - 1, so that the block's
// centre (the mean of its rows) stays on the data. After the supports,
// dx = x~ rowsum - su~ in the block's centred frame (su~ = su - c rowsum),
// which needs no centre added back. Up to FP = 48 product 2 accumulates
// chunk by chunk (tc_score_block.cuh's kChunkSums), which the fitted
// FrankaPanda sweep's gradient needs.
#include <cuda_runtime.h>

#include "tc_score_block.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {
namespace {

// B2 on the tensor-core score block (file comment). kMeasure: a
// measurement build that counts the near-pair guard's recomputations
// into *guard_pairs, with kappa as its threshold.
template <int FP, bool kMeasure>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
poly_score_tc_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ w, float* __restrict__ score,
                     float* __restrict__ dx, int B, int S, int F, float kappa,
                     unsigned long long* guard_pairs) {
  using L = TcSmem<FP>;
  float* smem = diffco_tc_smem;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kTcRows;
  const int live = min(kTcRows, B - b0);   // rows of the block below B
  if (S > 0) tc_stage<FP>(s, w, 0, S, F, smem, 0);
  // the block's rows, consecutive threads on consecutive components; a
  // row past B reads row B - 1
  for (int i = tid; i < kTcRows * FP; i += kTcThreads) {
    const int r = i / FP, f = i % FP;
    const size_t b = b0 + min(r, live - 1);
    smem[L::kX + r * L::kXS + f] = f < F ? x[b * F + f] : 0.f;
  }
  // product 2 by chunks where its accumulator fits (kTcChunkMaxFP)
  tc_score_block<FP, kMeasure,
                 (FP <= kTcChunkMaxFP ? kTcSumsRegs : kTcSumsOne)>(
      s, w, S, F, smem, kappa, guard_pairs);
  // dx = x~ rowsum - su~ (rowsum at column F of the row's sums)
  for (int i = tid; i < live * FP; i += kTcThreads) {
    const int r = i / FP, f = i % FP;
    const float* su = smem + L::kSu + r * L::kSuS;
    if (f < F)
      dx[static_cast<size_t>(b0 + r) * F + f] =
          fmaf(smem[L::kX + r * L::kXS + f], su[F], -su[f]);
  }
  if (tid < live) score[b0 + tid] = smem[L::kScore + tid];
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

namespace diffco {
namespace {

// Launches B2's kernel over B rows on `st`; the cudaError_t, 0 on
// success.
template <int FP, bool kMeasure>
int poly_launch(const float* x, const float* s, const float* w, float* score,
                float* dx, int B, int S, int F, float kappa,
                unsigned long long* guard_pairs, cudaStream_t st) {
  const auto kernel = poly_score_tc_kernel<FP, kMeasure>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TcSmem<FP>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kTcRows - 1) / kTcRows, kTcThreads, TcSmem<FP>::kBytes,
           st>>>(x, s, w, score, dx, B, S, F, kappa, guard_pairs);
  return static_cast<int>(cudaGetLastError());
}

// out = {dynamic shared bytes per block, blocks resident per SM by the
// runtime's occupancy calculator, threads per block, rows per block};
// the cudaError_t of the query.
template <int FP>
int poly_plan(int* out) {
  const auto kernel = poly_score_tc_kernel<FP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TcSmem<FP>::kBytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kTcThreads, TcSmem<FP>::kBytes);
  out[0] = TcSmem<FP>::kBytes;
  out[1] = blocks;
  out[2] = kTcThreads;
  out[3] = kTcRows;
  return static_cast<int>(e);
}

}  // namespace
}  // namespace diffco

#define DIFFCO_POLY_SWITCH(FPV, CALL)        \
  switch (FPV) {                             \
    case 8: return CALL(8);                  \
    case 16: return CALL(16);                \
    case 24: return CALL(24);                \
    case 32: return CALL(32);                \
    case 40: return CALL(40);                \
    case 48: return CALL(48);                \
    case 56: return CALL(56);                \
    case 64: return CALL(64);                \
    default: return cudaErrorInvalidValue;   \
  }

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int poly_score_grad(const float* x, const float* s, const float* w,
                               float* score, float* dx, int B, int S, int F,
                               void* stream) {
  if (B <= 0 || F <= 0 || F > 64 || S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::poly_launch<FPV, false>(x, s, w, score, dx, B, S, F,             \
                                  diffco::kTcGuard, nullptr, st)
  DIFFCO_POLY_SWITCH((F + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// poly_score_grad's kernel in its measurement build: the near-pair guard
// at threshold `kappa`, its recomputations added to the device counter
// *guard_pairs (a measurement entry; production launches go through
// poly_score_grad).
extern "C" int poly_score_grad_guard(const float* x, const float* s,
                                     const float* w, float* score, float* dx,
                                     int B, int S, int F, float kappa,
                                     unsigned long long* guard_pairs,
                                     void* stream) {
  if (B <= 0 || F <= 0 || F > 64 || S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::poly_launch<FPV, true>(x, s, w, score, dx, B, S, F, kappa,       \
                                 guard_pairs, st)
  DIFFCO_POLY_SWITCH((F + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// poly_score_grad's launch plan for F components (poly_plan).
extern "C" int poly_score_plan(int F, int* out) {
  if (F <= 0 || F > 64) return cudaErrorInvalidValue;
#define DIFFCO_PLAN(FPV) diffco::poly_plan<FPV>(out)
  DIFFCO_POLY_SWITCH((F + 7) / 8 * 8, DIFFCO_PLAN)
#undef DIFFCO_PLAN
}
