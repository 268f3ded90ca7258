// Point-space polyharmonic score + gradient, written by hand for Hopper.
//
// Replaces: diffco_tpu/ops/fused_score.py::_poly_score_grad_pallas (body
// _make_fwdgrad_kernel), the TPU kernel behind polyharmonic_score at
// batch >= 16384.
//
// Computes, for x [B, F], s [S, F], w [S] (fp32, row-major):
//   score[b] = sum_j w_j ||x_b - s_j||,  dx[b] = x_b * sum_j w_j / r_bj
//                                               - sum_j s_j w_j / r_bj.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, F = 21) the function needs about B*S*(4F + 11)
// fp32 operations, rsqrt included (~3.2 GFLOP, counted in the TPU kernel's
// expanded form ||x||^2 + ||s||^2 - 2 x.s), and moves ~11 MB in and out,
// so the CUDA cores (67 TFLOP/s fp32), not HBM (3.35 TB/s), set the floor.
// The direct difference and compensated score sum of score_block.cuh
// cost 5F + 14 per pair (119 against 95 at F = 21), and the difference
// has no cancellation.
//
// Design: one thread per query row (128 per block) keeps its row, its
// running score/rowsum and the F-vector su in registers; F is padded to
// FP (a multiple of 8, at most 64) at compile time so every component
// loop unrolls. The block stages supports and weights through shared
// memory in chunks of kChunk rows (48 KB for S = 512, F = 24 in four
// passes); all threads of a warp read the same support, a broadcast. No
// [B, S] intermediate ever exists. Tensor cores for the cross term are
// later work.
#include <cuda_runtime.h>

#include "score_block.cuh"

namespace diffco {
namespace {

template <int FP>
__global__ void __launch_bounds__(kThreads)
poly_score_grad_kernel(const float* __restrict__ x,
                       const float* __restrict__ s,
                       const float* __restrict__ w, float* __restrict__ score,
                       float* __restrict__ dx, int B, int S, int F) {
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;   // the ragged end of B is masked here
  float xr[FP], su[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    xr[f] = (live && f < F) ? x[static_cast<size_t>(b) * F + f] : 0.f;
    su[f] = 0.f;
  }
  float sc = 0.f, scc = 0.f, rs = 0.f;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();
    stage_supports<FP>(s, w, c0, n, F, s_sh, w_sh);
    __syncthreads();
    score_grad_accumulate<FP>(xr, s_sh, w_sh, n, sc, scc, rs, su);
  }
  if (live) {
    score[b] = sc + scc;
#pragma unroll
    for (int f = 0; f < FP; ++f)
      if (f < F) dx[static_cast<size_t>(b) * F + f] = xr[f] * rs - su[f];
  }
}

}  // namespace
}  // namespace diffco

#define DIFFCO_POLY_CASE(FPV)                                             \
  case FPV:                                                               \
    diffco::poly_score_grad_kernel<FPV><<<grid, diffco::kThreads, 0, st>>>( \
        x, s, w, score, dx, B, S, F);                                     \
    break;

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int poly_score_grad(const float* x, const float* s, const float* w,
                               float* score, float* dx, int B, int S, int F,
                               void* stream) {
  if (B <= 0 || F <= 0 || F > 64 || S < 0) return cudaErrorInvalidValue;
  const dim3 grid((B + diffco::kThreads - 1) / diffco::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((F + 7) / 8 * 8) {
    DIFFCO_POLY_CASE(8)
    DIFFCO_POLY_CASE(16)
    DIFFCO_POLY_CASE(24)
    DIFFCO_POLY_CASE(32)
    DIFFCO_POLY_CASE(40)
    DIFFCO_POLY_CASE(48)
    DIFFCO_POLY_CASE(56)
    DIFFCO_POLY_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
