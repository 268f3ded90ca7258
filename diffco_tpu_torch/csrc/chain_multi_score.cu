// Multi-class general-chain (URDF) FK + polyharmonic scores +
// configuration gradients, written by hand for Hopper.
//
// Replaces: diffco_tpu/ops/fk_score.py::_chain_multi_score_grad_pallas
// (body _make_chain_multi_score_kernel over robots/fk_jvp.py::eval_chain),
// the TPU kernel behind chain_polyharmonic_multi_score: the verify /
// collision_score sweeps of a multi-class (MultiDiffCo) proxy on a URDF
// robot at batch >= 4096.
//
// Per configuration q [D]: the folded chain's FK (chain_fk.cuh) to P
// control points, then for each of C weight columns W[:, c] over one
// shared support set score_c = sum_j W_jc ||x - s_j|| and dq_c [D] by the
// per-point moving-ancestor sums. Only q, the supports and W are read;
// only score [B, C] and dq [C, B, D] are written.
//
// What bounds it on this card: arithmetic. At the FrankaPanda path's
// shape (S = 1024 supports, P = 8 so F = 24, C = 5: self-collision and
// four obstacles) the function needs per pair 2F + 7 shared operations
// plus 2F + 4 per class, ~320 operations; the FK and backward add
// ops/bounds.py::chain_ops(c, C) per configuration; bytes in and out are
// a few MB at B = 65536. So the CUDA cores (67 TFLOP/s fp32), not HBM, set
// the floor.
//
// Design: one thread per configuration (128 per block), as
// chain_score.cu, with the classes in tiles of kClassTile = 2 per pass
// over the supports, as dh_multi_score.cu: a pass shares each pair's
// distance and rsqrt between its two classes and keeps two FP-vectors su_c
// in registers; C = 5 takes three passes (the last with a zero weight
// column). The moving frames' axes and origins, written once by the FK
// into per-thread local memory, serve every pass's backward; nothing is
// recomputed. W arrives as a device pointer (row-major [S, C]): the folded
// ChainSpec already takes 1628 B of the 4 KB kernel-parameter space. One
// build serves every chain with M <= 16 moving joints, D <= 16 dofs,
// P <= 21 points and every C <= kMaxC = 8; the wrapper raises beyond.
#include <cuda_runtime.h>

#include "chain_fk.cuh"

namespace diffco {
namespace {

template <int FP>
__global__ void __launch_bounds__(kThreads)
chain_multi_score_grad_kernel(const float* __restrict__ q,
                              const float* __restrict__ s,
                              const float* __restrict__ W,
                              float* __restrict__ score,
                              float* __restrict__ dq, int B, int S, int C,
                              const __grid_constant__ ChainSpec sp) {
  constexpr int KP = FP / 3 < kMaxCP ? FP / 3 : kMaxCP;
  constexpr int CT = kClassTile;
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk * CT];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;   // the ragged end of B is masked here
  const float* qb = q + static_cast<size_t>(live ? b : 0) * sp.D;
  float x[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) x[f] = 0.f;
  float fr[kMaxM][12], zo[kMaxM][6];
  chain_fk<KP>(qb, live, sp, fr, zo, x);
  const int F = 3 * sp.P;
  for (int k0 = 0; k0 < C; k0 += CT) {
    float sc[CT], scc[CT], rs[CT], su[CT * FP];
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      sc[k] = 0.f;
      scc[k] = 0.f;
      rs[k] = 0.f;
    }
#pragma unroll
    for (int f = 0; f < CT * FP; ++f) su[f] = 0.f;
    for (int c0 = 0; c0 < S; c0 += kChunk) {
      const int n = min(kChunk, S - c0);
      __syncthreads();
      stage_supports<FP, CT>(s, W, c0, n, F, s_sh, w_sh, C, k0);
      __syncthreads();
      score_grad_accumulate_multi<FP, CT>(x, s_sh, w_sh, n, sc, scc, rs, su);
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      if (k0 + k < C) {
        float dqr[kMaxD];
        chain_backward<KP>(sp, zo, x, rs[k], su + k * FP, dqr);
        if (live) {
          score[static_cast<size_t>(b) * C + k0 + k] = sc[k] + scc[k];
          float* dqb = dq + (static_cast<size_t>(k0 + k) * B + b) * sp.D;
          for (int d = 0; d < sp.D; ++d) dqb[d] = dqr[d];
        }
      }
    }
  }
}

}  // namespace
}  // namespace diffco

#define DIFFCO_CHAIN_MULTI_CASE(FPV)                                     \
  case FPV:                                                              \
    diffco::chain_multi_score_grad_kernel<FPV>                           \
        <<<grid, diffco::kThreads, 0, st>>>(q, s, W, score, dq, B, S, C, \
                                            sp);                         \
    break;

// Returns the cudaError_t of the launch (0 on success). `spec` is a host
// pointer, copied into the kernel's arguments; W is a device pointer.
// Launches on `stream` and does not synchronise.
extern "C" int chain_multi_score_grad(const float* q, const float* s,
                                      const float* W, float* score,
                                      float* dq, int B, int S, int C,
                                      const diffco::ChainSpec* spec,
                                      void* stream) {
  const diffco::ChainSpec sp = *spec;
  if (B <= 0 || S < 0 || C < 1 || C > diffco::kMaxC ||
      !diffco::spec_ok(sp))
    return cudaErrorInvalidValue;
  const dim3 grid((B + diffco::kThreads - 1) / diffco::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((3 * sp.P + 7) / 8 * 8) {
    DIFFCO_CHAIN_MULTI_CASE(8)
    DIFFCO_CHAIN_MULTI_CASE(16)
    DIFFCO_CHAIN_MULTI_CASE(24)
    DIFFCO_CHAIN_MULTI_CASE(32)
    DIFFCO_CHAIN_MULTI_CASE(40)
    DIFFCO_CHAIN_MULTI_CASE(48)
    DIFFCO_CHAIN_MULTI_CASE(56)
    DIFFCO_CHAIN_MULTI_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
