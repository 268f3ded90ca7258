// General-chain (URDF) FK + polyharmonic score + configuration gradient,
// written by hand for Hopper.
//
// Replaces: diffco_tpu/ops/fk_score.py::_chain_score_grad_pallas (body
// _make_chain_score_kernel over robots/fk_jvp.py::eval_chain), the TPU
// kernel behind chain_polyharmonic_score: the verify / collision_score
// sweeps of a URDF robot (FrankaPanda and the like) at batch >= 4096.
//
// Per configuration q [D]: FK of a topologically sorted tree of fixed,
// revolute (any static axis), prismatic and mimic joints to P control
// points (x = 3P components), score = sum_j w_j ||x - s_j|| with the
// shared score block of score_block.cuh, then dq by the per-point
// moving-ancestor sums of chain_fk.cuh. Only q, the supports and weights
// are read and only score [B] and dq [B, D] are written.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, FrankaPanda's P = 8 so F = 24) the score block's
// function needs about B*S*(4F + 11) fp32 operations, rsqrt included
// (~3.6 GFLOP, counted in the TPU kernel's expanded form); the FK and its
// backward add 2174 operations per configuration (ops/bounds.py::
// chain_ops, counted from chain_fk.cuh; 45 point / moving-ancestor
// pairs); the bytes in and out are ~4 MB. So the CUDA cores (67 TFLOP/s
// fp32), not HBM, set the floor, and the score loop is ~96 % of the
// work.
//
// Design: one thread per configuration (128 per block), as dh_score.cu.
// The chain is data, not code: ops/fk_score.py folds every fixed joint
// into the constant transform in front of the next moving joint, so the
// kernel composes only the M moving joints, and passes the folded chain
// by value in a ChainSpec kernel argument (__grid_constant__). Folding is
// what makes it fit: 1628 bytes for M <= 16, P <= 21, under the 4 KB
// kernel-parameter limit (static_assert in chain_fk.cuh), where the
// unfolded per-link statics and moving-ancestor lists of a 32-link tree
// would come near or over it; and a by-value argument needs no device
// buffer, no upload and no cache per robot. The
// moving frames and the joint axes/origins are indexed by data (parent
// and frame ids), so they sit in per-thread local memory (L1), written
// once by the FK and read once by the backward; the loop over supports
// keeps only the FP point components, the FP-vector su and the running
// sums in registers, the footprint of poly_score.cu. One build serves
// every chain with M <= 16 moving joints, D <= 16 dofs and P <= 21
// control points; the wrapper raises beyond them.
#include <cuda_runtime.h>

#include "chain_fk.cuh"

namespace diffco {
namespace {

template <int FP>
__global__ void __launch_bounds__(kThreads)
chain_score_grad_kernel(const float* __restrict__ q,
                        const float* __restrict__ s,
                        const float* __restrict__ w, float* __restrict__ score,
                        float* __restrict__ dq, int B, int S,
                        const __grid_constant__ ChainSpec sp) {
  constexpr int KP = FP / 3 < kMaxCP ? FP / 3 : kMaxCP;
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;   // the ragged end of B is masked here
  const float* qb = q + static_cast<size_t>(live ? b : 0) * sp.D;
  float x[FP], su[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    x[f] = 0.f;
    su[f] = 0.f;
  }
  float fr[kMaxM][12], zo[kMaxM][6];
  chain_fk<KP>(qb, live, sp, fr, zo, x);
  float sc = 0.f, scc = 0.f, rs = 0.f;
  const int F = 3 * sp.P;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();
    stage_supports<FP>(s, w, c0, n, F, s_sh, w_sh);
    __syncthreads();
    score_grad_accumulate<FP>(x, s_sh, w_sh, n, sc, scc, rs, su);
  }
  float dqr[kMaxD];
  chain_backward<KP>(sp, zo, x, rs, su, dqr);
  if (live) {
    score[b] = sc + scc;
    for (int d = 0; d < sp.D; ++d)
      dq[static_cast<size_t>(b) * sp.D + d] = dqr[d];
  }
}

}  // namespace
}  // namespace diffco

#define DIFFCO_CHAIN_CASE(FPV)                                          \
  case FPV:                                                             \
    diffco::chain_score_grad_kernel<FPV>                                \
        <<<grid, diffco::kThreads, 0, st>>>(q, s, w, score, dq, B, S, sp); \
    break;

// Returns the cudaError_t of the launch (0 on success). `spec` is a host
// pointer, copied into the kernel's arguments. Launches on `stream` and
// does not synchronise.
extern "C" int chain_score_grad(const float* q, const float* s,
                                const float* w, float* score, float* dq,
                                int B, int S, const diffco::ChainSpec* spec,
                                void* stream) {
  const diffco::ChainSpec sp = *spec;
  if (B <= 0 || S < 0 || !diffco::spec_ok(sp)) return cudaErrorInvalidValue;
  const dim3 grid((B + diffco::kThreads - 1) / diffco::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((3 * sp.P + 7) / 8 * 8) {
    DIFFCO_CHAIN_CASE(8)
    DIFFCO_CHAIN_CASE(16)
    DIFFCO_CHAIN_CASE(24)
    DIFFCO_CHAIN_CASE(32)
    DIFFCO_CHAIN_CASE(40)
    DIFFCO_CHAIN_CASE(48)
    DIFFCO_CHAIN_CASE(56)
    DIFFCO_CHAIN_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
