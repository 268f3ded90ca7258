// Multi-class DH-chain FK + polyharmonic scores + configuration gradients,
// written by hand for Hopper.
//
// Replaces: diffco_tpu/ops/fk_score.py::_dh_multi_score_grad_pallas (body
// _make_dh_multi_score_kernel), the TPU kernel behind
// dh_polyharmonic_multi_score: the verify / collision_score sweeps of a
// multi-class (MultiDiffCo) proxy on a DH robot at batch >= 4096.
//
// Per configuration q [J]: DH FK to P control points (x = 3P components),
// then for each of C weight columns W[:, c] (one per obstacle class, over
// one shared support set) score_c = sum_j W_jc ||x - s_j|| and the
// suffix-sum geometric-Jacobian backward to dq_c [J]. Only q, the
// supports and W are read; only score [B, C] and dq [C, B, J] (the JAX
// function's layout) are written.
//
// What bounds it on this card: arithmetic. At the PandaFK path's shape
// (B = 65536, S = 512, P = 7 so F = 21, C = 2) the function needs the
// shared distance and rsqrt per pair (2F + 7 operations, counted in the
// expanded form) plus 2F + 4 per pair and class (score, rowsum, su), about
// 4.5 GFLOP; FK and backward add 66J + 18P + C(17J + 21P) per
// configuration (ops/bounds.py::dh_ops); the bytes in and out are ~5 MB.
// So the CUDA cores (67 TFLOP/s fp32), not HBM, set the floor.
//
// Design: one thread per configuration (128 per block), as dh_score.cu.
// The classes go in tiles of kClassTile = 2 per pass over the supports:
// a pass keeps the FP point components, two FP-vectors su_c and the
// compensated score and rowsum of its two classes in registers, and
// shares each pair's distance and rsqrt between them (the TPU kernel's
// sharing, for two classes). C = 2 takes one pass; C = 5 takes three,
// the last with a zero weight column, and recomputes the distances in
// each. Keeping all C su vectors instead would need 8 x 24 floats at
// kMaxC, which the 255-register limit does not hold without spilling;
// tiles keep the register footprint that of two B1 loops, whatever C is.
// FK is recomputed after each pass to get the joint axes for the
// backward (a few hundred operations), as in dh_score.cu. W arrives as a
// device pointer (row-major [S, C]), the chain constants by value in the
// DHSpec kernel argument: one build serves every DH robot with J <= 8,
// P <= 16 and every C <= kMaxC = 8.
#include <cuda_runtime.h>

#include "dh_chain.cuh"

namespace diffco {
namespace {

template <int FP>
__global__ void __launch_bounds__(kThreads)
dh_multi_score_grad_kernel(const float* __restrict__ q,
                           const float* __restrict__ s,
                           const float* __restrict__ W,
                           float* __restrict__ score, float* __restrict__ dq,
                           int B, int S, int C,
                           const __grid_constant__ DHSpec sp) {
  constexpr int KP = FP / 3 < kMaxP ? FP / 3 : kMaxP;
  constexpr int CT = kClassTile;
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk * CT];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;   // the ragged end of B is masked here
  const int J = sp.J;
  float qr[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = (live && j < J) ? q[static_cast<size_t>(b) * J + j] : 0.f;
  float x[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) x[f] = 0.f;
  {
    float az[3 * kMaxJ], ao[3 * kMaxJ];  // dead here: recomputed below
    dh_chain<KP>(qr, sp, x, az, ao);
  }
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
    float az[3 * kMaxJ], ao[3 * kMaxJ], dqr[kMaxJ];
    dh_chain<KP>(qr, sp, x, az, ao);
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      if (k0 + k < C) {
        dh_backward<KP>(sp, x, az, ao, rs[k], su + k * FP, dqr);
        if (live) {
          score[static_cast<size_t>(b) * C + k0 + k] = sc[k] + scc[k];
          float* dqb = dq + (static_cast<size_t>(k0 + k) * B + b) * J;
#pragma unroll
          for (int j = 0; j < kMaxJ; ++j)
            if (j < J) dqb[j] = dqr[j];
        }
      }
    }
  }
}

}  // namespace
}  // namespace diffco

#define DIFFCO_DH_MULTI_CASE(FPV)                                        \
  case FPV:                                                              \
    diffco::dh_multi_score_grad_kernel<FPV>                              \
        <<<grid, diffco::kThreads, 0, st>>>(q, s, W, score, dq, B, S, C, \
                                            sp);                         \
    break;

// Returns the cudaError_t of the launch (0 on success). `spec` is a host
// pointer, copied into the kernel's arguments; W is a device pointer.
// Launches on `stream` and does not synchronise.
extern "C" int dh_multi_score_grad(const float* q, const float* s,
                                   const float* W, float* score, float* dq,
                                   int B, int S, int C,
                                   const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || C < 1 || C > diffco::kMaxC || sp.J < 1 ||
      sp.J > diffco::kMaxJ || sp.P < 1 || sp.P > diffco::kMaxP)
    return cudaErrorInvalidValue;
  const dim3 grid((B + diffco::kThreads - 1) / diffco::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((3 * sp.P + 7) / 8 * 8) {
    DIFFCO_DH_MULTI_CASE(8)
    DIFFCO_DH_MULTI_CASE(16)
    DIFFCO_DH_MULTI_CASE(24)
    DIFFCO_DH_MULTI_CASE(32)
    DIFFCO_DH_MULTI_CASE(40)
    DIFFCO_DH_MULTI_CASE(48)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
