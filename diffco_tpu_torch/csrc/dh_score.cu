// DH-chain FK + polyharmonic score + configuration gradient, written by
// hand for Hopper.
//
// Replaces: diffco_tpu/ops/fk_score.py::_dh_score_grad_pallas (body
// _make_dh_score_kernel with _dh_chain_tile and _score_grad_block), the
// TPU kernel behind dh_polyharmonic_score: the trajopt inner-loop
// primitive, and the verify/collision_score sweeps at batch >= 4096.
//
// Per configuration q [J]: DH FK to P control points (x = 3P components),
// score = sum_j w_j ||x - s_j|| with the shared score block, then the
// suffix-sum geometric-Jacobian backward to dq [J]. Only q, the supports
// and weights are read and only score [B] and dq [B, J] are written.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, P = 7 so F = 21) the score block's function needs
// about B*S*(4F + 11) fp32 operations, rsqrt included (~3.2 GFLOP; the
// direct difference and compensated score here cost 5F + 14); FK and its
// backward add ~850 operations per configuration; the bytes in and out
// are ~4 MB. So the CUDA cores (67 TFLOP/s fp32), not HBM, set the floor.
//
// Design: one thread per configuration (kThreads = 128 per block; the
// roofline path's block-size sweep also builds 64, 256 and 512). FK runs in
// registers (the SoA compose of the TPU kernel); the 3P point components,
// zero-padded to FP, feed the same register-resident score block as
// poly_score.cu with supports staged through shared memory. The joint
// axes/origins are not kept across the support loop: FK is recomputed
// after it (a few hundred operations against ~57k for the loop), which
// keeps the loop's register footprint that of the point-space kernel.
// The DH constants and point specs arrive by value in a DHSpec kernel
// argument, so one build serves every DH robot with J <= 8, P <= 16.
#include <cuda_runtime.h>

#include "dh_chain.cuh"

namespace diffco {
namespace {

template <int FP, int THREADS>
__global__ void __launch_bounds__(THREADS)
dh_score_grad_kernel(const float* __restrict__ q, const float* __restrict__ s,
                     const float* __restrict__ w, float* __restrict__ score,
                     float* __restrict__ dq, int B, int S,
                     const __grid_constant__ DHSpec sp) {
  constexpr int KP = FP / 3 < kMaxP ? FP / 3 : kMaxP;
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk];
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const bool live = b < B;   // the ragged end of B is masked here
  const int J = sp.J;
  float qr[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = (live && j < J) ? q[static_cast<size_t>(b) * J + j] : 0.f;
  float x[FP], su[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    x[f] = 0.f;
    su[f] = 0.f;
  }
  {
    float az[3 * kMaxJ], ao[3 * kMaxJ];  // dead here: recomputed below
    dh_chain<KP>(qr, sp, x, az, ao);
  }
  float sc = 0.f, scc = 0.f, rs = 0.f;
  const int F = 3 * sp.P;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();
    stage_supports<FP>(s, w, c0, n, F, s_sh, w_sh);
    __syncthreads();
    score_grad_accumulate<FP>(x, s_sh, w_sh, n, sc, scc, rs, su);
  }
  float az[3 * kMaxJ], ao[3 * kMaxJ], dqr[kMaxJ];
  dh_chain<KP>(qr, sp, x, az, ao);
  dh_backward<KP>(sp, x, az, ao, rs, su, dqr);
  if (live) {
    score[b] = sc + scc;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) dq[static_cast<size_t>(b) * J + j] = dqr[j];
  }
}

}  // namespace
}  // namespace diffco

#define DIFFCO_DH_CASE(FPV)                                          \
  case FPV:                                                          \
    diffco::dh_score_grad_kernel<FPV, diffco::kThreads>              \
        <<<grid, diffco::kThreads, 0, st>>>(q, s, w, score, dq, B, S, sp); \
    break;

// Returns the cudaError_t of the launch (0 on success). `spec` is a host
// pointer, copied into the kernel's arguments. Launches on `stream` and
// does not synchronise.
extern "C" int dh_score_grad(const float* q, const float* s, const float* w,
                             float* score, float* dq, int B, int S,
                             const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || sp.J < 1 || sp.J > diffco::kMaxJ || sp.P < 1 ||
      sp.P > diffco::kMaxP)
    return cudaErrorInvalidValue;
  const dim3 grid((B + diffco::kThreads - 1) / diffco::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((3 * sp.P + 7) / 8 * 8) {
    DIFFCO_DH_CASE(8)
    DIFFCO_DH_CASE(16)
    DIFFCO_DH_CASE(24)
    DIFFCO_DH_CASE(32)
    DIFFCO_DH_CASE(40)
    DIFFCO_DH_CASE(48)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

#define DIFFCO_DH_THREADS_CASE(T)                                       \
  case T:                                                               \
    diffco::dh_score_grad_kernel<24, T>                                 \
        <<<(B + T - 1) / T, T, 0, st>>>(q, s, w, score, dq, B, S, sp);  \
    break;

// The block-size sweep of the roofline path
// (diffco_tpu_torch/scripts/roofline_fk_score.py; the reference sweeps the
// TPU batch tile): the FP = 24 kernel at `threads` = 64, 128, 256 or 512
// per block. Production launches go through dh_score_grad above.
extern "C" int dh_score_grad_threads(const float* q, const float* s,
                                     const float* w, float* score, float* dq,
                                     int B, int S, int threads,
                                     const diffco::DHSpec* spec,
                                     void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || sp.J < 1 || sp.J > diffco::kMaxJ ||
      (3 * sp.P + 7) / 8 * 8 != 24)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (threads) {
    DIFFCO_DH_THREADS_CASE(64)
    DIFFCO_DH_THREADS_CASE(128)
    DIFFCO_DH_THREADS_CASE(256)
    DIFFCO_DH_THREADS_CASE(512)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
