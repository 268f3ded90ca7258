// DH-chain FK + polyharmonic score + configuration gradient, written by
// hand for Hopper.
//
// Replaces: diffco_tpu/ops/fk_score.py::_dh_score_grad_pallas (body
// _make_dh_score_kernel with _dh_chain_tile and _score_grad_block), the
// TPU kernel behind dh_polyharmonic_score: the trajopt inner-loop
// primitive, and the verify/collision_score sweeps at batch >= 4096.
//
// Per configuration q [J]: DH FK to P control points (x = 3P components),
// score = sum_j w_j ||x - s_j||, then the suffix-sum geometric-Jacobian
// backward to dq [J]. Only q, the supports and weights are read and only
// score [B] and dq [B, J] are written.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, P = 7 so F = 21) the score block's function needs
// about B*S*(4F + 11) operations, rsqrt included (~3.2 GFLOP); FK and
// its backward add ~850 per configuration; the bytes in and out are
// ~4 MB. Of the per-pair work, ~4F operations are the two matrix
// products that the TPU kernel runs on its MXU (the cross term x . s and
// the [s w | w] sums); the rest (distance from the products, rsqrt, the
// compensated score) is ~15 operations per pair.
//
// Design (production, dh_score_tc_kernel): the score block of
// tc_score_block.cuh, with both products on the tensor cores in 3xTF32
// (mma.sync m16n8k8), 128 configurations and 256 threads per block, two
// blocks (16 warps) per SM. One thread per configuration runs the FK
// first, into the block's shared rows: the points for the block, the
// joint axes and origins for the backward, which the same thread runs
// after the supports from the row's sums in shared memory. The DH
// constants and point specs arrive by value in a DHSpec kernel argument,
// so one build serves every DH robot with J <= 8, P <= 16 (past them,
// the wide instance of chain_wide.cuh on the chain folded into chain
// form: dh_score_grad_wide, up to 64 of each). Product 2
// sums each chunk of supports into a fresh accumulator (kDhSums): one
// accumulator over all of them took the dq of fitted proxies of 4096
// supports past half the 1e-3 tolerance (PERF.md section 6).
//
// The first design, one thread per configuration on the CUDA cores with
// supports staged through shared memory in chunks of 128
// (dh_score_grad_kernel, score_block.cuh), stays for the roofline path's
// block-size sweep (dh_score_grad_threads), which ports the reference's
// tile sweep. The roofline path's other kernels, B6 (dh_dual_score.cu)
// and B7 (dh_ablation.cu), run on this file's production design.
#include <cuda_runtime.h>

#include "chain_wide.cuh"
#include "dh_tc_rows.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {
namespace {

// The first design, one configuration per thread on the CUDA cores
// (roofline path only: dh_score_grad_threads).
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

// B1 on the tensor-core score block (file comment). kMeasure: a
// measurement build that counts the near-pair guard's recomputations
// into *guard_pairs, with kappa as its threshold.
template <int FP, bool kMeasure>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
dh_score_tc_kernel(const float* __restrict__ q, const float* __restrict__ s,
                   const float* __restrict__ w, float* __restrict__ score,
                   float* __restrict__ dq, int B, int S,
                   const __grid_constant__ DHSpec sp, float kappa,
                   unsigned long long* guard_pairs) {
  using L = TcSmem<FP>;
  float* smem = diffco_tc_smem;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kTcRows + tid;
  const bool live = b < B;   // the ragged end of B is masked here
  const int F = 3 * sp.P;
  if (S > 0) tc_stage<FP>(s, w, 0, S, F, smem, 0);
  // FK into the row's points (zeros past F) and its joint axes and
  // origins, all in shared memory, which the backward reads after the
  // supports
  float* xrow = smem + L::kX + tid * L::kXS;
  float* axes = smem + DhSmem<FP>::kAxes + tid * DhSmem<FP>::kAxesStride;
  if (tid < kTcRows) dh_row_fk<FP>(q, b, live, sp, xrow, axes);
  tc_score_block<FP, kMeasure, kDhSums<FP>>(s, w, S, F, smem, kappa,
                                            guard_pairs,
                                            smem + DhSmem<FP>::kRun);
  if (tid < kTcRows) {  // the epilogue: the backward
    float dqr[kMaxJ];
    dh_row_backward<FP>(smem, tid, sp, xrow, axes, dqr);
    dh_row_store<FP>(smem, tid, b, live, sp, dqr, score, dq);
  }
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

#include "chain_wide_launch.cuh"

namespace diffco {
namespace {

// Launches B1's production kernel over B configurations on `st`; the
// cudaError_t, 0 on success.
template <int FP, bool kMeasure>
int tc_launch(const float* q, const float* s, const float* w, float* score,
              float* dq, int B, int S, const DHSpec& sp, float kappa,
              unsigned long long* guard_pairs, cudaStream_t st) {
  const auto kernel = dh_score_tc_kernel<FP, kMeasure>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DhSmem<FP>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kTcRows - 1) / kTcRows, kTcThreads, DhSmem<FP>::kBytes,
           st>>>(q, s, w, score, dq, B, S, sp, kappa, guard_pairs);
  return static_cast<int>(cudaGetLastError());
}

// out = {dynamic shared bytes per block, blocks resident per SM by the
// runtime's occupancy calculator, threads per block, configurations per
// block}; the cudaError_t of the query.
template <int FP>
int tc_plan(int* out) {
  const auto kernel = dh_score_tc_kernel<FP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DhSmem<FP>::kBytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kTcThreads, DhSmem<FP>::kBytes);
  out[0] = DhSmem<FP>::kBytes;
  out[1] = blocks;
  out[2] = kTcThreads;
  out[3] = kTcRows;
  return static_cast<int>(e);
}

}  // namespace
}  // namespace diffco

#define DIFFCO_FP_SWITCH(FPV, CALL) \
  switch (FPV) {                    \
    case 8: return CALL(8);         \
    case 16: return CALL(16);       \
    case 24: return CALL(24);       \
    case 32: return CALL(32);       \
    case 40: return CALL(40);       \
    case 48: return CALL(48);       \
    default: return cudaErrorInvalidValue; \
  }

static bool dh_spec_ok(const diffco::DHSpec& sp) {
  return sp.J >= 1 && sp.J <= diffco::kMaxJ && sp.P >= 1 &&
         sp.P <= diffco::kMaxP;
}

// Returns the cudaError_t of the launch (0 on success). `spec` is a host
// pointer, copied into the kernel's arguments. Launches on `stream` and
// does not synchronise.
extern "C" int dh_score_grad(const float* q, const float* s, const float* w,
                             float* score, float* dq, int B, int S,
                             const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || !dh_spec_ok(sp)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::tc_launch<FPV, false>(q, s, w, score, dq, B, S, sp,              \
                                diffco::kTcGuard, nullptr, st)
  DIFFCO_FP_SWITCH((3 * sp.P + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// dh_score_grad's kernel in its measurement build: the near-pair guard at
// threshold `kappa`, its recomputations added to the device counter
// *guard_pairs (a measurement entry; production launches go through
// dh_score_grad).
extern "C" int dh_score_grad_guard(const float* q, const float* s,
                                   const float* w, float* score, float* dq,
                                   int B, int S, float kappa,
                                   unsigned long long* guard_pairs,
                                   const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || !dh_spec_ok(sp)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::tc_launch<FPV, true>(q, s, w, score, dq, B, S, sp, kappa,        \
                               guard_pairs, st)
  DIFFCO_FP_SWITCH((3 * sp.P + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// dh_score_grad's launch plan for P control points (tc_plan).
extern "C" int dh_score_plan(int P, int* out) {
  if (P < 1 || P > diffco::kMaxP) return cudaErrorInvalidValue;
#define DIFFCO_PLAN(FPV) diffco::tc_plan<FPV>(out)
  DIFFCO_FP_SWITCH((3 * P + 7) / 8 * 8, DIFFCO_PLAN)
#undef DIFFCO_PLAN
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

// The wide instance (chain_wide.cuh) for a chain past the tensor-core
// kernel's bounds, after its prologue (wide_prep) has written the supports
// and weights into `prep`: `host` is the ChainSpecWide as the host built
// it, `dev` its copy in device memory, `zo` a scratch of B M 6 floats.
// Returns the cudaError_t of the launch.
extern "C" int dh_score_grad_wide(
    const float* q, const double* prep, float* score, float* dq, int B,
    int S, const diffco::ChainSpecWide* host,
    const diffco::ChainSpecWide* dev, float* zo, void* stream) {
  return diffco::chain_wide_launch(q, prep, score, dq, B, S, 1, host, dev,
                                   zo, static_cast<cudaStream_t>(stream));
}
