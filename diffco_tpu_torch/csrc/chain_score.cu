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
// points (x = 3P components), score = sum_j w_j ||x - s_j||, then dq by
// the per-point moving-ancestor sums of chain_fk.cuh. Only q, the
// supports and weights are read and only score [B] and dq [B, D] are
// written.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, FrankaPanda's P = 8 so F = 24) the score block's
// function needs about B*S*(4F + 11) operations, rsqrt included (~3.6
// GFLOP, counted in the TPU kernel's expanded form), of which ~4F per
// pair are the two matrix products that run on the tensor cores here; the
// FK and its backward add 2174 operations per configuration
// (ops/bounds.py::chain_ops, counted from chain_fk.cuh; 45 point /
// moving-ancestor pairs); the bytes in and out are ~4 MB.
//
// Design (chain_score_tc_kernel): B1's kernel (dh_score.cu) with the chain
// FK in place of the DH FK. The score block of tc_score_block.cuh, both
// products on the tensor cores in 3xTF32, 128 configurations and 256
// threads per block, two blocks (16 warps) per SM at FrankaPanda's shape.
// One thread per configuration runs chain_fk first, straight into the
// block's shared rows; each moving joint's world axis and origin (zo,
// which the backward reads) go to shared memory beside them, at a row
// stride of 6M + 1 floats sized at launch from the chain's M moving
// joints (22 KB for FrankaPanda's M = 7, where kMaxM would take 50 KB).
// The same thread runs chain_backward after the supports, from the row's
// sums (tc_row_sums). The moving frames (fr) are indexed by data and stay
// in per-thread local memory, used by the FK only. Product 2 accumulates
// chunk by chunk (tc_score_block.cuh's kTcPointSums), which the fitted
// FrankaPanda sweep's gradient needs, and at FP = 56 and 64 the marked
// ropes' fitted proxies at S = 4096 and 8192: the running sums in
// registers up to FP = 56 (unspilled), in shared memory at 64 (ChainSmem;
// in registers they spill 12 B and ran 2 % slower on the card).
//
// The chain is data, not code: ops/fk_score.py folds every fixed joint
// into the constant transform in front of the next moving joint, so the
// kernel composes only the M moving joints, and passes the folded chain
// by value in a ChainSpec kernel argument (__grid_constant__). Folding is
// what makes it fit: 1628 bytes for M <= 16, P <= 21, under the 4 KB
// kernel-parameter limit (static_assert in chain_fk.cuh); and a by-value
// argument needs no device buffer, no upload and no cache per robot. One
// build serves every chain with M <= 16 moving joints, D <= 16 dofs and
// P <= 21 control points. A chain past those bounds (a 35-link rope)
// launches the wide instance (chain_score_grad_wide, chain_wide.cuh) up
// to 64 of each; the wrapper raises beyond.
#include <cuda_runtime.h>

#include "chain_wide.cuh"
#include "tc_score_block.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {
namespace {

// Product 2's sums (kTcPointSums): in registers up to FP = 56.
template <int FP>
constexpr int kChainSums = kTcPointSums<FP, 56>;

// The kernel's dynamic shared memory: the block's (TcSmem<FP>), product
// 2's running sums where kChainSums keeps them in shared memory, then
// each row's zo [M][6] at an odd stride of 6M + 1 floats (in each thread's
// local memory instead, zo cost 3.1 % at FrankaPanda's shape: PERF.md
// section 6).
template <int FP>
struct ChainSmem {
  static constexpr int kRun = TcSmem<FP>::kFloats;
  static constexpr int kZo = kRun + kTcRunFloats<FP, kChainSums<FP>>;
  DIFFCO_HD static int zo_stride(int M) { return 6 * M + 1; }
  static int bytes(int M) { return 4 * (kZo + kTcRows * zo_stride(M)); }
};

// B3 on the tensor-core score block (file comment). kMeasure: a
// measurement build that counts the near-pair guard's recomputations
// into *guard_pairs, with kappa as its threshold.
template <int FP, bool kMeasure>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
chain_score_tc_kernel(const float* __restrict__ q, const float* __restrict__ s,
                      const float* __restrict__ w, float* __restrict__ score,
                      float* __restrict__ dq, int B, int S,
                      const __grid_constant__ ChainSpec sp, float kappa,
                      unsigned long long* guard_pairs) {
  using L = TcSmem<FP>;
  constexpr int KP = FP / 3 < kMaxCP ? FP / 3 : kMaxCP;
  float* smem = diffco_tc_smem;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kTcRows + tid;
  const bool live = b < B;   // the ragged end of B is masked here
  const int F = 3 * sp.P;
  if (S > 0) tc_stage<FP>(s, w, 0, S, F, smem, 0);
  float* xrow = smem + L::kX + tid * L::kXS;
  float(*zo)[6] = reinterpret_cast<float(*)[6]>(
      smem + ChainSmem<FP>::kZo + tid * ChainSmem<FP>::zo_stride(sp.M));
  if (tid < kTcRows) {   // FK into the row's points (zeros past F) and zo
    const float* qb = q + static_cast<size_t>(live ? b : 0) * sp.D;
    float fr[kMaxM][12];
#pragma unroll
    for (int f = 0; f < FP; ++f) xrow[f] = 0.f;
    chain_fk<KP>(qb, live, sp, fr, zo, xrow);
  }
  tc_score_block<FP, kMeasure, kChainSums<FP>>(
      s, w, S, F, smem, kappa, guard_pairs, smem + ChainSmem<FP>::kRun);
  if (tid < kTcRows) {  // the epilogue: the backward
    float dqr[kMaxD];
#pragma unroll
    for (int f = 0; f < FP; ++f) xrow[f] += smem[L::kCen + f];  // x~ + c
    const float* su = tc_row_sums<FP>(smem, tid, F);
    chain_backward<KP>(sp, zo, xrow, su[F], su, dqr);
    if (live)
      for (int d = 0; d < sp.D; ++d)
        dq[static_cast<size_t>(b) * sp.D + d] = dqr[d];
    if (live) score[b] = smem[L::kScore + tid];
  }
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

#include "chain_wide_launch.cuh"

namespace diffco {
namespace {

// Launches B3's kernel over B configurations on `st`; the cudaError_t, 0
// on success.
template <int FP, bool kMeasure>
int chain_launch(const float* q, const float* s, const float* w, float* score,
                 float* dq, int B, int S, const ChainSpec& sp, float kappa,
                 unsigned long long* guard_pairs, cudaStream_t st) {
  const auto kernel = chain_score_tc_kernel<FP, kMeasure>;
  const int bytes = ChainSmem<FP>::bytes(sp.M);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kTcRows - 1) / kTcRows, kTcThreads, bytes, st>>>(
      q, s, w, score, dq, B, S, sp, kappa, guard_pairs);
  return static_cast<int>(cudaGetLastError());
}

// out = {dynamic shared bytes per block, blocks resident per SM by the
// runtime's occupancy calculator, threads per block, configurations per
// block} for a chain of M moving joints; the cudaError_t of the query.
template <int FP>
int chain_plan(int M, int* out) {
  const auto kernel = chain_score_tc_kernel<FP, false>;
  const int bytes = ChainSmem<FP>::bytes(M);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kTcThreads, bytes);
  out[0] = bytes;
  out[1] = blocks;
  out[2] = kTcThreads;
  out[3] = kTcRows;
  return static_cast<int>(e);
}

}  // namespace
}  // namespace diffco

#define DIFFCO_CHAIN_SWITCH(FPV, CALL)       \
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

// Returns the cudaError_t of the launch (0 on success). `spec` is a host
// pointer, copied into the kernel's arguments. Launches on `stream` and
// does not synchronise.
extern "C" int chain_score_grad(const float* q, const float* s,
                                const float* w, float* score, float* dq,
                                int B, int S, const diffco::ChainSpec* spec,
                                void* stream) {
  const diffco::ChainSpec sp = *spec;
  if (B <= 0 || S < 0 || !diffco::spec_ok(sp)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::chain_launch<FPV, false>(q, s, w, score, dq, B, S, sp,           \
                                   diffco::kTcGuard, nullptr, st)
  DIFFCO_CHAIN_SWITCH((3 * sp.P + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// chain_score_grad's kernel in its measurement build: the near-pair guard
// at threshold `kappa`, its recomputations added to the device counter
// *guard_pairs (a measurement entry; production launches go through
// chain_score_grad).
extern "C" int chain_score_grad_guard(const float* q, const float* s,
                                      const float* w, float* score,
                                      float* dq, int B, int S, float kappa,
                                      unsigned long long* guard_pairs,
                                      const diffco::ChainSpec* spec,
                                      void* stream) {
  const diffco::ChainSpec sp = *spec;
  if (B <= 0 || S < 0 || !diffco::spec_ok(sp)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::chain_launch<FPV, true>(q, s, w, score, dq, B, S, sp, kappa,     \
                                  guard_pairs, st)
  DIFFCO_CHAIN_SWITCH((3 * sp.P + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// chain_score_grad's launch plan for P control points and M moving joints
// (chain_plan).
extern "C" int chain_score_plan(int P, int M, int* out) {
  if (P < 1 || P > diffco::kMaxCP || M < 1 || M > diffco::kMaxM)
    return cudaErrorInvalidValue;
#define DIFFCO_PLAN(FPV) diffco::chain_plan<FPV>(M, out)
  DIFFCO_CHAIN_SWITCH((3 * P + 7) / 8 * 8, DIFFCO_PLAN)
#undef DIFFCO_PLAN
}

// The wide instance (chain_wide.cuh) for a chain past the tensor-core
// kernel's bounds, after its prologue (wide_prep) has written the supports
// and weights into `prep`: `host` is the ChainSpecWide as the host built
// it, `dev` its copy in device memory, `zo` a scratch of B M 6 floats.
// Returns the cudaError_t of the launch.
extern "C" int chain_score_grad_wide(
    const float* q, const double* prep, float* score, float* dq, int B,
    int S, const diffco::ChainSpecWide* host,
    const diffco::ChainSpecWide* dev, float* zo, void* stream) {
  return diffco::chain_wide_launch(q, prep, score, dq, B, S, 1, host, dev,
                                   zo, static_cast<cudaStream_t>(stream));
}

// The wide instance's launch plan for P control points and M moving
// joints (chain_wide_plan).
extern "C" int chain_score_wide_plan(int P, int M, int* out) {
  return diffco::chain_wide_plan(P, M, out);
}
