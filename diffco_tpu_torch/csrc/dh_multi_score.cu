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
// Design: the score block of multi_score_block.cuh, as B5 uses it: a
// block of 128 configurations and 256 threads (two blocks, 16 warps, per
// SM), supports staged with cp.async in double-buffered chunks of 32, each
// pair's distance and rsqrt computed once for every class of a pass. The
// launch rule (multi_dispatch) picks one of three instances by C: at
// PandaFK's FP = 24, C <= 2 takes the register instance (each class's
// sums in registers during phase A), C <= 5 one full pass (phase B's
// product), C = 8 two. The FK runs once per configuration up front, for
// the points (shared memory), and again in the epilogue, once per thread
// that takes one of the configuration's classes, for the joint axes and
// origins: the DH frames are compile-time indices, so they stay in
// registers, and the points are read back from shared memory. W arrives
// as a device pointer (row-major [S, C]), the chain constants by value in
// the DHSpec kernel argument: one build serves every DH robot with
// J <= 8, P <= 16 and every C <= kMaxC = 8 (past them, the wide
// instance of chain_wide.cuh: dh_multi_score_grad_wide).
#include <cuda_runtime.h>

#include "chain_wide.cuh"
#include "dh_chain.cuh"
#include "multi_score_block.cuh"

extern __shared__ __align__(16) float diffco_multi_smem[];

namespace diffco {
namespace {

// The epilogue of a pass for block rows row0 .. row0 + nrows - 1, whose
// sums lie at tile[(row - row0) * stride + c (FP + 1) + f] (su_c, then
// rowsum_c at f = FP): a thread per (row, class slot) runs the row's FK
// again for its axes and origins, then the backward of each of its
// classes, and writes their scores and dq.
template <int FP>
__device__ __forceinline__ void dh_multi_epilogue(
    const float* __restrict__ q, float* __restrict__ score,
    float* __restrict__ dq, int B, int C, int k0, int cg, const DHSpec& sp,
    const float* smem, const float* tile, int stride, int row0, int nrows) {
  constexpr int KP = FP / 3 < kMaxP ? FP / 3 : kMaxP;
  const int per = kMultiThreads / nrows;
  const int rt = threadIdx.x % nrows, slot = threadIdx.x / nrows;
  if (slot >= cg) return;
  const int row = row0 + rt;
  const int b = blockIdx.x * kMultiRows + row;
  if (b >= B) return;   // the ragged end of B is masked here
  const int J = sp.J;
  float qr[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = j < J ? q[static_cast<size_t>(b) * J + j] : 0.f;
  float xd[FP], az[3 * kMaxJ], ao[3 * kMaxJ];  // xd dead: x is in kX
  dh_chain<KP>(qr, sp, xd, az, ao);
  const float* x = smem + MultiSmem<FP>::kX + row * FP;
  for (int c = slot; c < cg; c += per) {
    const float* t = tile + rt * stride + c * (FP + 1);
    score[static_cast<size_t>(b) * C + k0 + c] =
        multi_class_score<FP>(smem, row, c);
    // dq straight from the backward: with half the product's
    // accumulator still live here, a dq array of its own spilled
    dh_backward<KP>(sp, x, az, ao, t[FP], t,
                    dq + (static_cast<size_t>(k0 + c) * B + b) * J);
  }
}

// kInst: kInstReg (NC = C classes), kInstNarrow or kInstFull (NC = 0)
template <int FP, int kInst, int NC>
__global__ void __launch_bounds__(kMultiThreads, 2)
dh_multi_score_grad_kernel(const float* __restrict__ q,
                           const float* __restrict__ s,
                           const float* __restrict__ W,
                           float* __restrict__ score, float* __restrict__ dq,
                           int B, int S, int C,
                           const __grid_constant__ DHSpec sp) {
  constexpr int KP = FP / 3 < kMaxP ? FP / 3 : kMaxP;
  using L = MultiSmem<FP>;
  constexpr int CG = multi_pass_classes<FP, kInst, NC>();
  float* smem = diffco_multi_smem;
  const int tid = threadIdx.x;
  const int F = 3 * sp.P;
  if (tid < kMultiRows) {   // the rows' points
    const int b = blockIdx.x * kMultiRows + tid;
    const bool live = b < B;
    float qr[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      qr[j] = (live && j < sp.J) ? q[static_cast<size_t>(b) * sp.J + j]
                                 : 0.f;
    float x[FP], az[3 * kMaxJ], ao[3 * kMaxJ];  // az, ao dead here
#pragma unroll
    for (int f = 0; f < FP; ++f) x[f] = 0.f;
    dh_chain<KP>(qr, sp, x, az, ao);
#pragma unroll
    for (int f = 0; f < FP; ++f) smem[L::kX + tid * FP + f] = x[f];
  }
  multi_zero_padding<FP>(smem, F);
  for (int k0 = 0; k0 < C; k0 += CG) {
    const int cg = min(CG, C - k0);
    if constexpr (kInst == kInstReg) {
      multi_reg_pass<FP, NC>(s, W, S, F, C, smem);
      dh_multi_epilogue<FP>(q, score, dq, B, C, k0, cg, sp, smem,
                            smem + L::kTile, multi_reg_stride<FP, NC>(), 0,
                            kMultiRows);
    } else {
      float acc[8][8];
      multi_score_pass<FP, kInst == kInstNarrow>(s, W, S, F, C, k0, smem,
                                                 acc);
      for (int h = 0; h < kMultiRows / kTileRows; ++h) {
        multi_put_tile(acc, h, smem + L::kTile);
        dh_multi_epilogue<FP>(q, score, dq, B, C, k0, cg, sp, smem,
                              smem + L::kTile, kTileStride, h * kTileRows,
                              kTileRows);
      }
    }
  }
}

// ---- launch code (the CPU replay test compiles the file up to here)

// the kernel's instance for each block instance (multi_launch)
template <int FP>
auto kernel_of() {
  return [](auto inst, auto nc) {
    constexpr int I = decltype(inst)::value, N = decltype(nc)::value;
    return dh_multi_score_grad_kernel<FP, I, N>;
  };
}

}  // namespace
}  // namespace diffco

#include "chain_wide_launch.cuh"

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                              \
  diffco::multi_launch<FPV>(B, C, st, diffco::kernel_of<FPV>(), q, s, W, \
                            score, dq, B, S, C, sp)
  DIFFCO_FP_SWITCH((3 * sp.P + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// The launch plan of a DH robot with P control points and C classes (see
// multi_launch_plan); returns the cudaError_t of the occupancy query.
extern "C" int dh_multi_score_plan(int P, int C, int* out) {
  if (P < 1 || P > diffco::kMaxP || C < 1 || C > diffco::kMaxC)
    return cudaErrorInvalidValue;
#define DIFFCO_PLAN(FPV) \
  diffco::multi_launch_plan<FPV>(C, out, diffco::kernel_of<FPV>())
  DIFFCO_FP_SWITCH((3 * P + 7) / 8 * 8, DIFFCO_PLAN)
#undef DIFFCO_PLAN
}

// The wide instance (chain_wide.cuh) for a chain past the multi-class
// block's bounds, after its prologue (wide_prep) has written the supports
// and the C weight columns into `prep`: `host` is the ChainSpecWide as the
// host built it, `dev` its copy in device memory, `zo` a scratch of B M 6
// floats. Returns the cudaError_t of the launch.
extern "C" int dh_multi_score_grad_wide(
    const float* q, const double* prep, float* score, float* dq, int B,
    int S, int C, const diffco::ChainSpecWide* host,
    const diffco::ChainSpecWide* dev, float* zo, void* stream) {
  return diffco::chain_wide_launch(q, prep, score, dq, B, S, C, host, dev,
                                   zo, static_cast<cudaStream_t>(stream));
}
