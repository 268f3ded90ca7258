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
// the floor, and nearly all of it is the per-class gradient sums.
//
// Design: the score block of multi_score_block.cuh, as the TPU kernel
// does it (one rinv per pair, every class's [s w | w] sums in one product
// against it): a block of 128 configurations and 256 threads computes
// each pair's distance and rsqrt once for all the classes of a pass
// (phase A, two threads per configuration), then the class sums as an
// fp32 register-tiled product of the chunk's rinv tile with the class
// table [s_j w_jc | w_jc] (phase B). A pass takes Cg = floor(128 /
// (FP + 1)) classes (5 at FrankaPanda's FP = 24), so C = 5 reads each
// support once; only C > Cg takes more passes. The launch rule
// (multi_dispatch) sends C <= 2 at FP = 24 to the block's register
// instance, which sums each class in registers during phase A and has no
// product. The FK runs once per configuration up front, for the points
// (shared memory), and again in the epilogue, once per thread that takes
// one of the configuration's classes, for the moving frames' axes and
// origins (indexed by data, so per-thread local memory, written and read
// there). Recomputing them keeps the kernel within the 128 registers and
// ~64 KB of shared memory per thread and block at which two blocks (16
// warps) stay resident per SM. W arrives as a device pointer (row-major
// [S, C]): the folded ChainSpec already takes 1628 B of the 4 KB
// kernel-parameter space. One build serves every chain with M <= 16
// moving joints, D <= 16 dofs, P <= 21 points and every C <= kMaxC = 8.
// A chain past those bounds launches the wide instance
// (chain_multi_score_grad_wide, chain_wide.cuh) up to 64 of each; the
// wrapper raises beyond.
#include <cuda_runtime.h>

#include "chain_wide.cuh"
#include "multi_score_block.cuh"

extern __shared__ __align__(16) float diffco_multi_smem[];

namespace diffco {
namespace {

// The epilogue of a pass for block rows row0 .. row0 + nrows - 1, whose
// sums lie at tile[(row - row0) * stride + c (FP + 1) + f] (su_c, then
// rowsum_c at f = FP): a thread per (row, class slot) runs the row's FK
// again for its frames, then the backward of each of its classes, and
// writes their scores and dq.
template <int FP>
__device__ __forceinline__ void chain_multi_epilogue(
    const float* __restrict__ q, float* __restrict__ score,
    float* __restrict__ dq, int B, int C, int k0, int cg, const ChainSpec& sp,
    const float* smem, const float* tile, int stride, int row0, int nrows,
    float (&fr)[kMaxM][12], float (&zo)[kMaxM][6]) {
  constexpr int KP = FP / 3 < kMaxCP ? FP / 3 : kMaxCP;
  const int per = kMultiThreads / nrows;
  const int rt = threadIdx.x % nrows, slot = threadIdx.x / nrows;
  if (slot >= cg) return;
  const int row = row0 + rt;
  const int b = blockIdx.x * kMultiRows + row;
  const bool live = b < B;
  float x[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) x[f] = 0.f;
  chain_fk<KP>(q + static_cast<size_t>(live ? b : 0) * sp.D, live, sp, fr,
               zo, x);
  for (int c = slot; c < cg; c += per) {
    const float* t = tile + rt * stride + c * (FP + 1);
    float dqr[kMaxD];
    chain_backward<KP>(sp, zo, x, t[FP], t, dqr);
    if (live) {
      score[static_cast<size_t>(b) * C + k0 + c] =
          multi_class_score<FP>(smem, row, c);
      float* dqb = dq + (static_cast<size_t>(k0 + c) * B + b) * sp.D;
      for (int d = 0; d < sp.D; ++d) dqb[d] = dqr[d];
    }
  }
}

// kInst: kInstReg (NC = C classes), kInstNarrow or kInstFull (NC = 0)
template <int FP, int kInst, int NC>
__global__ void __launch_bounds__(kMultiThreads, 2)
chain_multi_score_grad_kernel(const float* __restrict__ q,
                              const float* __restrict__ s,
                              const float* __restrict__ W,
                              float* __restrict__ score,
                              float* __restrict__ dq, int B, int S, int C,
                              const __grid_constant__ ChainSpec sp) {
  constexpr int KP = FP / 3 < kMaxCP ? FP / 3 : kMaxCP;
  using L = MultiSmem<FP>;
  constexpr int CG = multi_pass_classes<FP, kInst, NC>();
  float* smem = diffco_multi_smem;
  const int tid = threadIdx.x;
  const int F = 3 * sp.P;
  float fr[kMaxM][12], zo[kMaxM][6];
  if (tid < kMultiRows) {   // the rows' points
    const int b = blockIdx.x * kMultiRows + tid;
    const bool live = b < B;   // the ragged end of B is masked here
    float x[FP];
#pragma unroll
    for (int f = 0; f < FP; ++f) x[f] = 0.f;
    chain_fk<KP>(q + static_cast<size_t>(live ? b : 0) * sp.D, live, sp, fr,
                 zo, x);
#pragma unroll
    for (int f = 0; f < FP; ++f) smem[L::kX + tid * FP + f] = x[f];
  }
  multi_zero_padding<FP>(smem, F);
  for (int k0 = 0; k0 < C; k0 += CG) {
    const int cg = min(CG, C - k0);
    if constexpr (kInst == kInstReg) {
      multi_reg_pass<FP, NC>(s, W, S, F, C, smem);
      chain_multi_epilogue<FP>(q, score, dq, B, C, k0, cg, sp, smem,
                               smem + L::kTile, multi_reg_stride<FP, NC>(),
                               0, kMultiRows, fr, zo);
    } else {
      float acc[8][8];
      multi_score_pass<FP, kInst == kInstNarrow>(s, W, S, F, C, k0, smem,
                                                 acc);
      for (int h = 0; h < kMultiRows / kTileRows; ++h) {
        multi_put_tile(acc, h, smem + L::kTile);
        chain_multi_epilogue<FP>(q, score, dq, B, C, k0, cg, sp, smem,
                                 smem + L::kTile, kTileStride,
                                 h * kTileRows, kTileRows, fr, zo);
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
    return chain_multi_score_grad_kernel<FP, I, N>;
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
    case 56: return CALL(56);       \
    case 64: return CALL(64);       \
    default: return cudaErrorInvalidValue; \
  }

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(FPV)                                              \
  diffco::multi_launch<FPV>(B, C, st, diffco::kernel_of<FPV>(), q, s, W, \
                            score, dq, B, S, C, sp)
  DIFFCO_FP_SWITCH((3 * sp.P + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// The launch plan of a chain with P control points and C classes (see
// multi_launch_plan); returns the cudaError_t of the occupancy query.
extern "C" int chain_multi_score_plan(int P, int C, int* out) {
  if (P < 1 || P > diffco::kMaxCP || C < 1 || C > diffco::kMaxC)
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
extern "C" int chain_multi_score_grad_wide(
    const float* q, const double* prep, float* score, float* dq, int B,
    int S, int C, const diffco::ChainSpecWide* host,
    const diffco::ChainSpecWide* dev, float* zo, void* stream) {
  return diffco::chain_wide_launch(q, prep, score, dq, B, S, C, host, dev,
                                   zo, static_cast<cudaStream_t>(stream));
}
