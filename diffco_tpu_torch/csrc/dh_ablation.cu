// Ablations of kernel B1 (csrc/dh_score.cu) for the roofline path, written
// by hand for Hopper.
//
// Replaces: scripts/roofline_fk_score.py::_ablation_call (bodies
// make_ablations and make_mv_full), the TPU kernels that attribute B1's
// time to its stages. Here the stages are cut out of the port's own B1:
// the same one thread per configuration, the same DH chain
// (dh_chain.cuh), the same supports staged through shared memory in
// chunks of kChunk, the same per-pair distance (score_block.cuh). Each
// mode is a prefix of the next, and writes one float per configuration,
// which depends on all the work the mode claims, so that nvcc removes
// none of it:
//
//   kFkOnly      sum over the points' components x + y + z   (FK)
//   kDist        sum_j d2_j, d2 by B1's direct difference,
//                max(d2, 0) + 1e-12                          (+ per-pair distance)
//   kDistRsqrt   sum_j (r_j + 1 / r_j), one rsqrt per pair   (+ rsqrt)
//   kFwd         sum_j w_j r_j, compensated as B1            (+ weighted score)
//   kFullF32Mv   B1's score + sum_i dq_i                     (B1 in full)
//   kFullBf16Mv  kFullF32Mv with r, 1/r, w and s w rounded to bf16 before
//                the score / rowsum / su products, fp32 sums: the
//                reference's make_mv_full(mv_f32=False)
//
// The reference's second rung is sum_j s_j . x, the matrix-unit dot its
// distance is made of; B1 here takes the direct difference and never forms
// that dot, so kDist is B1's own distance stage (the same function up to
// S ||x||^2 + sum_j ||s_j||^2 - 2 (reference)). The reference's bf16
// distance dot is a TPU matrix-unit choice; the port keeps fp32 there, as
// its B1 does. Only the kFull modes run the second FK
// and the backward, as B1 does; the others need one FK.
//
// What bounds it on this card: as B1, the fp32 CUDA cores for every mode
// that reaches the supports (B * S pairs of ~2F operations and more); the
// bytes in and out (~2 MB) for kFkOnly. Built for FP = 24 only (DH robots
// with 6 to 8 control points, PandaFK's 21 components padded): these are
// measurement kernels of the roofline path's one shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dh_chain.cuh"

namespace diffco {
namespace {

constexpr int kAblFP = 24;

enum AblationMode : int {
  kFkOnly = 0,
  kDist = 1,
  kDistRsqrt = 2,
  kFwd = 3,
  kFullF32Mv = 4,
  kFullBf16Mv = 5,
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// d2 of B1's score block: direct difference, clamp, 1e-12 floor.
template <int FP>
__device__ __forceinline__ float pair_d2(const float* x, const float* sj) {
  float d2 = 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    const float df = x[f] - sj[f];
    d2 = fmaf(df, df, d2);
  }
  return fmaxf(d2, 0.f) + 1e-12f;
}

// kFullBf16Mv's staging beside stage_supports: w rounded to bf16 into
// wb_sh [n] and s_jf * w_j rounded to bf16 into sw_sh [n, FP] (zero past
// F), once per chunk, as the reference casts its [S, F + 1] operand once.
template <int FP>
__device__ __forceinline__ void stage_bf16_operands(
    const float* __restrict__ s, const float* __restrict__ w, int c0, int n,
    int F, float* sw_sh, float* wb_sh) {
  for (int i = threadIdx.x; i < n * FP; i += blockDim.x) {
    const int j = i / FP;
    const int f = i - j * FP;
    sw_sh[i] = f < F ? bf16_round(s[static_cast<size_t>(c0 + j) * F + f] *
                                  w[c0 + j])
                     : 0.f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    wb_sh[i] = bf16_round(w[c0 + i]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
dh_ablation_kernel(const float* __restrict__ q, const float* __restrict__ s,
                   const float* __restrict__ w, float* __restrict__ out,
                   int B, int S, const __grid_constant__ DHSpec sp) {
  constexpr int FP = kAblFP;
  constexpr int KP = FP / 3;
  constexpr bool kBf16 = MODE == kFullBf16Mv;
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk];
  __shared__ __align__(16) float sw_sh[kBf16 ? kChunk * FP : 1];
  __shared__ float wb_sh[kBf16 ? kChunk : 1];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;
  const int J = sp.J;
  float qr[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = (live && j < J) ? q[static_cast<size_t>(b) * J + j] : 0.f;
  float x[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) x[f] = 0.f;
  {
    float az[3 * kMaxJ], ao[3 * kMaxJ];  // dead here
    dh_chain<KP>(qr, sp, x, az, ao);
  }
  float acc = 0.f;
  if constexpr (MODE == kFkOnly) {
    // x is zero past 3P, so this is the reference's sum over the points
#pragma unroll
    for (int f = 0; f < FP; ++f) acc += x[f];
  } else {
    const int F = 3 * sp.P;
    float sc = 0.f, scc = 0.f, rs = 0.f;
    float su[kFullF32Mv <= MODE ? FP : 1];
#pragma unroll
    for (int f = 0; f < (kFullF32Mv <= MODE ? FP : 1); ++f) su[f] = 0.f;
    for (int c0 = 0; c0 < S; c0 += kChunk) {
      const int n = min(kChunk, S - c0);
      __syncthreads();
      stage_supports<FP>(s, w, c0, n, F, s_sh, w_sh);
      if constexpr (kBf16) stage_bf16_operands<FP>(s, w, c0, n, F, sw_sh,
                                                  wb_sh);
      __syncthreads();
      if constexpr (MODE == kFullF32Mv) {
        score_grad_accumulate<FP>(x, s_sh, w_sh, n, sc, scc, rs, su);
      } else {
        for (int j = 0; j < n; ++j) {
          const float d2 = pair_d2<FP>(x, s_sh + j * FP);
          if constexpr (MODE == kDist) {
            acc += d2;
          } else {
            const float rinv = rsqrtf(d2);
            const float r = d2 * rinv;
            if constexpr (MODE == kDistRsqrt) {
              acc += r + rinv;
            } else if constexpr (MODE == kFwd) {
              two_sum_add(w_sh[j] * r, sc, scc);
            } else {  // kFullBf16Mv
              const float rb = bf16_round(r);
              const float ib = bf16_round(rinv);
              const float wb = wb_sh[j];
              two_sum_add(wb * rb, sc, scc);
              rs = fmaf(wb, ib, rs);
              const float* swj = sw_sh + j * FP;
#pragma unroll
              for (int f = 0; f < FP; ++f) su[f] = fmaf(swj[f], ib, su[f]);
            }
          }
        }
      }
    }
    if constexpr (MODE == kFwd) acc = sc + scc;
    if constexpr (kFullF32Mv <= MODE) {
      float az[3 * kMaxJ], ao[3 * kMaxJ], dqr[kMaxJ];
      dh_chain<KP>(qr, sp, x, az, ao);
      dh_backward<KP>(sp, x, az, ao, rs, su, dqr);
      acc = sc + scc;
#pragma unroll
      for (int j = kMaxJ - 1; j >= 0; --j)
        if (j < J) acc += dqr[j];
    }
  }
  if (live) out[b] = acc;
}

}  // namespace
}  // namespace diffco

#define DIFFCO_ABL_CASE(M)                                                \
  case diffco::M:                                                         \
    diffco::dh_ablation_kernel<diffco::M><<<grid, diffco::kThreads, 0, st>>>( \
        q, s, w, out, B, S, sp);                                          \
    break;

// out [B] = the mode's one float per configuration (modes as the enum
// above). Returns the cudaError_t of the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int dh_ablation(const float* q, const float* s, const float* w,
                           float* out, int B, int S, int mode,
                           const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || sp.J < 1 || sp.J > diffco::kMaxJ ||
      (3 * sp.P + 7) / 8 * 8 != diffco::kAblFP)
    return cudaErrorInvalidValue;
  const dim3 grid((B + diffco::kThreads - 1) / diffco::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    DIFFCO_ABL_CASE(kFkOnly)
    DIFFCO_ABL_CASE(kDist)
    DIFFCO_ABL_CASE(kDistRsqrt)
    DIFFCO_ABL_CASE(kFwd)
    DIFFCO_ABL_CASE(kFullF32Mv)
    DIFFCO_ABL_CASE(kFullBf16Mv)
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
