// Polyharmonic DiffCo score block shared by the one-row-per-thread
// kernels (poly_score.cu, dh_score.cu, chain_score.cu, dh_multi_score.cu;
// chain_multi_score.cu takes only its TwoSum, through
// multi_score_block.cuh).
//
// For one query x (FP components, zero-padded past F) against a chunk of
// supports s_j with weights w_jc (CT weight columns; CT = 1 for a scalar
// proxy):
//
//   d2     = sum_f (x_f - s_jf)^2            (direct difference, fp32;
//                                             about F more operations per pair
//                                             than the expanded square,
//                                             and no cancellation)
//   rinv   = rsqrt(max(d2, 0) + 1e-12)       (one transcendental per pair,
//                                             shared by the CT columns)
//   score_c  += w_jc * d2 * rinv             (= w_jc * ||x - s_j||)
//   rowsum_c += w_jc * rinv,  su_cf += w_jc * s_jf * rinv
//
// after which d score_c / d x = x * rowsum_c - su_c. The 1e-12 floor and
// the clamp follow diffco_tpu/ops/fused_score.py::_make_fwdgrad_kernel.
//
// Each score is summed with compensation (TwoSum: sum + comp carries the
// total). Fitted weights alternate in sign and are large next to the
// score they sum to (a FrankaPanda proxy with S = 896: sum_j |w_j| r_j
// ~ 7e3 against |score| ~ 1), so one running fp32 sum over S supports
// loses ~1e-3 of the score; the compensation keeps it near the rounding
// of the terms themselves, for 6 more operations per pair and class. The
// gradient sums (rowsum, su) stay plain: compensating su would double the
// work.
#pragma once

#ifndef DIFFCO_HD
#define DIFFCO_HD __host__ __device__ __forceinline__
#endif

namespace diffco {

constexpr int kThreads = 128;  // one query row per thread
constexpr int kChunk = 128;    // supports staged in shared memory per pass
constexpr int kMaxC = 8;       // weight columns the multi-class kernels take
constexpr int kClassTile = 2;  // weight columns per pass over the supports

// sum + comp += term, with the rounding error of the add kept in comp
// (Knuth's TwoSum). The _rn intrinsics keep nvcc from fusing these adds
// with the product that formed term.
DIFFCO_HD void two_sum_add(float term, float& sum, float& comp) {
#ifdef __CUDA_ARCH__
  const float t = __fadd_rn(sum, term);
  const float z = __fsub_rn(t, sum);
  comp += __fadd_rn(__fsub_rn(sum, __fsub_rn(t, z)), __fsub_rn(term, z));
#else
  const float t = sum + term;
  const float z = t - sum;
  comp += (sum - (t - z)) + (term - z);
#endif
  sum = t;
}

// Accumulates one chunk of supports for CT weight columns (w_chunk
// [n, CT], row-major): column c keeps score[c] + comp[c], rowsum[c] and
// su[c * FP .. c * FP + FP - 1]. Every index is a compile-time constant
// after unrolling, so the sums stay in registers.
template <int FP, int CT>
DIFFCO_HD void score_grad_accumulate_multi(const float* x,
                                           const float* s_chunk,
                                           const float* w_chunk, int n,
                                           float* score, float* comp,
                                           float* rowsum, float* su) {
  for (int j = 0; j < n; ++j) {
    const float* sj = s_chunk + j * FP;
    float d2 = 0.f;
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      const float df = x[f] - sj[f];
      d2 = fmaf(df, df, d2);
    }
    d2 = fmaxf(d2, 0.f) + 1e-12f;
    const float rinv = rsqrtf(d2);
    const float r = d2 * rinv;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float wj = w_chunk[j * CT + c];
      two_sum_add(wj * r, score[c], comp[c]);
      const float u = wj * rinv;
      rowsum[c] += u;
#pragma unroll
      for (int f = 0; f < FP; ++f)
        su[c * FP + f] = fmaf(sj[f], u, su[c * FP + f]);
    }
  }
}

// The one-column form; the caller's score is score + comp.
template <int FP>
DIFFCO_HD void score_grad_accumulate(const float* x, const float* s_chunk,
                                     const float* w_chunk, int n,
                                     float& score, float& comp,
                                     float& rowsum, float* su) {
  score_grad_accumulate_multi<FP, 1>(x, s_chunk, w_chunk, n, &score, &comp,
                                     &rowsum, su);
}

#ifdef __CUDACC__
// Stage supports [c0, c0 + n) of s [S, F] (row-major) into s_sh [n, FP],
// zero-padding components F..FP-1, and weight columns [k0, k0 + CT) of
// w [S, C] into w_sh [n, CT], zero past column C - 1 (a padded column
// adds nothing). Every thread of the block takes part; callers put
// __syncthreads() around it.
template <int FP, int CT = 1>
__device__ __forceinline__ void stage_supports(const float* __restrict__ s,
                                               const float* __restrict__ w,
                                               int c0, int n, int F,
                                               float* s_sh, float* w_sh,
                                               int C = 1, int k0 = 0) {
  for (int i = threadIdx.x; i < n * FP; i += blockDim.x) {
    const int j = i / FP;
    const int f = i - j * FP;
    s_sh[i] = f < F ? s[static_cast<size_t>(c0 + j) * F + f] : 0.f;
  }
  for (int i = threadIdx.x; i < n * CT; i += blockDim.x) {
    const int j = i / CT;
    const int k = k0 + i - j * CT;
    w_sh[i] = k < C ? w[static_cast<size_t>(c0 + j) * C + k] : 0.f;
  }
}
#endif

}  // namespace diffco
