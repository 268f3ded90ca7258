// Polyharmonic DiffCo score block of the one-row-per-thread design: only
// dh_score.cu's first design runs it, for the roofline path's B1
// block-size sweep. Every other kernel takes only its TwoSum
// (tc_score_block.cuh for B1-B3, B6 and B7, multi_score_block.cuh for B4
// and B5).
//
// For one query x (FP components, zero-padded past F) against a chunk of
// supports s_j with weights w_j:
//
//   d2     = sum_f (x_f - s_jf)^2            (direct difference, fp32;
//                                             about F more operations per pair
//                                             than the expanded square,
//                                             and no cancellation)
//   rinv   = rsqrt(max(d2, 0) + 1e-12)       (one transcendental per pair)
//   score  += w_j * d2 * rinv                (= w_j * ||x - s_j||)
//   rowsum += w_j * rinv,  su_f += w_j * s_jf * rinv
//
// after which d score / d x = x * rowsum - su. The 1e-12 floor and
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

constexpr int kChunk = 128;    // supports staged in shared memory per pass
constexpr int kMaxC = 8;       // weight columns the multi-class kernels take

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

// Accumulates one chunk of n supports (weights w_chunk [n]); the caller's
// score is score + comp. Every index is a compile-time constant after
// unrolling, so the sums stay in registers.
template <int FP>
DIFFCO_HD void score_grad_accumulate(const float* x, const float* s_chunk,
                                     const float* w_chunk, int n,
                                     float& score, float& comp,
                                     float& rowsum, float* su) {
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
    const float wj = w_chunk[j];
    two_sum_add(wj * r, score, comp);
    const float u = wj * rinv;
    rowsum += u;
#pragma unroll
    for (int f = 0; f < FP; ++f) su[f] = fmaf(sj[f], u, su[f]);
  }
}

#ifdef __CUDACC__
// Stage supports [c0, c0 + n) of s [S, F] (row-major) into s_sh [n, FP],
// zero-padding components F..FP-1, and their weights w into w_sh [n].
// Every thread of the block takes part; callers put __syncthreads()
// around it.
template <int FP>
__device__ __forceinline__ void stage_supports(const float* __restrict__ s,
                                               const float* __restrict__ w,
                                               int c0, int n, int F,
                                               float* s_sh, float* w_sh) {
  for (int i = threadIdx.x; i < n * FP; i += blockDim.x) {
    const int j = i / FP;
    const int f = i - j * FP;
    s_sh[i] = f < F ? s[static_cast<size_t>(c0 + j) * F + f] : 0.f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) w_sh[i] = w[c0 + i];
}
#endif

}  // namespace diffco
