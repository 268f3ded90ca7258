// Launch code of chain_wide.cuh's kernel, for the four sources that
// include it after their device code (chain_score.cu, chain_multi_score.cu,
// dh_score.cu, dh_multi_score.cu), with the wide block's prologue entry
// (wide_launch.cuh).
#pragma once

#include <cuda_runtime.h>

#include "chain_wide.cuh"
#include "wide_launch.cuh"

namespace diffco {
namespace {

template <int K>
int chain_wide_launch_k(const float* q, const double* prep, float* score,
                        float* dq, int B, int S, int C,
                        const ChainSpecWide* dev, float* zo,
                        cudaStream_t st) {
  const auto kernel = chain_wide_score_kernel<K>;
  const int bytes = chain_wide_smem_bytes<K>();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kWideRows - 1) / kWideRows, kWideThreads<K>, bytes, st>>>(
      q, prep, score, dq, B, S, C, dev, zo);
  return static_cast<int>(cudaGetLastError());
}

// Launches the wide kernel over B configurations and C weight columns
// (score [B, C], dq [C, B, D]) on `st`. `prep` holds the S supports and C
// weight columns as the wide block's prologue (wide_prep, launched by the
// caller on the same stream before) wrote them; `host` is the spec as the
// host built it (checked here), `dev` its copy on the device (read by the
// kernel), `zo` the caller's scratch for the joints' world axes and
// origins between the FK and the backward (B M 6 floats). The
// cudaError_t, 0 on success.
inline int chain_wide_launch(const float* q, const double* prep,
                             float* score, float* dq, int B, int S, int C,
                             const ChainSpecWide* host,
                             const ChainSpecWide* dev, float* zo,
                             cudaStream_t st) {
  if (B <= 0 || S < 0 || C < 1 || C > kMaxC || prep == nullptr ||
      dev == nullptr || zo == nullptr || !spec_ok(*host))
    return cudaErrorInvalidValue;
#define DIFFCO_WIDE(KV)                                                    \
  case KV:                                                                 \
    return chain_wide_launch_k<KV>(q, prep, score, dq, B, S, C, dev, zo, st)
  switch ((3 * host->P + 31) / 32) {
    DIFFCO_WIDE(1);
    DIFFCO_WIDE(2);
    DIFFCO_WIDE(3);
    DIFFCO_WIDE(4);
    DIFFCO_WIDE(5);
    DIFFCO_WIDE(6);
    default: return cudaErrorInvalidValue;
  }
#undef DIFFCO_WIDE
}

// out = {dynamic shared bytes per block, blocks resident per SM by the
// runtime's occupancy calculator, threads per block, configurations per
// block} of the wide kernel for P points (any M moving joints).
template <int K>
int chain_wide_plan_k(int* out) {
  const auto kernel = chain_wide_score_kernel<K>;
  const int bytes = chain_wide_smem_bytes<K>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kWideThreads<K>, bytes);
  out[0] = bytes;
  out[1] = blocks;
  out[2] = kWideThreads<K>;
  out[3] = kWideRows;
  return static_cast<int>(e);
}

inline int chain_wide_plan(int P, int M, int* out) {
  if (P < 1 || P > kWideMaxCP || M < 1 || M > kWideMaxM)
    return cudaErrorInvalidValue;
  switch ((3 * P + 31) / 32) {
    case 1: return chain_wide_plan_k<1>(out);
    case 2: return chain_wide_plan_k<2>(out);
    case 3: return chain_wide_plan_k<3>(out);
    case 4: return chain_wide_plan_k<4>(out);
    case 5: return chain_wide_plan_k<5>(out);
    case 6: return chain_wide_plan_k<6>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace diffco
