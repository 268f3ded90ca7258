// Launch code of the wide score block's prologue (wide_score_block.cuh's
// wide_prep_kernel) and its C entry, for the five sources with a wide
// instance (poly_score.cu, and through chain_wide_launch.cuh chain_score.cu,
// chain_multi_score.cu, dh_score.cu, dh_multi_score.cu), each of which
// exports it as `wide_prep`.
#pragma once

#include <cuda_runtime.h>

#include "wide_score_block.cuh"

// Writes supports s [S, F] and weight columns W [S, C] (float32, row-major)
// ready for a wide instance into `out` (diffco::wide_prep_doubles(S, F, C)
// doubles, 16-byte aligned) on `stream`, before the score kernel's launch
// on the same stream: the centre, s~ in fp64 padded to whole chunks, and
// per column (|s~|^2, w). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int wide_prep(const float* s, const float* W, int S, int F, int C,
                         double* out, void* stream) {
  if (S < 0 || F < 1 || F > diffco::kWideMaxF || C < 1 || out == nullptr)
    return cudaErrorInvalidValue;
  const int blocks = S > 0 ? diffco::wide_padded(S) / diffco::kWideChunk : 1;
  diffco::wide_prep_kernel<<<blocks, diffco::kWidePrepThreads,
                             8 * diffco::wide_stride(F),
                             static_cast<cudaStream_t>(stream)>>>(
      s, W, S, F, C, out);
  return static_cast<int>(cudaGetLastError());
}
