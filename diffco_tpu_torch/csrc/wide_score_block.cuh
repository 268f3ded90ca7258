// The wide score block: sum_j w_j ||x - s_j|| and its point gradient for
// rows of F = 65-192 components (poly_score.cu's wide instance of B2) and
// for the control-point rows of chains past the tensor-core kernels'
// bounds (chain_wide.cuh: the wide instances of B1, B3, B4 and B5).
//
// One warp takes R = wide_rows_per_warp<K>() rows, each lane K components
// of each row (f = lane + 32 k, zero past F), K = ceil(F / 32). Per pair
// the lanes form their partial |x - s|^2 from direct differences in fp64,
// the warp sums them with xor shuffles (every lane gets the same sum), and
// each lane adds w rinv d to its components: no expanded square and no
// cancelling x rowsum - su. The supports stream through shared memory in
// chunks of kWideChunk rows of 32 K floats (zero past F), then the chunk's
// kWideChunk weights (wide_smem_bytes<K>()); each chunk is summed into
// fresh fp64 accumulators that are added to the rows' totals after it,
// since fitted weights cancel most at the wide widths. A pair costs ~3K
// fp64 operations a lane and five shuffle-adds of a double.
#pragma once

namespace diffco {

constexpr int kWideMaxF = 192;
constexpr int kWideThreads = 256;
constexpr int kWideChunk = 32;
constexpr int kWideMinBlocks = 2;   // __launch_bounds__: <= 128 registers

// two rows a warp up to K = 4, one above (two rows' components,
// differences and sums would pass 128 registers)
template <int K>
__host__ __device__ constexpr int wide_rows_per_warp() {
  return K <= 4 ? 2 : 1;
}

template <int K>
__host__ __device__ constexpr int wide_rows() {
  return kWideThreads / 32 * wide_rows_per_warp<K>();
}

template <int K>
__host__ __device__ constexpr int wide_smem_bytes() {
  return 4 * kWideChunk * (32 * K + 1);
}

// 1 / sqrt(v) for v >= 1e-12 in fp64: the fp32 rsqrt as the seed, one
// Newton step y (3 - v y^2) / 2 in fp64 (the seed's ~1e-7 relative error
// squared)
__device__ __forceinline__ double f64_rsqrt(double v) {
  const double y = static_cast<double>(rsqrtf(static_cast<float>(v)));
  return y * fma(-0.5 * v * y, y, 1.5);
}

__device__ __forceinline__ double shfl_xor_f64(double v, int mask) {
#if defined(__CUDA_ARCH__)
  return __shfl_xor_sync(0xffffffffu, v, mask);
#elif defined(DIFFCO_REPLAY)
  return diffco_replay_shfl_xor_f64(v, mask);
#else
  return v;
#endif
}

// The pairs of the warp's R rows xr (this lane's K components each)
// against all S supports s [S, F] with weights w[j * wstride]: sc[r] =
// sum_j w_j |x_r - s_j| (the same on every lane) and g[r][k] = this
// lane's components of sum_j w_j (x_r - s_j) / |x_r - s_j|. Every thread
// of the block calls it (it stages the chunks in `chunk`,
// wide_smem_bytes<K>(), between __syncthreads).
template <int K, int R>
__device__ __forceinline__ void wide_pairs(const float* __restrict__ s,
                                           const float* __restrict__ w,
                                           int wstride, int S, int F,
                                           float* chunk,
                                           const double (&xr)[R][K],
                                           double (&g)[R][K],
                                           double (&sc)[R]) {
  constexpr int FW = 32 * K;
  float* wchunk = chunk + kWideChunk * FW;  // [kWideChunk]: w_j
  const int tid = threadIdx.x, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sc[r] = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) g[r][k] = 0.0;
  }
  for (int c0 = 0; c0 < S; c0 += kWideChunk) {
    const int n = min(kWideChunk, S - c0);
    __syncthreads();  // the last chunk's reads are done
    for (int i = tid; i < n * FW; i += kWideThreads) {
      const int j = i / FW, f = i % FW;
      chunk[i] = f < F ? s[static_cast<size_t>(c0 + j) * F + f] : 0.f;
    }
    for (int i = tid; i < n; i += kWideThreads)
      wchunk[i] = w[static_cast<size_t>(c0 + i) * wstride];
    __syncthreads();
    double gc[R][K], scc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      scc[r] = 0.0;
#pragma unroll
      for (int k = 0; k < K; ++k) gc[r][k] = 0.0;
    }
    for (int j = 0; j < n; ++j) {
      double d[R][K], p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = 0.0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const double sv = static_cast<double>(chunk[j * FW + lane + 32 * k]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          d[r][k] = xr[r][k] - sv;
          p[r] = fma(d[r][k], d[r][k], p[r]);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m /= 2) {
#pragma unroll
        for (int r = 0; r < R; ++r) p[r] += shfl_xor_f64(p[r], m);
      }
      const double wj = static_cast<double>(wchunk[j]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double d2 = p[r] + 1e-12, rinv = f64_rsqrt(d2);
        scc[r] = fma(wj, d2 * rinv, scc[r]);
        const double wr = wj * rinv;
#pragma unroll
        for (int k = 0; k < K; ++k) gc[r][k] = fma(wr, d[r][k], gc[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sc[r] += scc[r];
#pragma unroll
      for (int k = 0; k < K; ++k) g[r][k] += gc[r][k];
    }
  }
}

}  // namespace diffco
