// The wide instances of the one-pass FK kernels: chain FK + polyharmonic
// score + configuration gradient for chains past the tensor-core
// kernels' bounds, with C weight columns (B3 and B1 at C = 1, B5 and B4 at
// C = 1-8). The JAX kernels take any chain; the tensor-core and
// multi-class blocks keep their chain in a by-value kernel argument (4 KB)
// and their rows in registers and shared memory sized for at most 16
// moving joints and 21 control points (B1, B4: 8 joints, 16 points). Here
// one build serves every chain of up to kWideMaxM moving joints,
// kWideMaxD dofs and kWideMaxCP control points (F = 3P <= 192, B2's
// kWideMaxF): a rope of 35 links (34 points, F = 102), three Panda arms.
// A DH chain arrives folded into the same form (ops/fk_score.py: per
// joint a revolute about z behind the previous joint's constant (a, d,
// alpha) transform).
//
// Design (chain_wide_score_kernel<K>, K = ceil(3P / 32)):
// - the ChainSpecWide (6 KB) lives in a device buffer, is copied into the
//   block's shared memory once, and every thread reads it from there;
//   beside it each point's moving ancestors as a 64-bit mask;
// - the block's wide_rows<K>() rows, R = wide_rows_per_warp<K>() a warp:
//   lane r < R of each warp runs chain_fk for row r of its warp (one
//   thread a configuration, as the tensor-core kernels do) into the row's
//   points x, moving frames fr and world axes and origins zo, all in
//   shared memory (a row takes 2 * 32K + 19 M floats);
// - per class c the warp's lanes run the wide score block (wide_pairs, fp64
//   pairs from direct differences, chunk by chunk) on the row's points and
//   weight column c, and write the point gradient g to the row's shared
//   slot; then the backward runs across the warp's lanes, one moving
//   joint a lane (lanes m and m + 32): the sum over the points it moves
//   (the masks) of (z_m x (x_k - o_m)) . g_k, or z_m . g_k for a
//   prismatic joint, times its mimic multiplier; one dof a lane then adds
//   its joints' values in joint order and writes dq [C, B, D], and lane 0
//   the score [B, C].
// The FK runs once a row on one lane; the pairs, ~3K fp64 operations a
// lane and five double shuffles each, dominate.
#pragma once

#include "chain_fk.cuh"
#include "wide_score_block.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {

// The ChainSpecWide's floats in shared memory, a multiple of 4.
constexpr int kWideSpecFloats = (sizeof(ChainSpecWide) / 4 + 3) / 4 * 4;
// the points' ancestor masks, 64 bits each
constexpr int kWideAncFloats = 2 * kWideMaxCP;

// floats of one row: x and -g (32 K each), fr (12 M), zo (6 M), the
// joints' values (M)
template <int K>
__host__ __device__ constexpr int chain_wide_row_floats(int M) {
  return 2 * 32 * K + 19 * M;
}

// the kernel's dynamic shared memory: the pairs' chunk, the spec, the
// masks, the rows
template <int K>
__host__ __device__ constexpr int chain_wide_smem_bytes(int M) {
  return wide_smem_bytes<K>() +
         4 * (kWideSpecFloats + kWideAncFloats +
              wide_rows<K>() * chain_wide_row_floats<K>(M));
}

template <int K>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks)
chain_wide_score_kernel(const float* __restrict__ q,
                        const float* __restrict__ s,
                        const float* __restrict__ W,
                        float* __restrict__ score, float* __restrict__ dq,
                        int B, int S, int C,
                        const ChainSpecWide* __restrict__ spg) {
  constexpr int R = wide_rows_per_warp<K>(), FW = 32 * K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* chunk = diffco_tc_smem;
  float* spf = chunk + wide_smem_bytes<K>() / 4;
  {  // the spec, word by word
    const int* src = reinterpret_cast<const int*>(spg);
    int* dst = reinterpret_cast<int*>(spf);
    for (int i = tid; i < static_cast<int>(sizeof(ChainSpecWide) / 4);
         i += kWideThreads)
      dst[i] = src[i];
  }
  __syncthreads();
  const ChainSpecWide& sp = *reinterpret_cast<const ChainSpecWide*>(spf);
  const int M = sp.M, D = sp.D, P = sp.P, F = 3 * P;
  // bit m of anc[k]: moving joint m moves point k
  auto* anc = reinterpret_cast<unsigned long long*>(spf + kWideSpecFloats);
  for (int k = tid; k < P; k += kWideThreads) {
    unsigned long long a = 0;
    for (int m = sp.pframe[k]; m >= 0; m = sp.mparent[m]) a |= 1ull << m;
    anc[k] = a;
  }
  const int RS = chain_wide_row_floats<K>(M);
  float* rows = spf + kWideSpecFloats + kWideAncFloats;
  const int r0 = blockIdx.x * wide_rows<K>() + warp * R;
  if (lane < R) {  // FK of the row (a row past B as row B - 1, not written)
    float* x = rows + (warp * R + lane) * RS;
    const int b = min(r0 + lane, B - 1);
    for (int f = 0; f < FW; ++f) x[f] = 0.f;
    chain_fk<kWideMaxCP>(q + static_cast<size_t>(b) * D, true, sp,
                         reinterpret_cast<float(*)[12]>(x + 2 * FW),
                         reinterpret_cast<float(*)[6]>(x + 2 * FW + 12 * M),
                         x);
  }
  __syncthreads();
  double xr[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      xr[r][k] =
          static_cast<double>(rows[(warp * R + r) * RS + lane + 32 * k]);
  }
  for (int c = 0; c < C; ++c) {
    double g[R][K], sc[R];
    wide_pairs<K, R>(s, W + c, C, S, F, chunk, xr, g, sc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        rows[(warp * R + r) * RS + FW + lane + 32 * k] =
            -static_cast<float>(g[r][k]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {  // the joints' values, a joint a lane
      const float* x = rows + (warp * R + r) * RS;
      const float* gneg = x + FW;
      const float(*zo)[6] =
          reinterpret_cast<const float(*)[6]>(x + 2 * FW + 12 * M);
      float* jv = const_cast<float*>(x) + 2 * FW + 18 * M;
      for (int m = lane; m < M; m += 32) {
        const float zx = zo[m][0], zy = zo[m][1], zz = zo[m][2];
        const float ox = zo[m][3], oy = zo[m][4], oz = zo[m][5];
        const bool rev = sp.jtype[m] == kRevolute;
        float val = 0.f;
        for (int k = 0; k < P; ++k) {
          if (!((anc[k] >> m) & 1ull)) continue;
          const float gx = -gneg[3 * k], gy = -gneg[3 * k + 1],
                      gz = -gneg[3 * k + 2];
          if (rev) {
            const float rx = x[3 * k] - ox, ry = x[3 * k + 1] - oy,
                        rz = x[3 * k + 2] - oz;
            val += (zy * rz - zz * ry) * gx + (zz * rx - zx * rz) * gy +
                   (zx * ry - zy * rx) * gz;
          } else {
            val += zx * gx + zy * gy + zz * gz;
          }
        }
        jv[m] = sp.mult[m] * val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {  // dq, a dof a lane, and the score
      const int b = r0 + r;
      if (b >= B) continue;
      const float* jv = rows + (warp * R + r) * RS + 2 * FW + 18 * M;
      for (int d = lane; d < D; d += 32) {
        float v = 0.f;
        for (int m = 0; m < M; ++m)
          if (sp.dof[m] == d) v += jv[m];
        dq[(static_cast<size_t>(c) * B + b) * D + d] = v;
      }
      if (lane == 0)
        score[static_cast<size_t>(b) * C + c] = static_cast<float>(sc[r]);
    }
    __syncthreads();  // the backward's reads are done
  }
}

}  // namespace diffco
