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
// Design (chain_wide_score_kernel<K>, K = ceil(3P / 32); two launches a
// call, the wide block's prologue wide_prep_kernel first):
// - the ChainSpecWide (6 KB) lives in a device buffer, is copied into the
//   block's shared memory once, and every thread reads it from there;
//   beside it each point's moving ancestors as a 64-bit mask;
// - the block's kWideRows = 64 rows, one thread a row (threads 0-63, as
//   the tensor-core kernels run one thread a configuration): chain_fk
//   writes the row's points into the wide block's fp32 rows and each
//   moving joint's world axis and origin (zo) to the caller's scratch in
//   device memory, zo [B, M, 6] (what the backward reads after the
//   supports; in shared memory it would take 54 KB a block at the rope's
//   35 joints); the moving frames, indexed by data and used by the FK
//   only, stay in the thread's local memory;
// - the wide score block (wide_score_block.cuh: the prologue's fp64 s~,
//   both products on the fp64 tensor cores, a warp's accumulators in its
//   registers) runs the pairs once per class c, on the prologue's weight
//   column c (product 1 and the pair work are redone per class, s~ is
//   prepared once for all);
// - then the backward, each warp a row at a time: its lanes turn the
//   row's sums into its gradient (x~ rowsum - su~) in fp32 over the row's
//   own sums, then one moving joint a lane (lanes m and m + 32) sums over
//   the points it moves (the masks) (z_m x (x_k - o_m)) . g_k, or z_m .
//   g_k for a prismatic joint, times its mimic multiplier, into the warp's
//   joints' values; one dof a lane then adds its joints' values in joint
//   order and writes dq [C, B, D], and lane 0 the score [B, C]. No
//   atomics.
// The block takes 37-160 KB of shared memory at K = 1-6 whatever the
// chain (two blocks of 4 warps per SM at K = 3, 4: the 35-link rope).
#pragma once

#include "chain_fk.cuh"
#include "wide_score_block.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {

// The ChainSpecWide's floats in shared memory, a multiple of 4.
constexpr int kWideSpecFloats = (sizeof(ChainSpecWide) / 4 + 3) / 4 * 4;
// the points' ancestor masks, 64 bits each
constexpr int kWideAncFloats = 2 * kWideMaxCP;
// a warp's joints' values in the backward
constexpr int kWideJvFloats = (kWideMaxM + 1 + 3) / 4 * 4;

// the kernel's dynamic shared memory: the wide block's, the spec, the
// masks, the warps' joints' values (the backward's gradients go over the
// block's sums)
template <int K>
__host__ __device__ constexpr int chain_wide_smem_bytes() {
  return WideSmem<K>::kBytes +
         4 * (kWideSpecFloats + kWideAncFloats +
              kWideThreads<K> / 32 * kWideJvFloats);
}

// The spec, then its ancestor masks and the warps' joints' values, after
// the wide block's shared memory.
template <int K>
__device__ __forceinline__ float* chain_wide_spec(double* sm) {
  return reinterpret_cast<float*>(sm + WideSmem<K>::kEnd);
}

// After wide_tc_pairs for class c of C: the block's live rows' backward
// (a warp a row, a joint a lane, from zo_g [B, M, 6]), then dq [C, B, D],
// a dof a lane, and the score [B, C]. Out of line: the pair loop's
// registers stay its own.
template <int K>
__device__ __noinline__ void chain_wide_epilogue(
    double* sm, const float* __restrict__ zo_g, float* __restrict__ score,
    float* __restrict__ dq, int B, int c, int C) {
  using L = WideSmem<K>;
  constexpr int kWarps = kWideThreads<K> / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* spf = chain_wide_spec<K>(sm);
  const ChainSpecWide& sp = *reinterpret_cast<const ChainSpecWide*>(spf);
  const auto* anc =
      reinterpret_cast<const unsigned long long*>(spf + kWideSpecFloats);
  float* jv = const_cast<float*>(spf) + kWideSpecFloats + kWideAncFloats +
              warp * kWideJvFloats;
  const int M = sp.M, D = sp.D, P = sp.P, F = 3 * P;
  const int b0 = blockIdx.x * kWideRows;
  const int live = min(kWideRows, B - b0);
  for (int r = warp; r < live; r += kWarps) {  // a joint a lane
    // the row's gradient in fp32 over its own sums
    float v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int f = lane + 32 * i;
      v[i] = f < F ? static_cast<float>(wide_row_grad<K>(sm, r, f, F)) : 0.f;
    }
    wide_syncwarp();
    float* gr = reinterpret_cast<float*>(sm + L::kSums + r * L::kS);
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (lane + 32 * i < F) gr[lane + 32 * i] = v[i];
    wide_syncwarp();
    const float* xr = reinterpret_cast<const float*>(sm + L::kX) + r * L::kSx;
    const float(*zo)[6] = reinterpret_cast<const float(*)[6]>(
        zo_g + static_cast<size_t>(b0 + r) * M * 6);
    for (int m = lane; m < M; m += 32) {
      const float zx = zo[m][0], zy = zo[m][1], zz = zo[m][2];
      const float ox = zo[m][3], oy = zo[m][4], oz = zo[m][5];
      const bool rev = sp.jtype[m] == kRevolute;
      float val = 0.f;
      for (int k = 0; k < P; ++k) {
        if (!((anc[k] >> m) & 1ull)) continue;
        const float gx = gr[3 * k], gy = gr[3 * k + 1], gz = gr[3 * k + 2];
        if (rev) {
          const float rx = xr[3 * k] - ox, ry = xr[3 * k + 1] - oy,
                      rz = xr[3 * k + 2] - oz;
          val += (zy * rz - zz * ry) * gx + (zz * rx - zx * rz) * gy +
                 (zx * ry - zy * rx) * gz;
        } else {
          val += zx * gx + zy * gy + zz * gz;
        }
      }
      jv[m] = sp.mult[m] * val;
    }
    wide_syncwarp();
    const int b = b0 + r;  // dq, a dof a lane
    for (int d = lane; d < D; d += 32) {
      float s = 0.f;
      for (int m = 0; m < M; ++m)
        if (sp.dof[m] == d) s += jv[m];
      dq[(static_cast<size_t>(c) * B + b) * D + d] = s;
    }
    if (lane == 0)
      score[static_cast<size_t>(b) * C + c] =
          static_cast<float>(wide_row_score<K>(sm, r));
    wide_syncwarp();  // the next row's values go over these
  }
  __syncthreads();  // the sums' readers are done: the next class stages
}

template <int K>
__global__ void __launch_bounds__(kWideThreads<K>, kWideMinBlocks<K>)
chain_wide_score_kernel(const float* __restrict__ q,
                        const double* __restrict__ prep,
                        float* __restrict__ score, float* __restrict__ dq,
                        int B, int S, int C,
                        const ChainSpecWide* __restrict__ spg,
                        float* __restrict__ zo_g) {
  using L = WideSmem<K>;
  const int tid = threadIdx.x;
  double* sm = reinterpret_cast<double*>(diffco_tc_smem);
  float* spf = chain_wide_spec<K>(sm);
  {  // the spec, word by word
    const int* src = reinterpret_cast<const int*>(spg);
    int* dst = reinterpret_cast<int*>(spf);
    for (int i = tid; i < static_cast<int>(sizeof(ChainSpecWide) / 4);
         i += kWideThreads<K>)
      dst[i] = src[i];
  }
  __syncthreads();
  const ChainSpecWide& sp = *reinterpret_cast<const ChainSpecWide*>(spf);
  const int P = sp.P, F = 3 * P;
  // bit m of anc[k]: moving joint m moves point k
  auto* anc = reinterpret_cast<unsigned long long*>(spf + kWideSpecFloats);
  for (int k = tid; k < P; k += kWideThreads<K>) {
    unsigned long long a = 0;
    for (int m = sp.pframe[k]; m >= 0; m = sp.mparent[m]) a |= 1ull << m;
    anc[k] = a;
  }
  const int b0 = blockIdx.x * kWideRows;
  const int live = min(kWideRows, B - b0);   // rows of the block below B
  float* x = reinterpret_cast<float*>(sm + L::kX);
  if (tid < kWideRows) {  // FK of row tid (past B as row B - 1)
    float fr[kWideMaxM][12], zo_past[kWideMaxM][6];
    float(*zo)[6] = tid < live
        ? reinterpret_cast<float(*)[6]>(zo_g + static_cast<size_t>(b0 + tid) *
                                                   sp.M * 6)
        : zo_past;
    float* xr = x + tid * L::kSx;
    chain_fk<kWideMaxCP>(
        q + static_cast<size_t>(b0 + min(tid, live - 1)) * sp.D, true, sp,
        fr, zo, xr);
    for (int f = F; f < L::kSx; ++f) xr[f] = 0.f;
  }
  __syncthreads();
  wide_rows_setup<K>(prep, sm, F);
  for (int c = 0; c < C; ++c) {
    wide_tc_pairs<K>(prep, S, F, c, sm);
    chain_wide_epilogue<K>(sm, zo_g, score, dq, B, c, C);
  }
}

}  // namespace diffco
