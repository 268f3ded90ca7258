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
// - the block's kWideRows = 32 rows, one thread a row (threads 0-31, as
//   the tensor-core kernels run one thread a configuration): chain_fk
//   writes the row's points into the wide block's row buffer and each
//   moving joint's world axis and origin (zo) to the caller's scratch in
//   device memory, zo [B, M, 6] (what the backward reads after the
//   supports; in shared memory it would take 27 KB a block at the rope's
//   35 joints and leave one block per SM); the moving frames, indexed by
//   data and used by the FK only, stay in the thread's local memory;
// - the wide score block (wide_score_block.cuh: x~ in fp64, both products
//   on the fp64 tensor cores) runs the pairs once per class c, on weight
//   column c (product 1 and the pair work are redone per class);
// - then the backward, each warp a row at a time: its lanes write the
//   row's points (x~ + c) and gradient (x~ rowsum - su~) in fp32 over the
//   block's chunk buffers, then one moving joint a lane (lanes m and m +
//   32) sums over the points it moves (the masks) (z_m x (x_k - o_m)) .
//   g_k, or z_m . g_k for a prismatic joint, times its mimic multiplier;
//   one dof a lane then adds its joints' values in joint order and writes
//   dq [C, B, D], and lane 0 the score [B, C]. No atomics.
// The block takes 97-139 KB of shared memory at K = 3-6 whatever the
// chain (two blocks, 16 warps, per SM up to K = 4: the 35-link rope).
#pragma once

#include "chain_fk.cuh"
#include "wide_score_block.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {

// The ChainSpecWide's floats in shared memory, a multiple of 4.
constexpr int kWideSpecFloats = (sizeof(ChainSpecWide) / 4 + 3) / 4 * 4;
// the points' ancestor masks, 64 bits each
constexpr int kWideAncFloats = 2 * kWideMaxCP;

// the kernel's dynamic shared memory: the wide block's, the spec, the
// masks (the backward's joints' values and rows go over the block's
// chunk buffers, after the sums)
template <int K>
__host__ __device__ constexpr int chain_wide_smem_bytes() {
  return WideSmem<K>::kBytes + 4 * (kWideSpecFloats + kWideAncFloats);
}

// The backward's floats after the sums: the joints' values [rows][M + 1],
// then per warp one row's points and gradient [2][32 K].
template <int K>
struct ChainWideTail {
  static constexpr int kJv = 2 * (WideSmem<K>::kSums +
                                  kWideRows * WideSmem<K>::kS);
  static constexpr int kXg = kJv + kWideRows * (kWideMaxM + 1);
  static constexpr int kEnd = kXg + kWideThreads / 32 * 2 * 32 * K;
  static_assert(kEnd <= 2 * WideSmem<K>::kEnd, "the backward's floats");
};

// blocks per SM in the launch bound: two (<= 128 registers) up to K = 4,
// where two blocks' shared memory fits an SM; one above
template <int K>
constexpr int kChainWideMinBlocks = K <= 4 ? kWideMinBlocks : 1;

// The spec, its ancestor masks and the backward's floats, after the wide
// block's shared memory.
template <int K>
__device__ __forceinline__ float* chain_wide_spec(double* sm) {
  return reinterpret_cast<float*>(sm + WideSmem<K>::kEnd);
}

// After wide_tc_pairs for class c of C: the block's live rows' backward
// (a warp a row, a joint a lane, from zo_g [B, M, 6]), then dq [C, B, D],
// a dof a lane, and the score [B, C]. Out of line: the pair loop's
// registers stay its own (inlined, the kernel spilled 8-44 B at 128).
template <int K>
__device__ __noinline__ void chain_wide_epilogue(
    double* sm, const float* __restrict__ zo_g, float* __restrict__ score,
    float* __restrict__ dq, int B, int c, int C) {
  using L = WideSmem<K>;
  using T = ChainWideTail<K>;
  constexpr int kWarps = kWideThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* spf = chain_wide_spec<K>(sm);
  const ChainSpecWide& sp = *reinterpret_cast<const ChainSpecWide*>(spf);
  const auto* anc =
      reinterpret_cast<const unsigned long long*>(spf + kWideSpecFloats);
  const int M = sp.M, D = sp.D, P = sp.P, F = 3 * P;
  const int b0 = blockIdx.x * kWideRows;
  const int live = min(kWideRows, B - b0);
  float* smf = reinterpret_cast<float*>(sm);
  float* jv = smf + T::kJv;
  float* xr = smf + T::kXg + warp * 2 * 32 * K;
  float* gr = xr + 32 * K;
  for (int r = warp; r < live; r += kWarps) {  // a joint a lane
    for (int f = lane; f < F; f += 32) {  // the row's points, gradient
      xr[f] = static_cast<float>(sm[L::kXt + r * L::kS + f] + sm[L::kC + f]);
      gr[f] = static_cast<float>(wide_row_grad<K>(sm, r, f, F));
    }
    wide_syncwarp();
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
      jv[r * (M + 1) + m] = sp.mult[m] * val;
    }
    wide_syncwarp();  // the next row's points go over these
  }
  __syncthreads();
  for (int r = warp; r < live; r += kWarps) {  // dq, a dof a lane
    const int b = b0 + r;
    for (int d = lane; d < D; d += 32) {
      float v = 0.f;
      for (int m = 0; m < M; ++m)
        if (sp.dof[m] == d) v += jv[r * (M + 1) + m];
      dq[(static_cast<size_t>(c) * B + b) * D + d] = v;
    }
    if (lane == 0)
      score[static_cast<size_t>(b) * C + c] =
          static_cast<float>(wide_row_score<K>(sm, r));
  }
  __syncthreads();  // the sums' readers are done: the next class stages
}

template <int K>
__global__ void __launch_bounds__(kWideThreads, kChainWideMinBlocks<K>)
chain_wide_score_kernel(const float* __restrict__ q,
                        const float* __restrict__ s,
                        const float* __restrict__ W,
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
         i += kWideThreads)
      dst[i] = src[i];
  }
  __syncthreads();
  const ChainSpecWide& sp = *reinterpret_cast<const ChainSpecWide*>(spf);
  const int P = sp.P;
  // bit m of anc[k]: moving joint m moves point k
  auto* anc = reinterpret_cast<unsigned long long*>(spf + kWideSpecFloats);
  for (int k = tid; k < P; k += kWideThreads) {
    unsigned long long a = 0;
    for (int m = sp.pframe[k]; m >= 0; m = sp.mparent[m]) a |= 1ull << m;
    anc[k] = a;
  }
  const int b0 = blockIdx.x * kWideRows;
  const int live = min(kWideRows, B - b0);   // rows of the block below B
  if (tid < kWideRows) {  // FK of row tid (past B as row B - 1)
    float fr[kWideMaxM][12], zo_past[kWideMaxM][6];
    float(*zo)[6] = tid < live
        ? reinterpret_cast<float(*)[6]>(zo_g + static_cast<size_t>(b0 + tid) *
                                                   sp.M * 6)
        : zo_past;
    chain_fk<kWideMaxCP>(
        q + static_cast<size_t>(b0 + min(tid, live - 1)) * sp.D, true, sp,
        fr, zo, reinterpret_cast<float*>(sm + L::kRows) + tid * L::kS);
  }
  __syncthreads();
  wide_rows_setup<K>(sm, 3 * P);
  for (int c = 0; c < C; ++c) {
    wide_tc_pairs<K>(s, W + c, C, S, 3 * P, sm);
    chain_wide_epilogue<K>(sm, zo_g, score, dq, B, c, C);
  }
}

}  // namespace diffco
