// Kernel B1's function (DH FK + polyharmonic score + configuration
// gradient) with each block's tile of 256 configurations in two halves,
// written by hand for Hopper on B1's tensor-core block: the A/B of the
// roofline path.
//
// Replaces: scripts/ab_dual_tile.py::dual_score_grad (body
// make_dual_kernel), the TPU kernel that splits each batch tile into two
// halves and runs them one after the other ("dual_seq") or with their
// stages interleaved ("dual_pipe") so that the matrix unit and the vector
// unit overlap.
//
// Each half is kTcRows = 128 configurations and computes what a block of
// B1 computes (dh_score.cu on tc_score_block.cuh and dh_tc_rows.cuh): its
// own centre, both products in 3xTF32, the near-pair guard, TwoSum
// scores, per-chunk product-2 sums. In B1 the FK and the backward run on
// threads 0-127 alone, while the block's other four warps and its tensor
// cores wait; the two variants ask whether interleaving two halves hides
// that stretch:
//
//   dual_seq (the control): B1's block of 256 threads
//       runs half A's FK, support loop and backward, then half B's: twice
//       the rows per block and half the blocks, nothing interleaved. Two
//       blocks (16 warps) per SM, as B1.
//   dual_pipe (warp specialisation): 384 threads; warps 0-7 run the
//       support loops (tc_score_block, meeting on named barrier 1),
//       warps 8-11, one warpgroup, the FK and the backward, one thread a
//       row. The block's halves take turns in two slots of shared memory,
//       each its own TcSmem<24> and joint axes (2 x 60000 B), so that a
//       half's sums, which the block leaves over its chunk buffers,
//       outlive the next half's loop:
//
//         FK warps:   FK 0 | FK 1   | bwd 0, FK 2 | bwd 1, FK 3 | ...
//         loop warps:      | loop 0 | loop 1      | loop 2      | ...
//
//       The groups hand over on named barriers, the producer arriving
//       (bar.arrive) and the consumer waiting (bar.sync): 2 and 3 (slot
//       0's, 1's rows written), 4 and 5 (slot 0's, 1's sums written).
//       dual_pipe_256 gives a block one tile's two halves;
//       dual_pipe_persist, one block per SM, walks every gridDim-th half,
//       so that the FK and backward of all but its first and last halves
//       hide behind loops (the reference's longer dual_pipe_2048 tile).
//
// What bounds it on this card: as B1, the products on the tensor cores
// (dh_tc_bound, ops/bounds.py), with the pair work on the fp32 CUDA cores
// beside them. Registers: dual_pipe's 384 threads run at up to 168
// (__launch_bounds__(384, 1)), one block per SM: two blocks of 384
// threads would need <= 85 registers a thread, which no reassignment
// between the warpgroups (setmaxnreg) gives loop warps that need ~128.
// So dual_pipe has 8 loop warps per SM where B1 and dual_seq have 16, and
// its loop keeps the per-chunk product-2 sums in registers (kTcSumsRegs).
// Built for FP = 24 only (DH robots with 6 to 8 control points, PandaFK
// padded): a measurement kernel of the roofline path's one shape.
#include <cuda_runtime.h>

#include "dh_tc_rows.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {
namespace {

constexpr int kDualFP = 24;
constexpr int kDualRows = 2 * kTcRows;  // configurations per block
constexpr int kPipeThreads = kTcThreads + kTcRows;  // + the FK warpgroup
constexpr int kPipeSums = kTcSumsRegs;
using SeqSmem = DhSmem<kDualFP>;
using HalfSmem = DhSmem<kDualFP, kPipeSums>;  // one half of dual_pipe's

// A half's FK into the block at smem (one thread a row), and its backward
// and stores
__device__ __forceinline__ void half_fk(const float* __restrict__ q,
                                        float* smem, int axes_at, int b0,
                                        int row, int B, const DHSpec& sp) {
  using L = TcSmem<kDualFP>;
  const int b = b0 + row;
  dh_row_fk<kDualFP>(q, b, b < B, sp, smem + L::kX + row * L::kXS,
                     smem + axes_at + row * SeqSmem::kAxesStride);
}

__device__ __forceinline__ void half_backward(float* smem, int axes_at,
                                              int b0, int row, int B,
                                              const DHSpec& sp,
                                              float* __restrict__ score,
                                              float* __restrict__ dq) {
  using L = TcSmem<kDualFP>;
  float dqr[kMaxJ];
  dh_row_backward<kDualFP>(smem, row, sp, smem + L::kX + row * L::kXS,
                           smem + axes_at + row * SeqSmem::kAxesStride,
                           dqr);
  dh_row_store<kDualFP>(smem, row, b0 + row, b0 + row < B, sp, dqr, score,
                        dq);
}

// csrc variant numbers (ab_dual_tile.VARIANTS)
constexpr int kDualSeq = 0;
constexpr int kDualPipe = 1;
constexpr int kDualPersist = 2;

// The first configuration of dual_pipe's half i, and the block's halves
template <int V>
__device__ __forceinline__ int half_row0(int i) {
  return (V == kDualPersist ? static_cast<int>(blockIdx.x + i * gridDim.x)
                            : static_cast<int>(2 * blockIdx.x) + i) *
         kTcRows;
}

template <int V>
__device__ __forceinline__ int block_halves(int B) {
  if (V != kDualPersist) return 2;
  const int H = (B + kTcRows - 1) / kTcRows;
  return (H - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
}

template <int V>
__global__ void __launch_bounds__(V == kDualSeq ? kTcThreads : kPipeThreads,
                                  V == kDualSeq ? kTcBlocksPerSM : 1)
dh_dual_score_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ s,
                        const float* __restrict__ w,
                        float* __restrict__ score, float* __restrict__ dq,
                        int B, int S, const __grid_constant__ DHSpec sp) {
  constexpr int FP = kDualFP;
  const int tid = threadIdx.x;
  const int F = 3 * sp.P;
  if constexpr (V == kDualSeq) {
    float* smem = diffco_tc_smem;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int bh = blockIdx.x * kDualRows + h * kTcRows;
      if (h) __syncthreads();  // the last half's backward is done
      if (S > 0) tc_stage<FP>(s, w, 0, S, F, smem, 0);
      if (tid < kTcRows) half_fk(q, smem, SeqSmem::kAxes, bh, tid, B, sp);
      tc_score_block<FP, false, kDhSums<FP>>(s, w, S, F, smem, kTcGuard,
                                             nullptr, smem + SeqSmem::kRun);
      if (tid < kTcRows)
        half_backward(smem, SeqSmem::kAxes, bh, tid, B, sp, score, dq);
    }
  } else {
    const int m = block_halves<V>(B);
    float* const slot[2] = {diffco_tc_smem,
                            diffco_tc_smem + HalfSmem::kFloats};
    if (tid < kTcThreads) {  // the support loops' warps
      for (int i = 0; i < m; ++i) {
        float* hs = slot[i & 1];
        if (i & 1)  // its rows written (and its last half's sums read)
          named_sync<3, kPipeThreads>();
        else
          named_sync<2, kPipeThreads>();
        if (S > 0) tc_stage<FP>(s, w, 0, S, F, hs, 0);
        tc_score_block<FP, false, kPipeSums, kTcStageFull, kTcP2Tf32x3,
                       TcSyncGroup>(s, w, S, F, hs, kTcGuard, nullptr);
        if (i & 1)  // its sums written
          named_arrive<5, kPipeThreads>();
        else
          named_arrive<4, kPipeThreads>();
      }
    } else {  // the FK warpgroup: row `row` of each half
      const int row = tid - kTcThreads;
      for (int i = 0; i < m && i < 2; ++i) {
        half_fk(q, slot[i], HalfSmem::kAxes, half_row0<V>(i), row, B, sp);
        if (i)
          named_arrive<3, kPipeThreads>();
        else
          named_arrive<2, kPipeThreads>();
      }
      for (int i = 0; i < m; ++i) {
        float* hs = slot[i & 1];
        if (i & 1)
          named_sync<5, kPipeThreads>();
        else
          named_sync<4, kPipeThreads>();
        half_backward(hs, HalfSmem::kAxes, half_row0<V>(i), row, B, sp,
                      score, dq);
        if (i + 2 < m) {  // half i + 2 into the slot
          half_fk(q, hs, HalfSmem::kAxes, half_row0<V>(i + 2), row, B, sp);
          if (i & 1)
            named_arrive<3, kPipeThreads>();
          else
            named_arrive<2, kPipeThreads>();
        }
      }
    }
  }
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

namespace diffco {
namespace {

// Launches variant V over B configurations on `st`; the cudaError_t.
// dual_pipe_persist takes one block per SM (at most one per half).
template <int V>
int dual_launch(const float* q, const float* s, const float* w, float* score,
                float* dq, int B, int S, const DHSpec& sp, cudaStream_t st) {
  const auto kernel = dh_dual_score_tc_kernel<V>;
  const int bytes = V == kDualSeq ? SeqSmem::kBytes : 2 * HalfSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int grid = (B + kDualRows - 1) / kDualRows;
  if (V == kDualPersist && e == cudaSuccess) {
    int device = 0, sms = 0;
    e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    const int halves = (B + kTcRows - 1) / kTcRows;
    grid = halves < sms ? halves : sms;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, V == kDualSeq ? kTcThreads : kPipeThreads, bytes, st>>>(
      q, s, w, score, dq, B, S, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace diffco

// score [B], dq [B, J] as dh_score_grad; `variant` 0 (dual_seq_256), 1
// (dual_pipe_256) or 2 (dual_pipe_persist). Returns the cudaError_t of
// the launch (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int dh_dual_score_grad(const float* q, const float* s,
                                  const float* w, float* score, float* dq,
                                  int B, int S, int variant,
                                  const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || sp.J < 1 || sp.J > diffco::kMaxJ ||
      (3 * sp.P + 7) / 8 * 8 != diffco::kDualFP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case diffco::kDualSeq:
      return diffco::dual_launch<diffco::kDualSeq>(q, s, w, score, dq, B, S,
                                                   sp, st);
    case diffco::kDualPipe:
      return diffco::dual_launch<diffco::kDualPipe>(q, s, w, score, dq, B,
                                                    S, sp, st);
    case diffco::kDualPersist:
      return diffco::dual_launch<diffco::kDualPersist>(q, s, w, score, dq, B,
                                                       S, sp, st);
    default:
      return cudaErrorInvalidValue;
  }
}
