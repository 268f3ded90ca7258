// Kernel B1's function (DH FK + polyharmonic score + configuration
// gradient) with two configurations per thread, written by hand for
// Hopper: the A/B of the roofline path.
//
// Replaces: scripts/ab_dual_tile.py::dual_score_grad (body
// make_dual_kernel), the TPU kernel that splits each batch tile into two
// halves and runs them one after the other ("dual_seq") or with their
// stages interleaved ("dual_pipe") so that the matrix unit and the vector
// unit overlap. On Hopper the two halves of a tile are two rows of one
// thread:
//
//   PIPE = true  ("dual_pipe"): one pass over each staged support chunk
//                updates both rows' sums. Each shared-memory read of s_j
//                feeds two rows, and the two rows are two independent FMA
//                chains for the scheduler.
//   PIPE = false ("dual_seq", the control): the thread runs row A's whole
//                support loop, then row B's. One row is live at a time.
//
// THREADS = 64 or 128 threads per block, that is 128 or 256 rows (the
// reference's tiles of 1024 and 2048 lanes). Row A of thread t is
// blockIdx.x * 2 * THREADS + t, row B is THREADS further, so that both
// rows' loads and stores stay coalesced.
//
// What bounds it on this card: as B1, the fp32 CUDA cores (~3.2 GFLOP at
// B = 65536, S = 512 against ~4 MB of bytes). The cost of the design is
// registers: two live rows of x[24] and su[24] on top of B1's 126, which
// may push dual_pipe to spills; ptxas reports each variant. Built for
// FP = 24 only (DH robots with 6 to 8 control points, PandaFK padded).
#include <cuda_runtime.h>

#include "dh_chain.cuh"

namespace diffco {
namespace {

constexpr int kDualFP = 24;

// score_grad_accumulate (score_block.cuh) for two rows over one chunk:
// each s_jf read from shared memory serves both rows.
template <int FP>
__device__ __forceinline__ void score_grad_accumulate_dual(
    const float* xa, const float* xb, const float* s_chunk,
    const float* w_chunk, int n, float* score, float* comp, float* rowsum,
    float* sua, float* sub) {
  for (int j = 0; j < n; ++j) {
    const float* sj = s_chunk + j * FP;
    float d2a = 0.f, d2b = 0.f;
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      const float sf = sj[f];
      const float da = xa[f] - sf;
      const float db = xb[f] - sf;
      d2a = fmaf(da, da, d2a);
      d2b = fmaf(db, db, d2b);
    }
    d2a = fmaxf(d2a, 0.f) + 1e-12f;
    d2b = fmaxf(d2b, 0.f) + 1e-12f;
    const float ia = rsqrtf(d2a), ib = rsqrtf(d2b);
    const float wj = w_chunk[j];
    two_sum_add(wj * (d2a * ia), score[0], comp[0]);
    two_sum_add(wj * (d2b * ib), score[1], comp[1]);
    const float ua = wj * ia, ub = wj * ib;
    rowsum[0] += ua;
    rowsum[1] += ub;
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      const float sf = sj[f];
      sua[f] = fmaf(sf, ua, sua[f]);
      sub[f] = fmaf(sf, ub, sub[f]);
    }
  }
}

__device__ __forceinline__ void load_q(const float* __restrict__ q, int b,
                                       bool live, int J, float* qr) {
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = (live && j < J) ? q[static_cast<size_t>(b) * J + j] : 0.f;
}

// FK again, the suffix-sum backward, and the row's stores (B1's epilogue).
template <int KP, int FP>
__device__ __forceinline__ void finish_row(const DHSpec& sp, const float* qr,
                                           float* x, float sc, float scc,
                                           float rs, const float* su, int b,
                                           bool live, float* score,
                                           float* dq) {
  float az[3 * kMaxJ], ao[3 * kMaxJ], dqr[kMaxJ];
  dh_chain<KP>(qr, sp, x, az, ao);
  dh_backward<KP>(sp, x, az, ao, rs, su, dqr);
  if (live) {
    score[b] = sc + scc;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < sp.J) dq[static_cast<size_t>(b) * sp.J + j] = dqr[j];
  }
}

template <int THREADS, bool PIPE>
__global__ void __launch_bounds__(THREADS)
dh_dual_score_grad_kernel(const float* __restrict__ q,
                          const float* __restrict__ s,
                          const float* __restrict__ w,
                          float* __restrict__ score, float* __restrict__ dq,
                          int B, int S, const __grid_constant__ DHSpec sp) {
  constexpr int FP = kDualFP;
  constexpr int KP = FP / 3;
  __shared__ __align__(16) float s_sh[kChunk * FP];
  __shared__ float w_sh[kChunk];
  const int ba = blockIdx.x * 2 * THREADS + threadIdx.x;
  const int F = 3 * sp.P;
  if constexpr (PIPE) {
    const int bb = ba + THREADS;
    const bool la = ba < B, lb = bb < B;
    float qa[kMaxJ], qb[kMaxJ];
    load_q(q, ba, la, sp.J, qa);
    load_q(q, bb, lb, sp.J, qb);
    float xa[FP], xb[FP], sua[FP], sub[FP];
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      xa[f] = xb[f] = 0.f;
      sua[f] = sub[f] = 0.f;
    }
    {
      float az[3 * kMaxJ], ao[3 * kMaxJ];  // dead here: recomputed below
      dh_chain<KP>(qa, sp, xa, az, ao);
      dh_chain<KP>(qb, sp, xb, az, ao);
    }
    float sc[2] = {0.f, 0.f}, scc[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
    for (int c0 = 0; c0 < S; c0 += kChunk) {
      const int n = min(kChunk, S - c0);
      __syncthreads();
      stage_supports<FP>(s, w, c0, n, F, s_sh, w_sh);
      __syncthreads();
      score_grad_accumulate_dual<FP>(xa, xb, s_sh, w_sh, n, sc, scc, rs, sua,
                                     sub);
    }
    finish_row<KP, FP>(sp, qa, xa, sc[0], scc[0], rs[0], sua, ba, la, score,
                       dq);
    finish_row<KP, FP>(sp, qb, xb, sc[1], scc[1], rs[1], sub, bb, lb, score,
                       dq);
  } else {
    for (int h = 0; h < 2; ++h) {
      const int b = ba + h * THREADS;
      const bool live = b < B;
      float qr[kMaxJ];
      load_q(q, b, live, sp.J, qr);
      float x[FP], su[FP];
#pragma unroll
      for (int f = 0; f < FP; ++f) x[f] = su[f] = 0.f;
      {
        float az[3 * kMaxJ], ao[3 * kMaxJ];
        dh_chain<KP>(qr, sp, x, az, ao);
      }
      float sc = 0.f, scc = 0.f, rs = 0.f;
      for (int c0 = 0; c0 < S; c0 += kChunk) {
        const int n = min(kChunk, S - c0);
        __syncthreads();
        stage_supports<FP>(s, w, c0, n, F, s_sh, w_sh);
        __syncthreads();
        score_grad_accumulate<FP>(x, s_sh, w_sh, n, sc, scc, rs, su);
      }
      finish_row<KP, FP>(sp, qr, x, sc, scc, rs, su, b, live, score, dq);
    }
  }
}

}  // namespace
}  // namespace diffco

#define DIFFCO_DUAL_CASE(T, P)                                          \
  if (threads == T && (pipelined != 0) == P) {                          \
    diffco::dh_dual_score_grad_kernel<T, P>                             \
        <<<(B + 2 * T - 1) / (2 * T), T, 0, st>>>(q, s, w, score, dq, B, \
                                                   S, sp);               \
    return static_cast<int>(cudaGetLastError());                        \
  }

// score [B], dq [B, J] as dh_score_grad, two rows per thread; `threads`
// 64 or 128, `pipelined` 1 (dual_pipe) or 0 (dual_seq). Returns the
// cudaError_t of the launch (0 on success); launches on `stream` and does
// not synchronise.
extern "C" int dh_dual_score_grad(const float* q, const float* s,
                                  const float* w, float* score, float* dq,
                                  int B, int S, int threads, int pipelined,
                                  const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (B <= 0 || S < 0 || sp.J < 1 || sp.J > diffco::kMaxJ ||
      (3 * sp.P + 7) / 8 * 8 != diffco::kDualFP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DIFFCO_DUAL_CASE(64, false)
  DIFFCO_DUAL_CASE(64, true)
  DIFFCO_DUAL_CASE(128, false)
  DIFFCO_DUAL_CASE(128, true)
  return cudaErrorInvalidValue;
}
