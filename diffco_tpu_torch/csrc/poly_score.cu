// Point-space polyharmonic score + gradient, written by hand for Hopper.
//
// Replaces: diffco_tpu/ops/fused_score.py::_poly_score_grad_pallas (body
// _make_fwdgrad_kernel), the TPU kernel behind polyharmonic_score at
// batch >= 16384.
//
// Computes, for x [B, F], s [S, F], w [S] (fp32, row-major, F <= 192):
//   score[b] = sum_j w_j ||x_b - s_j||,  dx[b] = x_b * sum_j w_j / r_bj
//                                               - sum_j s_j w_j / r_bj.
//
// What bounds it on this card: arithmetic. At the main path's shape
// (B = 65536, S = 512, F = 21) the function needs about B*S*(4F + 11)
// operations, rsqrt included (~3.2 GFLOP, counted in the TPU kernel's
// expanded form ||x||^2 + ||s||^2 - 2 x.s), and moves ~11 MB in and out.
// ~4F of the per-pair operations are the two matrix products that the
// TPU kernel runs on its MXU (the cross term x . s and the [s w | w]
// sums); on this card they run on the tensor cores, and the ~15 others
// per pair on the CUDA cores (ops/bounds.py::tc_times).
//
// Design (poly_score_tc_kernel): the score block of tc_score_block.cuh,
// B1's without the FK and the backward. 128 rows and 256 threads per
// block, two blocks (16 warps) per SM; both products on the tensor cores
// in 3xTF32. The block's threads copy its rows of x into the block's
// shared rows (components F..FP-1 zero, FP = F padded to a multiple of 8,
// 16 to 64); rows past B are copies of row B - 1, so that the block's
// centre (the mean of its rows) stays on the data. After the supports,
// dx = x~ rowsum - su~ in the block's centred frame (su~ = su - c rowsum),
// which needs no centre added back. Product 2 accumulates chunk by chunk
// (tc_score_block.cuh's kTcPointSums), which the fitted FrankaPanda
// sweep's gradient needs, and at FP = 56 and 64 the marked rope's fitted
// proxies at S = 4096 and 8192; there, where running sums in registers
// spill, they sit in shared memory after the block's (PolySmem). This
// runs at F = 9-64 (FP = 16-64).
//
// At F <= 8 (poly_score_f64_kernel) the pairs run in fp64 on the CUDA
// cores instead, one thread per row. The q-space proxies of the planar
// arms (F = 2) cancel harder than the tensor-core block's float32 terms
// allow: on the fitted 2-DOF escape proxy (S = 218, sum_j |w_j| r_j ~
// 1.4e4 against |score| <= 3.7) the block's score was 4.5e-4 from the
// float64 twin on the H100. Its terms w_j r_j reach several hundred,
// where half a float32 ulp is ~3e-5, and a few hundred of them summed
// with random signs lose ~1e-4 to that rounding alone: the terms
// themselves need more than 24 bits.
// Per pair: d = x - s exactly (two floats' difference in fp64), d2 =
// |d|^2 + 1e-12, rinv from the fp32 rsqrt and one Newton step in fp64
// (relative error ~1e-14), then score += w d2 rinv and dx += w rinv d,
// all in fp64, rounded to float32 once at the end. At F <= 8 a pair is
// ~4F + 12 fp64 operations, against the H100's 1:2 fp64 rate.
//
// At F = 65-192 (poly_score_wide_kernel<K>, K = ceil(F / 32), its own
// entry poly_score_grad_wide after the prologue wide_prep) the pairs run
// on the wide score block of wide_score_block.cuh, both products on the
// fp64 tensor cores (mma.sync .f64) and the pair work in fp64:
// control-point rows of 22-64 points (three Panda arms, the 35-link rope,
// a rigid body of many keypoints), which the JAX kernel takes at any F and
// the 3xTF32 block's shared memory and registers do not. 64 rows a block,
// centred in fp64 on the prologue's centre; its rows are copies of row
// B - 1 past B.
// At the rope's sweep (F = 102, S = 1536) the two products are ~4.2e10
// fp64 operations: bound by the fp64 tensor cores' 67 TFLOP/s
// (ops/bounds.py::wide_f64_tc_bound), not by the ~27 MB it moves.
#include <cuda_runtime.h>

#include "tc_score_block.cuh"
#include "wide_score_block.cuh"

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {
namespace {

// The kernel's dynamic shared memory: the block's (TcSmem<FP>), then
// product 2's running sums where kTcPointSums keeps them in shared memory.
template <int FP>
constexpr int kPolySums = kTcPointSums<FP, kTcChunkMaxFP>;

template <int FP>
struct PolySmem {
  static constexpr int kRun = TcSmem<FP>::kFloats;
  static constexpr int kBytes = 4 * (kRun + kTcRunFloats<FP, kPolySums<FP>>);
};

// B2 on the tensor-core score block (file comment). kMeasure: a
// measurement build that counts the near-pair guard's recomputations
// into *guard_pairs, with kappa as its threshold.
template <int FP, bool kMeasure>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
poly_score_tc_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ w, float* __restrict__ score,
                     float* __restrict__ dx, int B, int S, int F, float kappa,
                     unsigned long long* guard_pairs) {
  using L = TcSmem<FP>;
  float* smem = diffco_tc_smem;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kTcRows;
  const int live = min(kTcRows, B - b0);   // rows of the block below B
  if (S > 0) tc_stage<FP>(s, w, 0, S, F, smem, 0);
  // the block's rows, consecutive threads on consecutive components; a
  // row past B reads row B - 1
  for (int i = tid; i < kTcRows * FP; i += kTcThreads) {
    const int r = i / FP, f = i % FP;
    const size_t b = b0 + min(r, live - 1);
    smem[L::kX + r * L::kXS + f] = f < F ? x[b * F + f] : 0.f;
  }
  tc_score_block<FP, kMeasure, kPolySums<FP>>(
      s, w, S, F, smem, kappa, guard_pairs, smem + PolySmem<FP>::kRun);
  // dx = x~ rowsum - su~ (rowsum at column F of the row's sums)
  for (int i = tid; i < live * FP; i += kTcThreads) {
    const int r = i / FP, f = i % FP;
    const float* su = smem + L::kSu + r * L::kSuS;
    if (f < F)
      dx[static_cast<size_t>(b0 + r) * F + f] =
          fmaf(smem[L::kX + r * L::kXS + f], su[F], -su[f]);
  }
  if (tid < live) score[b0 + tid] = smem[L::kScore + tid];
}

// B2 at F <= kF64MaxF (file comment): kF64Rows threads, one row each;
// the supports and weights stream through shared memory in chunks of
// kF64Chunk rows of (s_j, w_j), F + 1 floats each (kF64Smem bytes,
// whatever F).
constexpr int kF64MaxF = 8;
constexpr int kF64Rows = 256;
constexpr int kF64Chunk = 256;
constexpr int kF64MinBlocks = 3;   // __launch_bounds__: <= 85 registers
constexpr int kF64Smem = 4 * kF64Chunk * (kF64MaxF + 1);

template <int F>
__global__ void __launch_bounds__(kF64Rows, kF64MinBlocks)
poly_score_f64_kernel(const float* __restrict__ x,
                      const float* __restrict__ s,
                      const float* __restrict__ w, float* __restrict__ score,
                      float* __restrict__ dx, int B, int S) {
  float* chunk = diffco_tc_smem;      // [kF64Chunk][F + 1]: s_j, w_j
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kF64Rows + tid;
  const bool live = b < B;
  double xb[F], g[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    xb[f] = live ? static_cast<double>(x[static_cast<size_t>(b) * F + f])
                 : 0.0;
    g[f] = 0.0;
  }
  double sc = 0.0;
  for (int c0 = 0; c0 < S; c0 += kF64Chunk) {
    const int n = min(kF64Chunk, S - c0);
    __syncthreads();  // the last chunk's reads are done
    for (int i = tid; i < n * (F + 1); i += kF64Rows) {
      const int j = i / (F + 1), f = i % (F + 1);
      chunk[i] = f < F ? s[static_cast<size_t>(c0 + j) * F + f] : w[c0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* sj = chunk + j * (F + 1);
      double d[F], d2 = 1e-12;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        d[f] = xb[f] - static_cast<double>(sj[f]);
        d2 = fma(d[f], d[f], d2);
      }
      const double rinv = f64_rsqrt(d2);
      const double wj = static_cast<double>(sj[F]);
      sc = fma(wj, d2 * rinv, sc);
      const double wr = wj * rinv;
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = fma(wr, d[f], g[f]);
    }
  }
  if (live) {
    score[b] = static_cast<float>(sc);
#pragma unroll
    for (int f = 0; f < F; ++f)
      dx[static_cast<size_t>(b) * F + f] = static_cast<float>(g[f]);
  }
}

// B2 at F = 65-kWideMaxF (file comment): kWideRows rows a block on the
// wide score block, after its prologue (wide_prep) has written the
// supports into `prep`.
template <int K>
__global__ void __launch_bounds__(kWideThreads<K>, kWideMinBlocks<K>)
poly_score_wide_kernel(const float* __restrict__ x,
                       const double* __restrict__ prep,
                       float* __restrict__ score, float* __restrict__ dx,
                       int B, int S, int F) {
  using L = WideSmem<K>;
  double* sm = reinterpret_cast<double*>(diffco_tc_smem);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kWideRows;
  const int live = min(kWideRows, B - b0);   // rows of the block below B
  // the block's rows, consecutive threads on consecutive components; a
  // row past B reads row B - 1; zeros past F
  float* xr = reinterpret_cast<float*>(sm + L::kX);
  for (int i = tid; i < kWideRows * L::kSx; i += kWideThreads<K>) {
    const int r = i / L::kSx, f = i % L::kSx;
    xr[i] = f < F ? x[static_cast<size_t>(b0 + min(r, live - 1)) * F + f]
                  : 0.f;
  }
  __syncthreads();
  wide_rows_setup<K>(prep, sm, F);
  wide_tc_pairs<K>(prep, S, F, 0, sm);
  for (int i = tid; i < live * F; i += kWideThreads<K>) {
    const int r = i / F, f = i % F;
    dx[static_cast<size_t>(b0 + r) * F + f] =
        static_cast<float>(wide_row_grad<K>(sm, r, f, F));
  }
  if (tid < live)
    score[b0 + tid] = static_cast<float>(wide_row_score<K>(sm, tid));
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

#include "wide_launch.cuh"

namespace diffco {
namespace {

// Launches B2's kernel over B rows on `st`; the cudaError_t, 0 on
// success.
template <int FP, bool kMeasure>
int poly_launch(const float* x, const float* s, const float* w, float* score,
                float* dx, int B, int S, int F, float kappa,
                unsigned long long* guard_pairs, cudaStream_t st) {
  const auto kernel = poly_score_tc_kernel<FP, kMeasure>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PolySmem<FP>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kTcRows - 1) / kTcRows, kTcThreads, PolySmem<FP>::kBytes,
           st>>>(x, s, w, score, dx, B, S, F, kappa, guard_pairs);
  return static_cast<int>(cudaGetLastError());
}

// B2's fp64 instance (F <= kF64MaxF) over B rows on `st`.
template <int F>
int poly_f64_launch(const float* x, const float* s, const float* w,
                    float* score, float* dx, int B, int S, cudaStream_t st) {
  poly_score_f64_kernel<F><<<(B + kF64Rows - 1) / kF64Rows, kF64Rows,
                             kF64Smem, st>>>(x, s, w, score, dx, B, S);
  return static_cast<int>(cudaGetLastError());
}

int poly_f64_dispatch(const float* x, const float* s, const float* w,
                      float* score, float* dx, int B, int S, int F,
                      cudaStream_t st) {
  switch (F) {
    case 1: return poly_f64_launch<1>(x, s, w, score, dx, B, S, st);
    case 2: return poly_f64_launch<2>(x, s, w, score, dx, B, S, st);
    case 3: return poly_f64_launch<3>(x, s, w, score, dx, B, S, st);
    case 4: return poly_f64_launch<4>(x, s, w, score, dx, B, S, st);
    case 5: return poly_f64_launch<5>(x, s, w, score, dx, B, S, st);
    case 6: return poly_f64_launch<6>(x, s, w, score, dx, B, S, st);
    case 7: return poly_f64_launch<7>(x, s, w, score, dx, B, S, st);
    case 8: return poly_f64_launch<8>(x, s, w, score, dx, B, S, st);
    default: return cudaErrorInvalidValue;
  }
}

// B2's wide instance (F = 65-kWideMaxF) over B rows on `st`, on the
// prologue's buffer `prep`.
template <int K>
int poly_wide_launch(const float* x, const double* prep, float* score,
                     float* dx, int B, int S, int F, cudaStream_t st) {
  const auto kernel = poly_score_wide_kernel<K>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WideSmem<K>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kWideRows - 1) / kWideRows, kWideThreads<K>,
           WideSmem<K>::kBytes, st>>>(x, prep, score, dx, B, S, F);
  return static_cast<int>(cudaGetLastError());
}

int poly_wide_dispatch(const float* x, const double* prep, float* score,
                       float* dx, int B, int S, int F, cudaStream_t st) {
  switch ((F + 31) / 32) {
    case 3: return poly_wide_launch<3>(x, prep, score, dx, B, S, F, st);
    case 4: return poly_wide_launch<4>(x, prep, score, dx, B, S, F, st);
    case 5: return poly_wide_launch<5>(x, prep, score, dx, B, S, F, st);
    case 6: return poly_wide_launch<6>(x, prep, score, dx, B, S, F, st);
    default: return cudaErrorInvalidValue;
  }
}

// The wide instance's plan for K = ceil(F / 32), as poly_plan's.
template <int K>
int poly_wide_plan(int* out) {
  const auto kernel = poly_score_wide_kernel<K>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WideSmem<K>::kBytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kWideThreads<K>, WideSmem<K>::kBytes);
  out[0] = WideSmem<K>::kBytes;
  out[1] = blocks;
  out[2] = kWideThreads<K>;
  out[3] = kWideRows;
  return static_cast<int>(e);
}

int poly_wide_plan_dispatch(int F, int* out) {
  switch ((F + 31) / 32) {
    case 3: return poly_wide_plan<3>(out);
    case 4: return poly_wide_plan<4>(out);
    case 5: return poly_wide_plan<5>(out);
    case 6: return poly_wide_plan<6>(out);
    default: return cudaErrorInvalidValue;
  }
}

// The fp64 instance's plan, as poly_plan's (its F does not change it:
// the widest instance's occupancy).
int poly_f64_plan(int* out) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, poly_score_f64_kernel<kF64MaxF>, kF64Rows, kF64Smem);
  out[0] = kF64Smem;
  out[1] = blocks;
  out[2] = kF64Rows;
  out[3] = kF64Rows;
  return static_cast<int>(e);
}

// out = {dynamic shared bytes per block, blocks resident per SM by the
// runtime's occupancy calculator, threads per block, rows per block};
// the cudaError_t of the query.
template <int FP>
int poly_plan(int* out) {
  const auto kernel = poly_score_tc_kernel<FP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PolySmem<FP>::kBytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kTcThreads, PolySmem<FP>::kBytes);
  out[0] = PolySmem<FP>::kBytes;
  out[1] = blocks;
  out[2] = kTcThreads;
  out[3] = kTcRows;
  return static_cast<int>(e);
}

}  // namespace
}  // namespace diffco

// the tensor-core instances, F = 9-64 (FP = 16-64)
#define DIFFCO_POLY_SWITCH(FPV, CALL)        \
  switch (FPV) {                             \
    case 16: return CALL(16);                \
    case 24: return CALL(24);                \
    case 32: return CALL(32);                \
    case 40: return CALL(40);                \
    case 48: return CALL(48);                \
    case 56: return CALL(56);                \
    case 64: return CALL(64);                \
    default: return cudaErrorInvalidValue;   \
  }

// B2 at F = 1-64 (at F > 64 its wide instance, poly_score_grad_wide,
// after the prologue wide_prep). Returns the cudaError_t of the launch (0
// on success). Launches on `stream` and does not synchronise.
extern "C" int poly_score_grad(const float* x, const float* s, const float* w,
                               float* score, float* dx, int B, int S, int F,
                               void* stream) {
  if (B <= 0 || F <= 0 || F > 64 || S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= diffco::kF64MaxF)
    return diffco::poly_f64_dispatch(x, s, w, score, dx, B, S, F, st);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::poly_launch<FPV, false>(x, s, w, score, dx, B, S, F,             \
                                  diffco::kTcGuard, nullptr, st)
  DIFFCO_POLY_SWITCH((F + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// B2's wide instance at F = 65-kWideMaxF, after its prologue (wide_prep,
// on the same stream before) has written the supports and weights into
// `prep`. Returns the cudaError_t of the launch.
extern "C" int poly_score_grad_wide(const float* x, const double* prep,
                                    float* score, float* dx, int B, int S,
                                    int F, void* stream) {
  if (B <= 0 || F <= 64 || F > diffco::kWideMaxF || S < 0 ||
      prep == nullptr)
    return cudaErrorInvalidValue;
  return diffco::poly_wide_dispatch(x, prep, score, dx, B, S, F,
                                    static_cast<cudaStream_t>(stream));
}

// poly_score_grad's kernel in its measurement build: the near-pair guard
// at threshold `kappa`, its recomputations added to the device counter
// *guard_pairs (a measurement entry; production launches go through
// poly_score_grad), F = 1-64. The fp64 instance (F <= 8) has no guard
// and adds nothing; nor has the wide instance past F = 64, which
// poly_score_guard_pairs launches through poly_score_grad_wide.
extern "C" int poly_score_grad_guard(const float* x, const float* s,
                                     const float* w, float* score, float* dx,
                                     int B, int S, int F, float kappa,
                                     unsigned long long* guard_pairs,
                                     void* stream) {
  if (B <= 0 || F <= 0 || F > 64 || S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= diffco::kF64MaxF)
    return diffco::poly_f64_dispatch(x, s, w, score, dx, B, S, F, st);
#define DIFFCO_LAUNCH(FPV)                                                 \
  diffco::poly_launch<FPV, true>(x, s, w, score, dx, B, S, F, kappa,       \
                                 guard_pairs, st)
  DIFFCO_POLY_SWITCH((F + 7) / 8 * 8, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// poly_score_grad's launch plan for F components (poly_plan).
extern "C" int poly_score_plan(int F, int* out) {
  if (F <= 0 || F > diffco::kWideMaxF) return cudaErrorInvalidValue;
  if (F <= diffco::kF64MaxF) return diffco::poly_f64_plan(out);
  if (F > 64) return diffco::poly_wide_plan_dispatch(F, out);
#define DIFFCO_PLAN(FPV) diffco::poly_plan<FPV>(out)
  DIFFCO_POLY_SWITCH((F + 7) / 8 * 8, DIFFCO_PLAN)
#undef DIFFCO_PLAN
}
