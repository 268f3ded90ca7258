// The wide score block: sum_j w_j ||x - s_j|| and its point gradient for
// rows of F = 65-192 components (poly_score.cu's wide instance of B2) and
// for the control-point rows of chains past the tensor-core kernels'
// bounds (chain_wide.cuh: the wide instances of B1, B3, B4 and B5), with
// both matrix products on Hopper's fp64 tensor cores (mma.sync m16n8k4
// .f64) and the pair work in fp64 on the CUDA cores.
//
// Replaces, inside each, the score block of the TPU kernel (the cross
// term s . x^T and the [s w | w]^T . rinv product of
// diffco_tpu/ops/fused_score.py::_make_fwdgrad_kernel and fk_score.py's
// chain kernels), at widths where the 3xTF32 block of tc_score_block.cuh
// neither fits nor holds the fitted proxies' cancelling weights (sum_j
// |w_j| r_j ~ 7.5e3 against |score| ~ 1.5).
//
// A block of kWideThreads = 256 threads (8 warps) takes kWideRows = 32
// rows: two row tiles of 16, each shared by kWideGroups = 4 warps. The
// rows are centred on the block's centre c (the mean of its rows, in
// fp64) and kept as x~ = x - c in fp64 in shared memory, with |x~|^2.
// Supports stream through shared memory in chunks of kWideChunk = 32: the
// fp32 rows and weights copied with cp.async into a raw buffer while the
// last chunk computes, then centred into fp64 (s~ = s - c; component F is
// 1 and those past it 0, written once a call) beside (|s~|^2, w). Per
// (row i, support j):
//
//   product 1 (fp64 tensor cores):  dot_ij = x~_i . s~_j, a loop over
//        k-slabs of 4 of the width padded to a multiple of 4
//   d2 = max(|x~_i|^2 + |s~_j|^2 - 2 dot_ij, 0) + 1e-12
//   rinv = f64_rsqrt(d2),  score_i += w_j d2 rinv,  coef_ij = w_j rinv
//   product 2 (fp64 tensor cores):  [su~ | rowsum]_i += sum_j coef_ij
//        [s~_j | 1], F + 1 columns in n-tiles of 8
//
// after which d score / d x = x~ rowsum - su~. In fp64 the expanded
// square's rounding near a support is ~1e-16 of |x~|^2 (rows on and 1e-3
// from a support are in the replay test), so the block has no near-pair
// guard, and product 2 keeps one fp64 accumulator over all supports
// (kWideChunkSums = false: per-chunk sums, an ablation in
// scripts/ab_kernel.py, change nothing at the fitted rope's tolerance).
//
// Work split: in each chunk the row tile's four warps take one n-tile of
// 8 supports each for product 1 and the pair work, and write their coef
// to shared memory; after a barrier each warp runs product 2 over the
// chunk's 32 supports for its share of the column tiles (tiles gi, gi +
// 4, ...: at most kWideColTiles<K> = K + 1 accumulators of 4 doubles a
// lane, so that the running sums stay in registers at every F <= 192).
// After the last chunk the sums go to shared memory (over the chunk
// buffers) for the caller's epilogue.
//
// Fragments (PTX mma.m16n8k4 .f64; lane = 4 g + t): A a0, a1 at (row, k)
// = (g, t), (g + 8, t); B b0 at (k, n) = (t, g); C c0..c3 at (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Product 1's column n of an
// n-tile is the chunk's support 8 nt + sigma(n), sigma(n) = n ^ (n >> 2),
// so that its C fragment gives a lane the coef of columns 2t and 2t + 1:
// product 2 takes column 2t + h as its k = t of k-step h (A a0 = c_h, a1 =
// c_{2+h}; B the support sigma(2t + h)), which needs no shuffle; sigma
// keeps both products' B loads of s~ free of bank conflicts at the row
// stride 32 K + 4 (= 4 mod 16 doubles).
//
// Budget: __launch_bounds__(256, kWideMinBlocks = 2), at most 128
// registers a thread; WideSmem<K>::kBytes of dynamic shared memory (76-139
// KB at K = 3-6: two blocks, 16 warps, per SM up to K = 4).
//
// Ragged ends: supports past S are zeros with weight 0; rows past B are
// the caller's (copies of row B - 1, so that the centre stays on the
// data) and masked by it.
#pragma once

#include "cp_async.cuh"

#ifndef DIFFCO_HD
#define DIFFCO_HD __host__ __device__ __forceinline__
#endif

namespace diffco {

constexpr int kWideMaxF = 192;
constexpr int kWideThreads = 256;
constexpr int kWideChunk = 32;      // supports per chunk: 4 n-tiles of 8
constexpr int kWideRows = 32;       // rows per block: 2 tiles of 16
constexpr int kWideGroups = 4;      // warps per row tile
constexpr int kWideMinBlocks = 2;   // __launch_bounds__: <= 128 registers
// one fp64 accumulator for product 2 over all supports (true: a fresh one
// per chunk, added to running sums after it; scripts/ab_kernel.py's
// wideChunkSums)
constexpr bool kWideChunkSums = false;
static_assert(kWideThreads == 32 * kWideGroups * kWideRows / 16,
              "8 warps: 2 row tiles of 4");
static_assert(kWideChunk == 8 * kWideGroups, "one n-tile a warp");

// product 2's column tiles a warp takes at K = ceil(F / 32): of the
// ceil((F + 1) / 8) <= 4 K + 1, every kWideGroups-th
template <int K>
DIFFCO_HD constexpr int kWideColTiles() {
  return (4 * K + 1 + kWideGroups - 1) / kWideGroups;
}

// Dynamic shared memory, in doubles (raw floats packed two a double).
template <int K>
struct WideSmem {
  static constexpr int kS = 32 * K + 4;    // row stride of x~, s~, sums
  static constexpr int kCS = 40;           // coef row stride (16-byte
                                           // pairs, = 4 mod 8)
  static constexpr int kC = 0;                          // c [kS]
  static constexpr int kNx = kC + kS;                   // |x~|^2 [rows]
  static constexpr int kScs = kNx + kWideRows;          // [groups][rows]
  static constexpr int kXt = kScs + kWideGroups * kWideRows;  // [rows][kS]
  static constexpr int kArea = kXt + kWideRows * kS;
  // the chunk buffers
  static constexpr int kRaw = kArea;              // floats [chunk][F]
  static constexpr int kRw = kRaw + kWideChunk * 16 * K;  // floats [chunk]
  static constexpr int kSt = kRw + kWideChunk / 2;      // s~ [chunk][kS]
  static constexpr int kNsw = kSt + kWideChunk * kS;    // [chunk][2]
  static constexpr int kCoef = kNsw + 2 * kWideChunk;   // [rows][kCS]
  static constexpr int kEnd = kCoef + kWideRows * kCS;
  // before the supports: the caller's fp32 rows [rows][kS] (over s~);
  // after them: the sums [rows][kS] (su~ at f < F, rowsum at F)
  static constexpr int kRows = kSt;
  static constexpr int kSums = kArea;
  static constexpr int kBytes = 8 * kEnd;
  static_assert(kWideRows * kS / 2 <= kEnd - kSt, "rows over the chunk");
  static_assert(kWideRows * kS <= kEnd - kArea, "sums over the chunk");
};

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

// the warp's lanes meet (their shared-memory writes visible to each other)
__device__ __forceinline__ void wide_syncwarp() {
#if defined(__CUDA_ARCH__)
  __syncwarp();
#elif defined(DIFFCO_REPLAY)
  diffco_replay_syncwarp();
#endif
}

// d += A B for one m16n8k4 fp64 tile (fragments as above)
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1,
                                        double b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
#elif defined(DIFFCO_REPLAY)
  diffco_replay_mma_f64(d, a0, a1, b);
#endif
}

// two doubles in one 16-byte access
struct alignas(16) WidePair {
  double x, y;
};

// column n of product 1's n-tile: the chunk's support 8 nt + wide_sigma(n)
DIFFCO_HD constexpr int wide_sigma(int n) { return n ^ (n >> 2); }

// The block's rows: from the caller's fp32 rows xr [kWideRows][kS] (f < F
// read) the centre c, x~ and |x~|^2. Every thread calls; the caller syncs
// after writing xr. Ends synced (xr may then be overwritten).
template <int K>
__device__ __forceinline__ void wide_rows_setup(double* sm, int F) {
  using L = WideSmem<K>;
  const int tid = threadIdx.x;
  const float* xr = reinterpret_cast<const float*>(sm + L::kRows);
  for (int f = tid; f < L::kS; f += kWideThreads) {
    double cf = 0.0;
    if (f < F) {
      for (int r = 0; r < kWideRows; ++r)
        cf += static_cast<double>(xr[r * L::kS + f]);
      cf *= 1.0 / kWideRows;
    }
    sm[L::kC + f] = cf;
  }
  __syncthreads();
  for (int i = tid; i < kWideRows * L::kS; i += kWideThreads) {
    const int f = i % L::kS;
    sm[L::kXt + i] =
        f < F ? static_cast<double>(xr[i]) - sm[L::kC + f] : 0.0;
  }
  __syncthreads();
  if (tid < kWideRows) {
    const double* xt = sm + L::kXt + tid * L::kS;
    double n = 0.0;
    for (int f = 0; f < F; ++f) n = fma(xt[f], xt[f], n);
    sm[L::kNx + tid] = n;
  }
  __syncthreads();
}

// Start copying supports c0 .. c0 + n - 1 (n = min(kWideChunk, S - c0);
// s [S, F] rows, contiguous) and their weights w[j * wstride] into the
// raw buffer.
template <int K>
__device__ __forceinline__ void wide_stage(const float* __restrict__ s,
                                           const float* __restrict__ w,
                                           int wstride, int c0, int S, int F,
                                           double* sm) {
  using L = WideSmem<K>;
  float* raw = reinterpret_cast<float*>(sm + L::kRaw);
  float* rw = reinterpret_cast<float*>(sm + L::kRw);
  const int n = min(kWideChunk, S - c0);
  const float* src = s + static_cast<size_t>(c0) * F;
  for (int i = threadIdx.x; i < n * F; i += kWideThreads)
    cp_async_f32(raw + i, src + i, true);
  if (threadIdx.x < n)
    cp_async_f32(rw + threadIdx.x,
                 w + static_cast<size_t>(c0 + threadIdx.x) * wstride, true);
  cp_async_commit();
}

// Centre the raw buffer's n supports into s~ (fp64, components < F;
// zeros for supports past n; the columns from F on are wide_tc_pairs')
// and (|s~|^2, w). Eight threads a support; every thread calls between
// barriers.
template <int K>
__device__ __forceinline__ void wide_transform(double* sm, int n, int F) {
  using L = WideSmem<K>;
  const float* raw = reinterpret_cast<const float*>(sm + L::kRaw);
  const float* rw = reinterpret_cast<const float*>(sm + L::kRw);
  const int j = threadIdx.x / 8, e = threadIdx.x % 8;
  const bool in = j < n;
  double* st = sm + L::kSt + j * L::kS;
  double ns = 0.0;
  for (int f = e; f < F; f += 8) {
    const double v =
        in ? static_cast<double>(raw[j * F + f]) - sm[L::kC + f] : 0.0;
    ns = fma(v, v, ns);
    st[f] = v;
  }
  ns += shfl_xor_f64(ns, 1);
  ns += shfl_xor_f64(ns, 2);
  ns += shfl_xor_f64(ns, 4);
  if (e == 0) {
    sm[L::kNsw + 2 * j] = ns;
    sm[L::kNsw + 2 * j + 1] = in ? static_cast<double>(rw[j]) : 0.0;
  }
}

// The score of the block's rows (set up by wide_rows_setup) against
// supports s [S, F] with weights w[j * wstride]. Every thread calls. On
// return (synced) row i's sums are at WideSmem<K>::kSums + i kS (su~ at
// f < F, rowsum at F) and its score is the sum over the groups g of
// kScs + g kWideRows + i (wide_row_score).
template <int K>
__device__ __forceinline__ void wide_tc_pairs(const float* __restrict__ s,
                                              const float* __restrict__ w,
                                              int wstride, int S, int F,
                                              double* sm) {
  using L = WideSmem<K>;
  constexpr int CT = kWideColTiles<K>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int gi = warp % kWideGroups, r0 = 16 * (warp / kWideGroups);
  const int KS1 = (F + 3) / 4, NT2 = F / 8 + 1;
  const double nx0 = sm[L::kNx + r0 + g], nx1 = sm[L::kNx + r0 + g + 8];
  const double* xa = sm + L::kXt + (r0 + g) * L::kS + t;
  const double* xb = xa + 8 * L::kS;
  double* coef_g = sm + L::kCoef + (r0 + g) * L::kCS;
  double* coef_g8 = coef_g + 8 * L::kCS;
  double acc2[CT][4], run[CT][4];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[i][e] = run[i][e] = 0.0;
  }
  double sc0 = 0.0, sc1 = 0.0;
  // s~'s columns from F on, the same in every chunk: 1 at F, zeros past
  for (int i = tid; i < kWideChunk * L::kS; i += kWideThreads) {
    const int f = i % L::kS;
    if (f >= F) sm[L::kSt + i] = f == F ? 1.0 : 0.0;
  }
  if (S > 0) wide_stage<K>(s, w, wstride, 0, S, F, sm);
  for (int c0 = 0; c0 < S; c0 += kWideChunk) {
    cp_async_wait_all();
    __syncthreads();  // the chunk landed; the last chunk's reads are done
    wide_transform<K>(sm, min(kWideChunk, S - c0), F);
    __syncthreads();
    if (c0 + kWideChunk < S)
      wide_stage<K>(s, w, wstride, c0 + kWideChunk, S, F, sm);
    // product 1 on n-tile gi, then the pair work
    double acc1[4] = {0.0, 0.0, 0.0, 0.0};
    const double* sb = sm + L::kSt + (8 * gi + wide_sigma(g)) * L::kS + t;
    for (int ks = 0; ks < KS1; ++ks)
      mma_f64(acc1, xa[4 * ks], xb[4 * ks], sb[4 * ks]);
    double coef[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const WidePair nw = *reinterpret_cast<const WidePair*>(
          sm + L::kNsw + 2 * (8 * gi + wide_sigma(2 * t + (e & 1))));
      const double wj = nw.y;
      double d2 = fma(-2.0, acc1[e], (e < 2 ? nx0 : nx1) + nw.x);
      d2 = fmax(d2, 0.0) + 1e-12;
      const double rinv = f64_rsqrt(d2);
      if (e < 2)
        sc0 = fma(wj, d2 * rinv, sc0);
      else
        sc1 = fma(wj, d2 * rinv, sc1);
      coef[e] = wj * rinv;
    }
    *reinterpret_cast<WidePair*>(coef_g + 8 * gi + 2 * t) =
        WidePair{coef[0], coef[1]};
    *reinterpret_cast<WidePair*>(coef_g8 + 8 * gi + 2 * t) =
        WidePair{coef[2], coef[3]};
    __syncthreads();  // the row tile's coef
    // product 2 over the chunk's 8 k-steps, this warp's column tiles
#pragma unroll 1
    for (int nt = 0; nt < kWideChunk / 8; ++nt) {
      const WidePair p0 =
          *reinterpret_cast<const WidePair*>(coef_g + 8 * nt + 2 * t);
      const WidePair p8 =
          *reinterpret_cast<const WidePair*>(coef_g8 + 8 * nt + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double a0 = h ? p0.y : p0.x, a1 = h ? p8.y : p8.x;
        const double* sj =
            sm + L::kSt + (8 * nt + wide_sigma(2 * t + h)) * L::kS + g;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int ct = gi + kWideGroups * i;
          if (ct < NT2) {
            const double b = 8 * ct + g <= F ? sj[8 * ct] : 0.0;
            mma_f64(acc2[i], a0, a1, b);
          }
        }
      }
    }
    if constexpr (kWideChunkSums) {
#pragma unroll
      for (int i = 0; i < CT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          run[i][e] += acc2[i][e];
          acc2[i][e] = 0.0;
        }
      }
    }
  }
  if constexpr (kWideChunkSums) {
#pragma unroll
    for (int i = 0; i < CT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][e] = run[i][e];
    }
  }
  __syncthreads();  // the chunk buffers are free: the sums go over them
  double* sums = sm + L::kSums;
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int ct = gi + kWideGroups * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * ct + 2 * t + (e & 1);
      if (ct < NT2 && col <= F)
        sums[(r0 + g + 8 * (e / 2)) * L::kS + col] = acc2[i][e];
    }
  }
  sc0 += shfl_xor_f64(sc0, 1);
  sc0 += shfl_xor_f64(sc0, 2);
  sc1 += shfl_xor_f64(sc1, 1);
  sc1 += shfl_xor_f64(sc1, 2);
  if (t == 0) {
    sm[L::kScs + gi * kWideRows + r0 + g] = sc0;
    sm[L::kScs + gi * kWideRows + r0 + g + 8] = sc1;
  }
  __syncthreads();
}

// Row i's score after wide_tc_pairs.
template <int K>
__device__ __forceinline__ double wide_row_score(const double* sm, int i) {
  double sc = 0.0;
#pragma unroll
  for (int gi = 0; gi < kWideGroups; ++gi)
    sc += sm[WideSmem<K>::kScs + gi * kWideRows + i];
  return sc;
}

// Row i's gradient component f after wide_tc_pairs: x~ rowsum - su~.
template <int K>
__device__ __forceinline__ double wide_row_grad(const double* sm, int i,
                                                int f, int F) {
  using L = WideSmem<K>;
  const double* su = sm + L::kSums + i * L::kS;
  return fma(sm[L::kXt + i * L::kS + f], su[F], -su[f]);
}

}  // namespace diffco
