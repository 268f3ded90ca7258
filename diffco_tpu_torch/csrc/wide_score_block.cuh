// The wide score block: sum_j w_j ||x - s_j|| and its point gradient for
// rows of F = 65-192 components (poly_score.cu's wide instance of B2) and
// for the control-point rows of chains past the tensor-core kernels'
// bounds (chain_wide.cuh: the wide instances of B1, B3, B4 and B5), with
// both matrix products on Hopper's fp64 tensor cores (mma.sync .f64,
// m16n8k8 and m16n8k16) and the pair work in fp64 on the CUDA cores.
//
// Replaces, inside each, the score block of the TPU kernel (the cross
// term s . x^T and the [s w | w]^T . rinv product of
// diffco_tpu/ops/fused_score.py::_make_fwdgrad_kernel and fk_score.py's
// chain kernels), at widths where the 3xTF32 block of tc_score_block.cuh
// neither fits nor holds the fitted proxies' cancelling weights (sum_j
// |w_j| r_j ~ 7.5e3 against |score| ~ 1.5).
//
// Two launches a call. The prologue (wide_prep_kernel, once per call)
// writes the supports ready for the tensor cores into a device buffer
// (wide_prep_doubles, ~1.8 MB at the 35-link rope's 1664 supports, read
// from L2 by every block): the call's centre c (the mean of the first chunk of
// supports, in fp64), s~ = s - c in fp64 at the block's row stride with
// component F = 1 and zeros after it, and per weight column (|s~|^2, w),
// padded with zero supports to whole chunks. The score kernel's blocks
// then copy ready fp64 tiles, nothing converted: a chunk of kWideChunk =
// 32 supports with cp.async into a ring of kWideStages buffers, one
// barrier a chunk. A block takes kWideRows = 64 rows, kept as the fp32
// points x in shared memory with |x~|^2 (x~ = x - c in fp64). Per (row i,
// support j):
//
//   product 1 (fp64 tensor cores):  dot_ij = x~_i . s~_j, a loop over
//        k-slabs of 4 of the width padded to a multiple of 4, the A
//        fragment x~ = double(x) - c made as it is loaded
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
// Work split (register blocking): each warp owns a row tile of 16 rows
// for both products. In each chunk it runs product 1 on all four n-tiles
// of 8 supports from one load of its A fragment (16 rows x 32 supports:
// 1.5 operand loads a DMMA, where one n-tile a warp took 3), the pair
// work, and product 2 with its coef straight from product 1's C
// fragments in registers, over all of its column tiles: kWideColTiles<K>
// accumulators of 4 doubles a lane, the running sums of every column, so
// that a B fragment of s~ is its only shared load (1 a DMMA) and no coef
// passes through shared memory. Up to K = 4 a warp holds all 4 K + 1
// column tiles (~250 registers at K = 4: two blocks of 4 warps, 8 warps,
// per SM by shared memory, kWideMinBlocks); at K = 5, 6 (kWideSplit = 2)
// two warps share a row tile, each holding half the column tiles and
// both running product 1. After the last chunk the sums go to shared
// memory (over the chunk buffers) for the caller's epilogue.
//
// Fragments (PTX mma.sync .f64, m16n8kKK; lane = 4 g + t; k-slab j of 4
// of a DMMA): A a[2j], a[2j + 1] at (row, k) = (g, 4j + t), (g + 8, 4j +
// t); B b[j] at (k, n) = (4j + t, g); C c0..c3 at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). Product 1's column n of an n-tile is the
// chunk's support 8 nt + sigma(n), sigma(n) = n ^ (n >> 2), so that its
// C fragment gives a lane the coef of columns 2t and 2t + 1: product 2
// takes column 2t + h of n-tile nt as its k = t of k-slab u = 2 nt + h
// (A a0 = c_h, a1 = c_{2+h}; B the support sigma(2t + h)), which needs no
// shuffle; sigma keeps both products' B loads of s~ free of bank
// conflicts at the row stride 32 K + 4 (= 4 mod 16 doubles), and x's row
// stride 32 K + 4 floats (= 4 mod 32) keeps the A loads free of them.
//
// Chosen by measurement (ab_kernel-style A/B on the card: the 35-link
// rope's sweep, B = 65573, S = 1536, H100 at 700 W): product 1 on
// m16n8k8 (kWideK1) and product 2 on m16n8k16 (kWideK2), 1.731 ms a call
// against 2.064 with m16n8k4 for both, 1.739 with k4 / k16, 1.755 with
// k8 / k8 and 1.723 with k16 / k16 (255 registers, left for the margin);
// two blocks of 4 warps per SM (64 rows) against one of 8 (128 rows, 4
// chunk buffers; scripts/ab_kernel.py's wideRows128): 1.778 against
// 1.763 ms, within 1 %, and the smaller block keeps more blocks per wave
// at small batches.
//
// Budget: __launch_bounds__(kWideThreads<K>, kWideMinBlocks<K>);
// WideSmem<K>::kBytes of dynamic shared memory (29-151 KB at K = 1-6).
//
// Ragged ends: supports past S are the prologue's zeros with weight 0;
// rows past B are the caller's (copies of row B - 1) and masked by it.
#pragma once

#include "cp_async.cuh"

#ifndef DIFFCO_HD
#define DIFFCO_HD __host__ __device__ __forceinline__
#endif

extern __shared__ __align__(16) float diffco_tc_smem[];

namespace diffco {

constexpr int kWideMaxF = 192;
constexpr int kWideChunk = 32;      // supports a chunk: 4 n-tiles of 8
constexpr int kWideRowTiles = 4;    // row tiles of 16 a block
// the k of a DMMA (mma.sync m16n8kK .f64, 8 or 16): product 1's over the
// width, product 2's over a chunk's supports
constexpr int kWideK1 = 8;
constexpr int kWideK2 = 16;
constexpr int kWideRows = 16 * kWideRowTiles;
// chunk buffers in the ring: as many as hold the block's sums after the
// loop (two at 64 rows)
constexpr int kWideStages = kWideRows / kWideChunk;
// one fp64 accumulator for product 2 over all supports (true: a fresh one
// per chunk, added to running sums after it; scripts/ab_kernel.py's
// wideChunkSums)
constexpr bool kWideChunkSums = false;
static_assert(kWideStages >= 2, "a ring of at least two chunks");

// warps a row tile at K = ceil(F / 32): one while its 4 K + 1 column
// tiles of product 2 fit one warp's registers, two (each half of them)
// above
template <int K>
constexpr int kWideSplit = K <= 4 ? 1 : 2;
template <int K>
constexpr int kWideThreads = 32 * kWideRowTiles * kWideSplit<K>;
// product 2's column tiles a warp holds: of the ceil((F + 1) / 8) <=
// 4 K + 1, every kWideSplit-th
template <int K>
constexpr int kWideColTiles = (4 * K + kWideSplit<K>) / kWideSplit<K>;
// blocks per SM in the launch bound: 16 warps per SM at K = 1, 12 at
// K = 2, 8 above (where a warp's accumulators take ~200 registers), at
// least one block
DIFFCO_HD constexpr int wide_min_blocks(int warps_per_sm, int warps) {
  return warps_per_sm / warps > 1 ? warps_per_sm / warps : 1;
}
template <int K>
constexpr int kWideMinBlocks = wide_min_blocks(
    K == 1 ? 16 : K == 2 ? 12 : 8, kWideThreads<K> / 32);

// the row stride of s~ and of the sums (doubles), of x (floats)
DIFFCO_HD constexpr int wide_stride(int F) { return (F + 31) / 32 * 32 + 4; }
// supports padded to whole chunks
DIFFCO_HD constexpr int wide_padded(int S) {
  return (S + kWideChunk - 1) / kWideChunk * kWideChunk;
}

// The prologue's buffer, in doubles: the centre c [kS], s~ [Sp][kS], then
// per weight column [Sp][2] (|s~|^2, w), kS = wide_stride(F), Sp =
// wide_padded(S).
DIFFCO_HD constexpr size_t wide_prep_st(int F) { return wide_stride(F); }
DIFFCO_HD constexpr size_t wide_prep_nsw(int S, int F, int c) {
  return wide_stride(F) * (1 + static_cast<size_t>(wide_padded(S))) +
         2 * static_cast<size_t>(wide_padded(S)) * c;
}
DIFFCO_HD constexpr size_t wide_prep_doubles(int S, int F, int C) {
  return wide_prep_nsw(S, F, C);
}

// Dynamic shared memory, in doubles (x's floats packed two a double).
template <int K>
struct WideSmem {
  static constexpr int kS = 32 * K + 4;     // row stride of s~, the sums
  static constexpr int kSx = 32 * K + 4;    // row stride of x (floats)
  static constexpr int kC = 0;                          // c [kS]
  static constexpr int kNx = kC + kS;                   // |x~|^2 [rows]
  static constexpr int kSc = kNx + kWideRows;           // scores [rows]
  static constexpr int kX = kSc + kWideRows;            // x [rows][kSx]
  // the ring: s~ [stages][chunk][kS], then (|s~|^2, w) [stages][chunk]
  static constexpr int kSt = kX + kWideRows * kSx / 2;
  static constexpr int kNsw = kSt + kWideStages * kWideChunk * kS;
  static constexpr int kEnd = kNsw + kWideStages * kWideChunk * 2;
  // after the supports: the sums [rows][kS] (su~ at f < F, rowsum at F)
  static constexpr int kSums = kSt;
  static constexpr int kBytes = 8 * kEnd;
  static_assert(kWideRows * kS <= kNsw - kSt, "sums over the chunk");
  static_assert(kSt % 2 == 0 && kS % 2 == 0, "16-byte cp.async rows");
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

// d += A B for one m16n8kKK fp64 tile, KK = 8 or 16 (fragments as
// above, k-slab j of 4 in a[2 j], a[2 j + 1] and b[j]: A (g, 4 j + t),
// (g + 8, 4 j + t), B (4 j + t, g))
template <int KK>
__device__ __forceinline__ void mma_f64(double (&d)[4],
                                        const double (&a)[KK / 2],
                                        const double (&b)[KK / 4]) {
  static_assert(KK == 8 || KK == 16, "m16n8k8 or m16n8k16");
#if defined(__CUDA_ARCH__)
  if constexpr (KK == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
          "d"(b[2]), "d"(b[3]));
  }
#elif defined(DIFFCO_REPLAY)
  diffco_replay_mma_f64<KK>(d, a, b);
#endif
}

// two doubles in one 16-byte access
struct alignas(16) WidePair {
  double x, y;
};

// column n of product 1's n-tile: the chunk's support 8 nt + wide_sigma(n)
DIFFCO_HD constexpr int wide_sigma(int n) { return n ^ (n >> 2); }

constexpr int kWidePrepThreads = 256;   // 8 a support: a chunk a block

// The prologue, once per call, on a grid of max(1, Sp / kWideChunk)
// blocks of kWidePrepThreads threads and 8 wide_stride(F) bytes of
// dynamic shared memory: supports s [S, F] and weight columns W [S, C]
// into the buffer `out` (WidePrep above). Each block computes the centre
// from the first chunk (the same sums in the same order in every block;
// block 0 writes it) and prepares its own chunk, eight threads a support.
__global__ void __launch_bounds__(kWidePrepThreads)
wide_prep_kernel(const float* __restrict__ s, const float* __restrict__ W,
                 int S, int F, int C, double* __restrict__ out) {
  double* c = reinterpret_cast<double*>(diffco_tc_smem);
  const int kS = wide_stride(F), Sp = wide_padded(S);
  const int tid = threadIdx.x;
  const int n0 = min(S, kWideChunk);
  for (int f = tid; f < kS; f += kWidePrepThreads) {
    double cf = 0.0;
    if (f < F && n0 > 0) {
      for (int j = 0; j < n0; ++j)
        cf += static_cast<double>(s[static_cast<size_t>(j) * F + f]);
      cf /= n0;
    }
    c[f] = cf;
    if (blockIdx.x == 0) out[f] = cf;
  }
  __syncthreads();
  const int e = tid % 8;
  const int j = blockIdx.x * kWideChunk + tid / 8;
  if (j >= Sp) return;   // S = 0: the centre alone
  const bool in = j < S;
  double* st = out + wide_prep_st(F) + static_cast<size_t>(j) * kS;
  double ns = 0.0;
  for (int f = e; f < kS; f += 8) {
    double v = f == F ? 1.0 : 0.0;
    if (f < F && in) {
      v = static_cast<double>(s[static_cast<size_t>(j) * F + f]) - c[f];
      ns = fma(v, v, ns);
    }
    st[f] = v;
  }
  ns += shfl_xor_f64(ns, 1);
  ns += shfl_xor_f64(ns, 2);
  ns += shfl_xor_f64(ns, 4);
  if (e == 0) {
    for (int k = 0; k < C; ++k) {
      double* nsw = out + wide_prep_nsw(S, F, k) + 2 * j;
      nsw[0] = ns;
      nsw[1] = in ? static_cast<double>(W[static_cast<size_t>(j) * C + k])
                  : 0.0;
    }
  }
}

// The block's rows: from its fp32 points x [kWideRows][kSx] in shared
// memory (components F to kSx zero; the caller writes them and syncs)
// and the prologue's centre, the centre into shared memory and |x~|^2.
// Every thread calls. Ends synced.
template <int K>
__device__ __forceinline__ void wide_rows_setup(
    const double* __restrict__ prep, double* sm, int F) {
  using L = WideSmem<K>;
  const int tid = threadIdx.x;
  for (int f = tid; f < L::kS; f += kWideThreads<K>) sm[L::kC + f] = prep[f];
  __syncthreads();
  const float* x = reinterpret_cast<const float*>(sm + L::kX);
  if (tid < kWideRows) {
    const float* xr = x + tid * L::kSx;
    double n = 0.0;
    for (int f = 0; f < F; ++f) {
      const double v = static_cast<double>(xr[f]) - sm[L::kC + f];
      n = fma(v, v, n);
    }
    sm[L::kNx + tid] = n;
  }
  __syncthreads();
}

// Start copying chunk ch of the prologue's s~ (st) and weight column
// (nsw) into ring buffer ch % kWideStages: whole 16-byte pairs, no
// conversion.
template <int K>
__device__ __forceinline__ void wide_stage(const double* __restrict__ st,
                                           const double* __restrict__ nsw,
                                           int ch, double* sm) {
  using L = WideSmem<K>;
  constexpr int kTile = kWideChunk * L::kS / 2;   // pairs of s~
  const int b = ch % kWideStages;
  const double* src = st + static_cast<size_t>(ch) * kWideChunk * L::kS;
  double* dst = sm + L::kSt + b * kWideChunk * L::kS;
  for (int i = threadIdx.x; i < kTile; i += kWideThreads<K>)
    cp_async_16(dst + 2 * i, src + 2 * i);
  if (threadIdx.x < kWideChunk)
    cp_async_16(sm + L::kNsw + 2 * (b * kWideChunk + threadIdx.x),
                nsw + 2 * (static_cast<size_t>(ch) * kWideChunk +
                           threadIdx.x));
  cp_async_commit();
}

// The score of the block's rows (set up by wide_rows_setup) against the
// prologue's supports, on its weight column c. Every thread calls. On
// return (synced) row i's sums are at WideSmem<K>::kSums + i kS (su~ at
// f < F, rowsum at F) and its score at kSc + i.
template <int K>
__device__ __forceinline__ void wide_tc_pairs(const double* __restrict__ prep,
                                              int S, int F, int c,
                                              double* sm) {
  using L = WideSmem<K>;
  constexpr int G = kWideSplit<K>, CT = kWideColTiles<K>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int half = warp % G, r0 = 16 * (warp / G);
  constexpr int J1 = kWideK1 / 4, J2 = kWideK2 / 4;   // k-slabs a DMMA
  const int KS1 = (F + kWideK1 - 1) / kWideK1, NT2 = F / 8 + 1;
  const int nch = wide_padded(S) / kWideChunk;
  const double* st_g = prep + wide_prep_st(F);
  const double* nsw_g = prep + wide_prep_nsw(S, F, c);
  const double nx0 = sm[L::kNx + r0 + g], nx1 = sm[L::kNx + r0 + g + 8];
  const float* xa = reinterpret_cast<const float*>(sm + L::kX) +
                    (r0 + g) * L::kSx + t;
  const float* xb = xa + 8 * L::kSx;
  const double* ct0 = sm + L::kC + t;
  double acc2[CT][4], run[CT][4];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[i][e] = run[i][e] = 0.0;
  }
  double sc0 = 0.0, sc1 = 0.0;
  if (nch > 0) wide_stage<K>(st_g, nsw_g, 0, sm);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // the chunk landed; the last chunk's reads are done
    if (ch + 1 < nch) wide_stage<K>(st_g, nsw_g, ch + 1, sm);
    const int b = ch % kWideStages;
    const double* st = sm + L::kSt + b * kWideChunk * L::kS;
    const double* nsw = sm + L::kNsw + 2 * b * kWideChunk;
    // product 1 on the chunk's four n-tiles, one A fragment a k-step
    double acc1[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[nt][e] = 0.0;
    }
    const double* sb = st + wide_sigma(g) * L::kS + t;
#pragma unroll 2
    for (int ks = 0; ks < KS1; ++ks) {
      double a[2 * J1];
#pragma unroll
      for (int j = 0; j < J1; ++j) {
        const int k = kWideK1 * ks + 4 * j;
        const double cf = ct0[k];
        a[2 * j] = static_cast<double>(xa[k]) - cf;
        a[2 * j + 1] = static_cast<double>(xb[k]) - cf;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        double b[J1];
#pragma unroll
        for (int j = 0; j < J1; ++j)
          b[j] = sb[8 * nt * L::kS + kWideK1 * ks + 4 * j];
        mma_f64<kWideK1>(acc1[nt], a, b);
      }
    }
    // the pair work: coef of columns 2t + (e & 1), rows g (e < 2), g + 8
    double coef[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      WidePair nw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        nw[h] = *reinterpret_cast<const WidePair*>(
            nsw + 2 * (8 * nt + wide_sigma(2 * t + h)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const WidePair p = nw[e & 1];
        double d2 = fma(-2.0, acc1[nt][e], (e < 2 ? nx0 : nx1) + p.x);
        d2 = fmax(d2, 0.0) + 1e-12;
        const double rinv = f64_rsqrt(d2);
        if (half == 0) {
          if (e < 2)
            sc0 = fma(p.y, d2 * rinv, sc0);
          else
            sc1 = fma(p.y, d2 * rinv, sc1);
        }
        coef[nt][e] = p.y * rinv;
      }
    }
    // product 2 over the chunk's 8 k-slabs of 4 (slab u: n-tile u / 2,
    // columns 2t + u % 2), J2 a DMMA, this warp's column tiles
#pragma unroll
    for (int kk = 0; kk < 8 / J2; ++kk) {
      double a[2 * J2];
      const double* sj[J2];
#pragma unroll
      for (int j = 0; j < J2; ++j) {
        const int u = J2 * kk + j, nt = u / 2, h = u % 2;
        a[2 * j] = coef[nt][h];
        a[2 * j + 1] = coef[nt][2 + h];
        sj[j] = st + (8 * nt + wide_sigma(2 * t + h)) * L::kS + g;
      }
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        const int ct = half + G * i;
        if (ct < NT2) {
          double b[J2];
#pragma unroll
          for (int j = 0; j < J2; ++j)
            b[j] = 8 * ct + g <= F ? sj[j][8 * ct] : 0.0;
          mma_f64<kWideK2>(acc2[i], a, b);
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
    const int ct = half + G * i;
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
  if (half == 0 && t == 0) {
    sm[L::kSc + r0 + g] = sc0;
    sm[L::kSc + r0 + g + 8] = sc1;
  }
  __syncthreads();
}

// Row i's score after wide_tc_pairs.
template <int K>
__device__ __forceinline__ double wide_row_score(const double* sm, int i) {
  return sm[WideSmem<K>::kSc + i];
}

// Row i's gradient component f after wide_tc_pairs: x~ rowsum - su~.
template <int K>
__device__ __forceinline__ double wide_row_grad(const double* sm, int i,
                                                int f, int F) {
  using L = WideSmem<K>;
  const double* su = sm + L::kSums + i * L::kS;
  const double xt =
      static_cast<double>(
          reinterpret_cast<const float*>(sm + L::kX)[i * L::kSx + f]) -
      sm[L::kC + f];
  return fma(xt, su[F], -su[f]);
}

}  // namespace diffco
