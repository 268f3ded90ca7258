// Multi-class polyharmonic score block for the one-pass FK kernels: each
// (configuration, support) pair's distance is computed once for every
// class of a pass (chain_multi_score.cu, B5; dh_multi_score.cu, B4).
//
// A block holds kMultiRows configurations ("rows"), their control points
// x [FP] in shared memory, and walks the supports in chunks of
// kMultiChunk, staged with cp.async into a double buffer so that the next
// chunk loads while this one computes. For the Cg classes of a pass
// (k0 .. k0 + Cg - 1 of the C weight columns W [S, C]):
//
//   phase A, once per (row, support) pair, two threads per row:
//     d2 = sum_f (x_f - s_jf)^2   (direct difference: fitted weights
//                                  cancel, and the expanded square loses
//                                  digits next to a support)
//     rinv = rsqrt(max(d2, 0) + 1e-12),  r = d2 * rinv
//     score_c += w_jc * r         (TwoSum, per class, as score_block.cuh)
//     Rinv[j][row] = rinv         (shared)
//   phase B, the sums of every class as one product:
//     [su_c | rowsum_c]_(row, c) += sum_j Rinv[j][row] * Z[j][c]
//   over the class table Z[j] = [s_j w_j0 | w_j0 | s_j w_j1 | w_j1 | ...]
//   (Cg (FP + 1) <= kMultiCols columns, built from the staged s and W),
//   each thread an 8 x 8 register tile of the kMultiRows x kMultiCols
//   accumulator: four shared float4 loads per 64 FMAs.
//
// Three instances, one chosen per launch by its class count C
// (multi_dispatch):
//   register, C <= kCgReg = floor(kRegCols / (FP + 1)) at FP <= 24 (2 at
//     FP = 16 and 24, 5 at FP = 8; none on wider rows): no
//     table, no Rinv tile, no phase B; phase A itself adds
//     su_c += (w_jc rinv) s_j and rowsum_c += w_jc rinv in registers
//     (C (FP + 1) floats a thread), one barrier per chunk (the staging).
//     The product form pays only when three or more classes share a
//     distance.
//   narrow, C <= kCgNarrow (the table's first 64 columns): phases A and B
//     with 8 x 4 product tiles, three loads per 32 FMAs.
//   full, any C <= kMaxC: 8 x 8 tiles, passes of Cg classes.
//
// Every pair reads s_j once (a broadcast float4 per four components) and
// the product reads a float4 per 16 FMAs. After the last chunk the sums
// go to shared memory over the class table and Rinv: the product's
// accumulator one half of the rows at a time ([64][kTileStride]), the
// register instance's two halves of the supports added there for all
// 128 rows at once ([128][multi_reg_stride], one row's classes at
// c (FP + 1) + f in both layouts). The kernel's epilogue reads a row's
// su_c and rowsum_c there (d score_c / d x = x * rowsum_c - su_c) with
// the two partial scores of each (row, class), and runs its own backward.
//
// Budget per block: kMultiThreads = 256 threads and, with
// __launch_bounds__(256, 2), at most 128 registers each; 58-86 KB of
// dynamic shared memory (MultiSmem<FP>::kBytes, the same for the three
// instances). So two blocks, 16 warps, stay resident per SM for every FP
// the kernels are built for (ops/_native.py::multi_plan mirrors this
// arithmetic and the launch rule for the CPU tests: change both
// together).
#pragma once

#include <type_traits>

#include "cp_async.cuh"
#include "score_block.cuh"

namespace diffco {

constexpr int kMultiRows = 128;     // configurations per block
constexpr int kMultiThreads = 256;  // 2 per row (phase A), 16 x 16 (B)
constexpr int kMultiChunk = 32;     // supports per staged chunk
constexpr int kMultiCols = 128;     // class-table columns per pass
constexpr int kMultiHalves = kMultiThreads / kMultiRows;
// a staged support's weights: its C classes, zeros up to kMaxC (staged),
// and kMaxC more zeros (written once), so that a pass's class index
// k0 + c (< kMaxC - 1 + Cg) stays in the row and reads a zero past C
constexpr int kWStride = 2 * kMaxC;
constexpr int kTileRows = 64;       // accumulator rows in shared at a time
constexpr int kTileStride = kMultiCols + 1;  // odd: a row per lane, no bank
                                             // conflicts in the epilogue
// register instance: at most kRegCols sums (C (FP + 1)) per thread, for
// rows of at most kRegMaxFP components, whose points stay in registers:
// with the compensated scores and the pair's operands that keeps within
// 128 registers, unspilled (ptxas spilled 44-716 B at FP = 32-48, where
// the points come from shared memory and a pair's s_j stays in registers)
constexpr int kRegCols = 50;
constexpr int kRegMaxFP = 24;
// the instances, in the order of the launch rule
constexpr int kInstReg = 0, kInstNarrow = 1, kInstFull = 2;

// classes per pass: each takes FP + 1 columns of the table
template <int FP>
constexpr int multi_classes_per_pass() {
  return kMultiCols / (FP + 1) < kMaxC ? kMultiCols / (FP + 1) : kMaxC;
}

// classes per pass of a narrow pass, which uses only the table's first 64
// columns (8 x 4 product tiles); 0 where not one class fits
template <int FP>
constexpr int multi_narrow_classes() {
  return kMultiCols / 2 / (FP + 1) < kMaxC ? kMultiCols / 2 / (FP + 1)
                                            : kMaxC;
}

// classes of a register-instance launch (0: no register instance)
template <int FP>
DIFFCO_HD constexpr int multi_reg_classes() {
  return FP > kRegMaxFP               ? 0
         : kRegCols / (FP + 1) < kMaxC ? kRegCols / (FP + 1)
                                       : kMaxC;
}

// row stride of the register instance's sums in shared memory: NC classes
// of FP + 1, made odd (a row per lane, no bank conflicts)
template <int FP, int NC>
DIFFCO_HD constexpr int multi_reg_stride() {
  return (NC * (FP + 1)) | 1;
}

// Dynamic shared memory, in floats (every offset a multiple of 4, so
// float4 reads stay aligned).
template <int FP>
struct MultiSmem {
  static constexpr int kCg = multi_classes_per_pass<FP>();
  static constexpr int kCgNarrow = multi_narrow_classes<FP>();
  static constexpr int kCgReg = multi_reg_classes<FP>();
  static constexpr int kX = 0;                                  // [128][FP]
  static constexpr int kPart = kX + kMultiRows * FP;  // [2][128][Cg][2]
  static constexpr int kS = kPart + kMultiThreads * kCg * 2;    // [2][K][FP]
  static constexpr int kW = kS + 2 * kMultiChunk * FP;         // [2][K][16]
  static constexpr int kZ = kW + 2 * kMultiChunk * kWStride;    // [K][128]
  static constexpr int kRinv = kZ + kMultiChunk * kMultiCols;   // [K][128]
  // half of the accumulator, [64][129], over Z and Rinv (free between
  // passes) and 64 floats past them
  static constexpr int kTile = kZ;
  static constexpr int kFloats = kTile + kTileRows * kTileStride;
  static constexpr int kBytes = 4 * kFloats;
  static_assert(kRinv + kMultiChunk * kMultiRows <= kFloats, "rinv");
  // the register instance's partial scores and its [128][stride] sums
  static_assert(kCgReg <= kCg, "partial scores");
  static_assert(kTile + kMultiRows * multi_reg_stride<FP, kCgReg>() <=
                    kFloats, "register sums");
};

// Classes one pass of an instance takes (NC: the register instance's).
template <int FP, int kInst, int NC>
DIFFCO_HD constexpr int multi_pass_classes() {
  return kInst == kInstReg      ? NC
         : kInst == kInstNarrow ? MultiSmem<FP>::kCgNarrow
                                : MultiSmem<FP>::kCg;
}

// The launch rule: returns fn(inst, nc) for the instance that a launch of
// C classes takes, both as std::integral_constant: the register instance
// built for nc = C classes when C <= kCgReg, else the narrow one when
// C <= kCgNarrow, else the full one (nc = 0 for both).
template <int FP, int NC = 1, class Fn>
int multi_dispatch(int C, Fn&& fn) {
  using L = MultiSmem<FP>;
  if constexpr (NC <= L::kCgReg) {
    if (C == NC)
      return fn(std::integral_constant<int, kInstReg>{},
                std::integral_constant<int, NC>{});
    return multi_dispatch<FP, NC + 1>(C, fn);
  } else {
    if constexpr (L::kCgNarrow > 0)
      if (C <= L::kCgNarrow)
        return fn(std::integral_constant<int, kInstNarrow>{},
                  std::integral_constant<int, 0>{});
    return fn(std::integral_constant<int, kInstFull>{},
              std::integral_constant<int, 0>{});
  }
}

#ifdef __CUDACC__
// Zero what the staging never writes: the padding components F..FP-1
// and the weight rows' tails kMaxC..kWStride-1 of both buffers. Callers
// sync before phase A reads them.
template <int FP>
__device__ __forceinline__ void multi_zero_padding(float* smem, int F) {
  float* sb = smem + MultiSmem<FP>::kS;
  for (int i = threadIdx.x; i < 2 * kMultiChunk * FP; i += kMultiThreads)
    if (i % FP >= F) sb[i] = 0.f;
  float* wb = smem + MultiSmem<FP>::kW;
  for (int i = threadIdx.x; i < 2 * kMultiChunk * kWStride;
       i += kMultiThreads)
    if (i % kWStride >= kMaxC) wb[i] = 0.f;
}

// Start copying supports c0 .. c0 + kMultiChunk - 1 (components < F) and
// their C weights into buffer `buf`; rows past S and weight columns past
// C - 1 become zeros, so they add nothing. kMultiThreads / kMultiChunk
// threads per support row.
template <int FP>
__device__ __forceinline__ void multi_stage(const float* __restrict__ s,
                                            const float* __restrict__ W,
                                            int c0, int S, int F, int C,
                                            float* smem, int buf) {
  constexpr int kPer = kMultiThreads / kMultiChunk;
  const int j = threadIdx.x / kPer, e = threadIdx.x % kPer;
  float* sb = smem + MultiSmem<FP>::kS + (buf * kMultiChunk + j) * FP;
  float* wb = smem + MultiSmem<FP>::kW + (buf * kMultiChunk + j) * kWStride;
  const bool in = c0 + j < S;
  const size_t g = in ? static_cast<size_t>(c0 + j) : 0;
#pragma unroll
  for (int f = e; f < FP; f += kPer)
    if (f < F) cp_async_f32(sb + f, s + g * F + f, in);
#pragma unroll
  for (int k = e; k < kMaxC; k += kPer)
    cp_async_f32(wb + k, W + g * C + min(k, C - 1), in && k < C);
  cp_async_commit();
}

// Phase B over one chunk: acc[r][i] += Rinv[k][row_r] * Z[k][col_i] for
// the first NI of the thread's 8 columns (NI = 4: the table's first 64
// columns only).
template <int NI>
__device__ __forceinline__ void multi_product(const float* rinv_sh,
                                              const float* z, int tx,
                                              int ty, float (&acc)[8][8]) {
  constexpr int K = kMultiChunk;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* rk = rinv_sh + k * kMultiRows + 4 * ty;
    const float* zk = z + k * kMultiCols + 4 * tx;
    const float4 a0 = *reinterpret_cast<const float4*>(rk);
    const float4 a1 = *reinterpret_cast<const float4*>(rk + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(zk);
    const float4 b1 = NI > 4 ? *reinterpret_cast<const float4*>(zk + 64)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r2 = 0; r2 < 8; ++r2)
#pragma unroll
      for (int i = 0; i < NI; ++i)
        acc[r2][i] = fmaf(av[r2], bv[i], acc[r2][i]);
  }
}

// One pass over all supports for the classes k0 .. min(k0 + CG, C) - 1 of
// the block's rows, whose points are at kX. A narrow pass (a launch whose
// C fits in it) takes CG = kCgNarrow classes and the table's first 64
// columns, a full one CG = Cg and all 128: the product and the per-pair
// scores follow the instance, not a branch in the loops (classes past
// C - 1 read zero weights, and the table's columns past the pass's
// classes are zeros). Returns with the accumulator in registers
// (acc[r][i]: row 64 (r / 4) + 4 ty + r % 4, column 64 (i / 4) + 4 tx +
// i % 4 for tx, ty = tid % 16, tid / 16) and the partial scores in place
// for multi_class_score, all threads synced.
template <int FP, bool kNarrow>
__device__ __forceinline__ void multi_score_pass(
    const float* __restrict__ s, const float* __restrict__ W, int S, int F,
    int C, int k0, float* smem, float (&acc)[8][8]) {
  using L = MultiSmem<FP>;
  constexpr int CG = kNarrow ? L::kCgNarrow : L::kCg;
  constexpr int NCOL = kNarrow ? kMultiCols / 2 : kMultiCols;
  constexpr int K = kMultiChunk;
  constexpr int KH = K / kMultiHalves;   // supports per thread per chunk
  // a row's points stay in registers across the pass below FP = 32 (up to
  // 32 in the narrow instance); wider rows read them from shared memory,
  // so that the accumulator stays resident without a spill. So does the
  // full pass at FP = 16, whose 7 classes' compensated scores beside the
  // points spilled 8 B in B4
  constexpr bool kXRegs = kNarrow ? FP <= 32 : FP < 32 && FP != 16;
  const int tid = threadIdx.x;
  const int row = tid % kMultiRows;
  const int half = tid / kMultiRows;  // warp-uniform
  const int tx = tid % 16, ty = tid / 16;
  // the class-table column this thread builds, fixed for the pass: past
  // the pass's classes it takes the weight at kMaxC, a zero of the tail
  const int zcol = tid % kMultiCols;
  const int zc = zcol / (FP + 1), zf = zcol - zc * (FP + 1);
  const bool zlive = zc < CG && k0 + zc < C;
  const int zw = zlive ? k0 + zc : kMaxC;
  const bool zs = zlive && zf < FP;        // s_jf w_jc, or w_jc itself
  const int zoff = zs ? zf : 0;
  const float4* xrow =
      reinterpret_cast<const float4*>(smem + L::kX + row * FP);
  float* z = smem + L::kZ;
  float* rinv_sh = smem + L::kRinv;

  float sc[CG], comp[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) sc[c] = comp[c] = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;

  const int nch = (S + K - 1) / K;
  __syncthreads();  // the points are in; the last epilogue left the tile
  if (nch > 0) multi_stage<FP>(s, W, 0, S, F, C, smem, 0);
  float xr[kXRegs ? FP : 4];
  if (kXRegs) {
#pragma unroll
    for (int f = 0; f < FP / 4; ++f) {
      const float4 v = xrow[f];
      xr[4 * f] = v.x;
      xr[4 * f + 1] = v.y;
      xr[4 * f + 2] = v.z;
      xr[4 * f + 3] = v.w;
    }
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // chunk ch visible; the last phase B is done
    if (ch + 1 < nch)
      multi_stage<FP>(s, W, (ch + 1) * K, S, F, C, smem, (ch + 1) & 1);
    const float* sb = smem + L::kS + (ch & 1) * K * FP;
    const float* wb = smem + L::kW + (ch & 1) * K * kWStride;
    // the class table of this chunk (the columns phase B reads)
    if (zcol < NCOL) {
      const float* wcol = wb + zw;
      const float* scol = sb + zoff;
      const int j0 = tid / kMultiCols;
#pragma unroll
      for (int i = 0; i < K * kMultiCols / kMultiThreads; ++i) {
        const int j = j0 + i * (kMultiThreads / kMultiCols);
        const float sv = scol[j * FP];
        z[j * kMultiCols + zcol] = wcol[j * kWStride] * (zs ? sv : 1.f);
      }
    }
    // phase A: this thread's half of the chunk against its row
#pragma unroll 2
    for (int jj = 0; jj < KH; ++jj) {
      const int j = half * KH + jj;
      const float4* sj = reinterpret_cast<const float4*>(sb + j * FP);
      float d2a = 0.f, d2b = 0.f;
#pragma unroll
      for (int f = 0; f < FP / 4; ++f) {
        const float4 v = sj[f];
        float4 xv;
        if (kXRegs) {
          xv = make_float4(xr[4 * f], xr[4 * f + 1], xr[4 * f + 2],
                           xr[4 * f + 3]);
        } else {
          xv = xrow[f];
        }
        const float e0 = xv.x - v.x, e1 = xv.y - v.y;
        const float e2 = xv.z - v.z, e3 = xv.w - v.w;
        d2a = fmaf(e0, e0, d2a);
        d2b = fmaf(e1, e1, d2b);
        d2a = fmaf(e2, e2, d2a);
        d2b = fmaf(e3, e3, d2b);
      }
      const float d2 = fmaxf(d2a + d2b, 0.f) + 1e-12f;
      const float rinv = rsqrtf(d2);
      const float r = d2 * rinv;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        two_sum_add(wb[j * kWStride + k0 + c] * r, sc[c], comp[c]);
      rinv_sh[j * kMultiRows + row] = rinv;
    }
    __syncthreads();  // Rinv and Z complete
    // phase B
    multi_product<kNarrow ? 4 : 8>(rinv_sh, z, tx, ty, acc);
  }
  float* part = smem + L::kPart + (half * kMultiRows + row) * L::kCg * 2;
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    part[2 * c] = sc[c];
    part[2 * c + 1] = comp[c];
  }
  __syncthreads();  // the last phase B is done: the tile may go over Z
}

// One pass of the register instance over all supports for the NC = C
// classes of a launch: phase A as in multi_score_pass, with each class's
// su and rowsum summed in registers by each of the row's two threads over
// its half of every chunk. After the last chunk the halves add through
// shared memory, over the class table and Rinv (unused here): row r's
// su_c [FP] and rowsum_c at kTile + r * multi_reg_stride + c (FP + 1)
// (the product's tile layout, all rows at once), and the partial scores
// in place for multi_class_score; returns synced.
template <int FP, int NC>
__device__ __forceinline__ void multi_reg_pass(
    const float* __restrict__ s, const float* __restrict__ W, int S, int F,
    int C, float* smem) {
  using L = MultiSmem<FP>;
  constexpr int K = kMultiChunk;
  constexpr int KH = K / kMultiHalves;   // supports per thread per chunk
  constexpr int N1 = FP + 1;             // su_c, then rowsum_c
  static_assert(NC >= 1 && NC <= L::kCgReg, "register classes");
  const int tid = threadIdx.x;
  const int row = tid % kMultiRows;
  const int half = tid / kMultiRows;  // warp-uniform
  const float4* xrow =
      reinterpret_cast<const float4*>(smem + L::kX + row * FP);

  float sc[NC], comp[NC], acc[NC][N1];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    sc[c] = comp[c] = 0.f;
#pragma unroll
    for (int f = 0; f < N1; ++f) acc[c][f] = 0.f;
  }

  const int nch = (S + K - 1) / K;
  __syncthreads();  // the points are in
  if (nch > 0) multi_stage<FP>(s, W, 0, S, F, C, smem, 0);
  float4 xr[FP / 4];   // the row's points, in registers
#pragma unroll
  for (int f = 0; f < FP / 4; ++f) xr[f] = xrow[f];
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // chunk ch visible; the other buffer's readers done
    if (ch + 1 < nch)
      multi_stage<FP>(s, W, (ch + 1) * K, S, F, C, smem, (ch + 1) & 1);
    const float* sb = smem + L::kS + (ch & 1) * K * FP;
    const float* wb = smem + L::kW + (ch & 1) * K * kWStride;
    // phase A with the sums: this thread's half of the chunk
#pragma unroll 2
    for (int i = 0; i < KH; ++i) {
      const int j = half * KH + i;
      const float4* sj = reinterpret_cast<const float4*>(sb + j * FP);
      float d2a = 0.f, d2b = 0.f;
#pragma unroll
      for (int f = 0; f < FP / 4; ++f) {
        const float4 v = sj[f];
        const float e0 = xr[f].x - v.x, e1 = xr[f].y - v.y;
        const float e2 = xr[f].z - v.z, e3 = xr[f].w - v.w;
        d2a = fmaf(e0, e0, d2a);
        d2b = fmaf(e1, e1, d2b);
        d2a = fmaf(e2, e2, d2a);
        d2b = fmaf(e3, e3, d2b);
      }
      const float d2 = fmaxf(d2a + d2b, 0.f) + 1e-12f;
      const float rinv = rsqrtf(d2);
      const float r = d2 * rinv;
      const float* wj = wb + j * kWStride;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float w = wj[c];
        two_sum_add(w * r, sc[c], comp[c]);
        const float u = w * rinv;
        acc[c][FP] += u;
#pragma unroll
        for (int g = 0; g < FP / 4; ++g) {
          const float4 v = sj[g];
          acc[c][4 * g] = fmaf(v.x, u, acc[c][4 * g]);
          acc[c][4 * g + 1] = fmaf(v.y, u, acc[c][4 * g + 1]);
          acc[c][4 * g + 2] = fmaf(v.z, u, acc[c][4 * g + 2]);
          acc[c][4 * g + 3] = fmaf(v.w, u, acc[c][4 * g + 3]);
        }
      }
    }
  }
  float* part = smem + L::kPart + (half * kMultiRows + row) * L::kCg * 2;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    part[2 * c] = sc[c];
    part[2 * c + 1] = comp[c];
  }
  // the second half's sums, then the first half's added to them
  constexpr int kStride = multi_reg_stride<FP, NC>();
  float* t = smem + L::kTile + row * kStride;
  if (half == 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int f = 0; f < N1; ++f) t[c * N1 + f] = acc[c][f];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int f = 0; f < N1; ++f) t[c * N1 + f] += acc[c][f];
  }
  __syncthreads();
}

// Put rows 64 h .. 64 h + 63 of the accumulator into the tile once its
// last readers are done; synced.
__device__ __forceinline__ void multi_put_tile(const float (&acc)[8][8],
                                               int h, float* tile) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* t = tile + (4 * ty + r) * kTileStride + 4 * tx + i;
      t[0] = acc[4 * h + r][i];
      t[64] = acc[4 * h + r][4 + i];
    }
  __syncthreads();
}
#endif  // __CUDACC__

// Class c's score of block row `row`: the two halves' compensated partial
// sums, added with compensation.
template <int FP>
DIFFCO_HD float multi_class_score(const float* smem, int row, int c) {
  using L = MultiSmem<FP>;
  float sum = 0.f, comp = 0.f;
  for (int h = 0; h < kMultiHalves; ++h) {
    const float* p =
        smem + L::kPart + ((h * kMultiRows + row) * L::kCg + c) * 2;
    two_sum_add(p[0], sum, comp);
    comp += p[1];
  }
  return sum + comp;
}

#ifdef __NVCC__
// The launch code of the block's kernels (host side; the CPU replay
// compiles the device code only). kernel_of(inst, nc) gives the kernel's
// instance for the block instance that the launch rule picks for C
// classes.

// Launches it over B configurations on `st`; the cudaError_t, 0 on success.
template <int FP, class KernelOf, class... Args>
int multi_launch(int B, int C, cudaStream_t st, KernelOf kernel_of,
                 Args... args) {
  return multi_dispatch<FP>(C, [&](auto inst, auto nc) {
    const auto kernel = kernel_of(inst, nc);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MultiSmem<FP>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<(B + kMultiRows - 1) / kMultiRows, kMultiThreads,
             MultiSmem<FP>::kBytes, st>>>(args...);
    return static_cast<int>(cudaGetLastError());
  });
}

// out = {classes per pass, passes for C, dynamic shared bytes per block,
// blocks resident per SM by the runtime's occupancy calculator, instance
// (kInstReg, kInstNarrow, kInstFull)}; a register-instance launch reports
// kCgReg classes per pass (it is built for each C up to that). Returns
// the cudaError_t of the occupancy query.
template <int FP, class KernelOf>
int multi_launch_plan(int C, int* out, KernelOf kernel_of) {
  return multi_dispatch<FP>(C, [&](auto inst, auto nc) {
    constexpr int I = decltype(inst)::value, N = decltype(nc)::value;
    using L = MultiSmem<FP>;
    const auto kernel = kernel_of(inst, nc);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kMultiThreads, L::kBytes);
    const int cg = I == kInstReg ? L::kCgReg
                                 : multi_pass_classes<FP, I, N>();
    out[0] = cg;
    out[1] = (C + cg - 1) / cg;
    out[2] = L::kBytes;
    out[3] = blocks;
    out[4] = I;
    return static_cast<int>(e);
  });
}
#endif  // __NVCC__

}  // namespace diffco
