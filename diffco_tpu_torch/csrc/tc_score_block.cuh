// Tensor-core polyharmonic score block: the score of a block of query
// rows against all supports, with both matrix products of the TPU
// kernels on Hopper's tensor cores. Three kernels run on it: B1
// (dh_score.cu, DH FK + score + dq), B2 (poly_score.cu, point-space score
// + dx) and B3 (chain_score.cu, URDF-chain FK + score + dq); each writes
// its rows' points into the block and reads the sums back.
//
// Replaces, inside each, the score block of the TPU kernel
// (diffco_tpu/ops/fk_score.py::_make_dh_score_kernel,
// _make_chain_score_kernel, fused_score.py::_make_fwdgrad_kernel): the
// cross term s . x^T (fk_score.py:115-118) and the [s w | w]^T . rinv
// product that yields su and rowsum (:129-132), both MXU products there.
//
// A block holds kTcRows = 128 query rows x [FP] (zero-padded past F) and
// kTcThreads = 256 threads, 8 warps of 16 rows. Supports and weights
// stream through shared memory in chunks of kTcChunk = 32, copied with
// cp.async into a double buffer while the last chunk computes, then
// centred and split into fragment order by all threads. Everything
// is translated by one centre c, the mean of the block's rows: d2 and
// x rowsum - su do not change under a common translation, and the
// centred norms stay near d2, which keeps the expanded distance accurate.
// Per (row i, support j), with x~ = x - c, s~ = s - c:
//
//   product 1 (tensor cores):  dot_ij = x~_i . s~_j
//   d2 = |x~_i|^2 + |s~_j|^2 - 2 dot_ij + 1e-12
//        near-pair guard: where d2 < kTcGuard (|x~_i|^2 + |s~_j|^2), d2
//        is recomputed by direct difference from the raw chunk and c in
//        shared memory (+ 1e-12); so d2 >= 0 without a clamp
//   rinv = rsqrt(d2),  r = d2 rinv,  score_i += w_j r   (TwoSum)
//   product 2 (tensor cores):  [su~ | rowsum]_i += sum_j rinv_ij T_j,
//        T_j = [s~_j w_j (F columns) | w_j | 0 ...], its F + 1 columns
//        in n-tiles of 8 (FP / 8 tiles where F < FP, else one more)
//
// after which su = su~ + c rowsum and d score / d x = x rowsum - su
// (= x~ rowsum - su~).
//
// Both products run as mma.sync.m16n8k8 TF32 tiles with fp32
// accumulation, in 3xTF32: each operand a is split into a_hi = tf32(a)
// and a_lo = a - a_hi, and a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// (product 1 sums the three in separate accumulators, which also keeps
// its chains of dependent products short).
// Plain TF32 keeps ~3 decimal digits, too few where fitted weights
// cancel (sum_j |w_j| r_j ~ 7.5e3 against |score| ~ 1.5). With
// per-chunk sums (every kernel on the block) product
// 2 accumulates each chunk on the tensor cores into a fresh accumulator,
// added to the rows' running sums on the CUDA cores after the chunk: one
// accumulator over all S supports lost ~8x more of the gradient (the
// tensor cores' fp32 accumulation rounds less well than an fp32 add; dq
// 8.7e-4 against 7.9e-5 on the fitted FrankaPanda sweep, S = 896,
// PERF.md section 6).
// Where a second accumulator in registers would spill, kTcSumsShared
// keeps the running sums in shared memory instead (each lane its own
// slots, added to after each chunk: B1 at FP = 24, dh_score.cu; B2 at FP
// = 56 and 64 and B3 at 64, kTcPointSums).
// |x~|^2 is formed in double and kept as hi + lo floats, because its
// rounding would enter every pair of the row alike. The score stays on
// the CUDA cores, compensated per thread and merged with compensation
// across the four lanes that share a row.
//
// Fragments (PTX m16n8k8 .tf32; lane = 4 g + t): A a0..a3 at (row, k) =
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 at (k, n) =
// (t, g), (t + 4, g); C c0..c3 at (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). Product 1's accumulator gives each lane rinv for
// supports 2t and 2t + 1 of its n-tile: product 2 takes them as its A
// fragment (k = t for support 2t, k = t + 4 for 2t + 1), and its B
// operand is stored with the same order of the supports within each k-step
// of 8, so no shuffle is needed (a sum over supports does not care about
// their order). Each chunk is stored pre-split in fragment order (one
// float4 per lane per k-step: no bank conflicts), beside (|s~_j|^2, w_j).
// A lane takes two n-tiles of 8 supports per pass of its loop (one on
// rows wider than kTcRegMaxFP), so that their products and pair work
// interleave.
//
// Budget: 256 threads, __launch_bounds__(256, kTcBlocksPerSM = 2), at
// most 128 registers a thread, and 15-84 KB of dynamic shared memory at
// FP = 8-64 (TcSmem<FP>::kBytes; B1 adds 25 KB for its rows' joint axes,
// B3 (6M + 1) floats a row for its joints' axes and origins): two
// blocks, 16 warps, per SM wherever the caller's share fits. x~'s
// fragments stay in registers up to kTcRegMaxFP components
// (kTcChunkRegMaxFP with kChunkSums); wider rows split them from shared
// memory at each use.
//
// Ragged ends: supports past S and components past F are zeros with
// weight 0 (they add nothing, and no value the staging did not write
// reaches an output); rows past B are the caller's (B1 and B3 run them on
// q = 0, B2 on copies of row B - 1, so that the centre stays on the
// data) and masked by it.
//
// Hooks for the roofline path's kernels (B6, dh_dual_score.cu; B7,
// dh_ablation.cu), whose defaults are the production block above: the
// stage the block stops after (kStage: B7's rungs), product 2's type
// (kP2: B7's bf16 rung) and how its threads meet (Sync: B6's dual_pipe
// runs the block on its tensor-core warps alone, beside a warpgroup that
// runs the FK).
#pragma once

#include <cstring>

#include "cp_async.cuh"
#include "score_block.cuh"

namespace diffco {

constexpr int kTcRows = 128;       // query rows per block
constexpr int kTcThreads = 256;    // 8 warps x 16 rows
constexpr int kTcChunk = 32;       // supports per staged chunk (4 n-tiles)
constexpr int kTcBlocksPerSM = 512 / kTcThreads;  // 16 warps per SM
constexpr int kTcRegMaxFP = 32;    // x~ fragments in registers up to here
// Product 2 by chunks (kChunkSums) with the running sums in registers up
// to kTcChunkMaxFP components, where its second accumulator fits the 128
// registers unspilled (ptxas on the H100: FP = 56 and 64 spill 12-24 B),
// with x~'s fragments in registers up to kTcChunkRegMaxFP (FP = 32 with
// them in registers spills 64-88 B).
constexpr int kTcChunkMaxFP = 48;
constexpr int kTcChunkRegMaxFP = 24;
// How product 2 sums over the supports (tc_score_block's kSums): one
// accumulator over all of them; a fresh one per chunk added to the
// running sums in registers after it (kChunkSums above); or a fresh one
// per chunk added to running sums in shared memory (4 NT2 floats a
// thread, TcSmem<FP>::kRunFloats, the caller's), for kernels whose
// registers cannot hold the second accumulator.
constexpr int kTcSumsOne = 0;
constexpr int kTcSumsRegs = 1;
constexpr int kTcSumsShared = 2;
// B2's and B3's kSums at FP: per-chunk sums in registers up to
// kRegsMaxFP, the widest FP at which the kernel keeps within 128
// registers unspilled (B2: kTcChunkMaxFP; B3: 56), past it per-chunk
// sums whose running sums are in shared memory (kTcWideSums), which the
// card timed faster than registers that spill. One accumulator over all
// supports took dq and dx past 1e-3 of the float64 twin on fitted
// proxies of the marked rope (FP = 56, 64) at S = 4096 and 8192 (PERF.md
// section 6).
constexpr int kTcWideSums = kTcSumsShared;
template <int FP, int kRegsMaxFP>
constexpr int kTcPointSums = FP <= kRegsMaxFP ? kTcSumsRegs : kTcWideSums;
// The design's parts (scripts/ab_kernel.py's ablations replace these
// lines in a copy): product 1 on the tensor cores (false: every d2 by
// direct difference), 3 products per split (1: plain TF32), and the
// guard's threshold kappa.
constexpr bool kTcDist = true;
constexpr int kTcSplit = 3;
// kappa: below kTcGuard (|x~|^2 + |s~|^2) the expanded d2 has lost more
// than ~1/kappa of its relative precision to cancellation. Chosen from
// the fitted PandaFK sweep on the H100 (PERF.md, section 6).
constexpr float kTcGuard = 1.f / 64.f;
// The stage tc_score_block stops after (kStage), each a prefix of the
// next; what it leaves at kScore + row:
constexpr int kTcStageDot = 0;    // product 1 alone: sum_j s_j . x
constexpr int kTcStageRsqrt = 1;  // + d2 (guarded), rsqrt: sum_j (r + 1/r)
constexpr int kTcStageScore = 2;  // + the score; product 2 not run
constexpr int kTcStageFull = 3;   // + product 2: the sums at kSu too
// Product 2's operands (kP2): 3xTF32 on the centred [s~ w | w]; or one
// mma.sync.m16n8k16 bf16 product of bf16(rinv) and the uncentred
// bf16([s w | w]) with fp32 accumulation, and the score's r and w
// rounded to bf16 (its sums then in the rows' own frame: no c rowsum to
// add back)
constexpr int kTcP2Tf32x3 = 0;
constexpr int kTcP2Bf16 = 1;

// Named barrier `ID` of `COUNT` threads: bar.sync waits, bar.arrive
// does not (barrier 0 is __syncthreads())
template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
#elif defined(DIFFCO_REPLAY)
  diffco_replay_bar(ID, COUNT, true);
#endif
}

template <int ID, int COUNT>
__device__ __forceinline__ void named_arrive() {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
#elif defined(DIFFCO_REPLAY)
  diffco_replay_bar(ID, COUNT, false);
#endif
}

// How tc_score_block's threads meet (Sync): the whole block, or only
// threads 0 .. kTcThreads - 1 of a larger one (named barrier 1)
struct TcSyncBlock {
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};
struct TcSyncGroup {
  static __device__ __forceinline__ void sync() {
    named_sync<1, kTcThreads>();
  }
};

// Dynamic shared memory, in floats (every offset a multiple of 4).
template <int FP>
struct TcSmem {
  static constexpr int kKK = FP / 8;       // k-steps of product 1
  static constexpr int kNT2 = FP / 8 + 1;  // n-tiles of product 2, at most
  static constexpr int kXS = FP + 1;       // point row stride, odd
  static constexpr int kSuS = FP + 9;      // sums row stride, odd
  static constexpr int kCen = 0;                         // c [FP]
  static constexpr int kNx = kCen + FP;                  // [128][2]
  static constexpr int kX = kNx + 2 * kTcRows;           // x~ [128][kXS]
  static constexpr int kArea = kX + kTcRows * kXS;
  // the chunk buffers
  static constexpr int kRawS = kArea;                    // [2][K][FP]
  static constexpr int kRawW = kRawS + 2 * kTcChunk * FP;       // [2][K]
  static constexpr int kB1 = kRawW + 2 * kTcChunk;      // [K/8][KK][32][4]
  static constexpr int kB2 = kB1 + kTcChunk * 2 * FP;    // [K/8][NT2][32][4]
  static constexpr int kNw = kB2 + kTcChunk * 2 * (FP + 8);     // [K][2]
  static constexpr int kLoopEnd = kNw + 2 * kTcChunk;
  // after the last chunk, over the chunk buffers
  static constexpr int kSu = kArea;                      // [128][kSuS]
  static constexpr int kScore = kSu + kTcRows * kSuS;    // [128]
  static constexpr int kEnd = kScore + kTcRows;
  static constexpr int kFloats = kLoopEnd > kEnd ? kLoopEnd : kEnd;
  static constexpr int kBytes = 4 * kFloats;
  // kTcSumsShared's running sums: [NT2][4][kTcThreads], outside the block
  static constexpr int kRunFloats = 4 * kNT2 * kTcThreads;
};

// The running sums' floats that a kernel with product-2 sums kSums adds
// to the block's shared memory
template <int FP, int kSums>
constexpr int kTcRunFloats =
    kSums == kTcSumsShared ? TcSmem<FP>::kRunFloats : 0;

__device__ __forceinline__ float bits_float(unsigned u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float v;
  std::memcpy(&v, &u, 4);
  return v;
#endif
}

__device__ __forceinline__ unsigned float_bits(float v) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(v);
#else
  unsigned u;
  std::memcpy(&u, &v, 4);
  return u;
#endif
}

// (hi, lo) with hi = v rounded to TF32 (10 mantissa bits, to nearest,
// ties away: half an ulp added, the 13 low bits cleared) and lo = v - hi
// (exact). The tensor cores read the 19 high bits of an operand, so lo
// enters a product cut to TF32: 2^-11 of lo, ~2^-22 of v, is lost.
// Two integer operations and a subtraction, for finite v.
__device__ __forceinline__ float2 tf32_split(float v) {
  const float hi = bits_float((float_bits(v) + 0x1000u) & 0xffffe000u);
  return make_float2(hi, v - hi);
}

// d += A B for one m16n8k8 TF32 tile (fragments as above)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif defined(DIFFCO_REPLAY)
  diffco_replay_mma(d, a, b0, b1);
#endif
}

// d += A B in 3xTF32: the large product into d, the two small ones into
// s1 and s2 (product 1 keeps three accumulators, so that its three
// chains of products run side by side; product 2 passes one three times);
// b = (b0 hi, b1 hi, b0 lo, b1 lo) as stored in a chunk (each operand
// pair in adjacent registers, as the instruction takes it)
__device__ __forceinline__ void mma_split(float (&d)[4], float (&s1)[4],
                                          float (&s2)[4],
                                          const unsigned (&ahi)[4],
                                          const unsigned (&alo)[4],
                                          float4 b) {
  if (kTcSplit == 3) {
    mma_tf32(s1, alo, float_bits(b.x), float_bits(b.y));
    mma_tf32(s2, ahi, float_bits(b.z), float_bits(b.w));
  }
  mma_tf32(d, ahi, float_bits(b.x), float_bits(b.y));
}

// v rounded to bf16 (to nearest even, for finite v) in the low 16 bits
__device__ __forceinline__ unsigned bf16_bits(float v) {
  const unsigned u = float_bits(v);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float bf16_round(float v) {
  return bits_float(bf16_bits(v) << 16);
}

// bf16(lo) in the low half, bf16(hi) in the high half: an mma operand
// register holding two consecutive k (the lower k in the low half)
__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
#if defined(__CUDA_ARCH__)
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
#else
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
#endif
}

// d += A B for one m16n8k16 bf16 tile, fp32 accumulation. Fragments (PTX
// .bf16; lane = 4 g + t): A a0..a3 at (row, k) = (g, 2t..2t+1),
// (g + 8, 2t..2t+1), (g, 2t+8..2t+9), (g + 8, 2t+8..2t+9); B b0, b1 at
// (k, n) = (2t..2t+1, g), (2t+8..2t+9, g); C as m16n8k8's
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], uint2 b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
#elif defined(DIFFCO_REPLAY)
  diffco_replay_mma_bf16(d, a, b.x, b.y);
#endif
}

__device__ __forceinline__ float shfl_xor(float v, int mask) {
#if defined(__CUDA_ARCH__)
  return __shfl_xor_sync(0xffffffffu, v, mask);
#elif defined(DIFFCO_REPLAY)
  return diffco_replay_shfl_xor(v, mask);
#else
  return v;
#endif
}

// sum_f (x~_f - (s_f - c_f))^2 over FP components (zeros past F in all
// three)
template <int FP>
__device__ __forceinline__ float tc_direct(const float* x, const float* s,
                                           const float* c) {
  float d2 = 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    const float d = x[f] - (s[f] - c[f]);
    d2 = fmaf(d, d, d2);
  }
  return d2;
}

// 1 / sqrt(v) for v >= 1e-12: the special function unit's approximation
// (MUFU.RSQ) without the scaling rsqrtf adds for subnormal arguments
__device__ __forceinline__ float tc_rsqrt(float v) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
#else
  return rsqrtf(v);
#endif
}

// The guard's recomputation. Out of line where x~'s fragments stay in
// registers: it is rarely taken, and a call keeps the support loop's code
// and registers those of the common path. Inline on wider rows, where
// the registers a call saves would spill.
template <int FP>
__device__ __noinline__ float tc_direct_call(const float* x, const float* s,
                                             const float* c) {
  return tc_direct<FP>(x, s, c);
}

template <int FP>
__device__ __forceinline__ float tc_guard(const float* x, const float* s,
                                          const float* c) {
  if constexpr (FP <= kTcRegMaxFP)
    return tc_direct_call<FP>(x, s, c);
  else
    return tc_direct<FP>(x, s, c);
}

// The staging's share of a thread: support j = tid / 8 of the chunk,
// components e + 8m (m < FP / 8) for e = tid % 8 (kTcThreads = 8 kTcChunk)
static_assert(kTcThreads == 8 * kTcChunk, "staging map");

// Start copying supports c0 .. c0 + kTcChunk - 1 (components < F) and
// their weights into raw buffer `buf`; rows past S become zeros.
template <int FP>
__device__ __forceinline__ void tc_stage(const float* __restrict__ s,
                                         const float* __restrict__ w, int c0,
                                         int S, int F, float* smem, int buf) {
  using L = TcSmem<FP>;
  const int j = threadIdx.x / 8, e = threadIdx.x % 8;
  const bool in = c0 + j < S;
  const float* src = s + static_cast<size_t>(in ? c0 + j : 0) * F;
  float* sb = smem + L::kRawS + (buf * kTcChunk + j) * FP;
#pragma unroll
  for (int m = 0; m < L::kKK; ++m)
    if (e + 8 * m < F) cp_async_f32(sb + e + 8 * m, src + e + 8 * m, in);
  if (threadIdx.x < kTcChunk) {
    const int j = threadIdx.x;
    const bool in = c0 + j < S;
    cp_async_f32(smem + L::kRawW + buf * kTcChunk + j, w + (in ? c0 + j : 0),
                 in);
  }
  cp_async_commit();
}

// a split value into its B fragment slot: hi there, lo two floats on
__device__ __forceinline__ void tc_put(float* p, float2 hl) {
  p[0] = hl.x;
  p[2] = hl.y;
}

// Centre and split raw buffer `buf` (n live supports) into the chunk's
// stores: product 1's and product 2's B fragments, (|s~|^2, w).
// Every thread takes part (its share as tc_stage's); callers sync before
// and after. kStage and kP2 as tc_score_block's: before kTcStageFull
// product 2's fragments are not stored; kTcStageDot adds each s~ to the
// thread's sums over its supports, ssum[m] for component e + 8m; with
// kTcP2Bf16 product 2's fragments are the bf16 ones (tc_score_block) and
// w_j is stored rounded to bf16.
template <int FP, int kStage = kTcStageFull, int kP2 = kTcP2Tf32x3>
__device__ __forceinline__ void tc_transform(float* smem, int buf, int n,
                                             int F, float* ssum = nullptr) {
  using L = TcSmem<FP>;
  constexpr bool kP2Tf32 = kStage == kTcStageFull && kP2 == kTcP2Tf32x3;
  constexpr bool kP2Bf16 = kStage == kTcStageFull && kP2 == kTcP2Bf16;
  const int j = threadIdx.x / 8, e = threadIdx.x % 8;
  const bool in = j < n;
  const float* sb = smem + L::kRawS + (buf * kTcChunk + j) * FP;
  const float wj = in ? smem[L::kRawW + buf * kTcChunk + j] : 0.f;
  // product 1: support j = 8 tile + g is n = g, component 8m + e is k = e
  // (b0) or e - 4 (b1) of lane 4g + e % 4; product 2: support j = 8 tile
  // + 2t + h is k = t (b0, h = 0) or t + 4 (b1) of lane 4 (column % 8) + t
  float* b1 = smem + L::kB1 + ((j / 8) * L::kKK * 32 + 4 * (j % 8) + e % 4) *
                                  4 + e / 4;
  float* b2 = smem + L::kB2 + ((j / 8) * L::kNT2 * 32 + 4 * e + (j % 8) / 2) *
                                  4 + j % 2;
  // the bf16 product 2: support j = 16 p + 8 h + 2t + i is k = 2t + i + 8h
  // of the p-th pair of n-tiles, i.e. half i of register h of lane
  // 4 (column % 8) + t
  unsigned short* b2h = reinterpret_cast<unsigned short*>(smem + L::kB2) +
                        (((j / 16) * L::kNT2 * 32 + 4 * e + (j % 8) / 2) * 2 +
                         (j / 8) % 2) * 2 + j % 2;
  float ns = 0.f;
#pragma unroll
  for (int m = 0; m < L::kKK; ++m) {
    const int f = e + 8 * m;
    const float v = in && f < F ? sb[f] - smem[L::kCen + f] : 0.f;
    ns = fmaf(v, v, ns);
    tc_put(b1 + m * 128, tf32_split(v));
    if constexpr (kStage == kTcStageDot) ssum[m] += v;
    if constexpr (kP2Tf32)
      tc_put(b2 + m * 128, tf32_split(f == F ? wj : v * wj));
    if constexpr (kP2Bf16)   // uncentred: s_j w_j
      b2h[m * 128] = bf16_bits(f == F ? wj : in && f < F ? sb[f] * wj : 0.f);
  }
  // product 2's last column tile, used where F = FP: w_j at column FP
  if constexpr (kP2Tf32)
    tc_put(b2 + L::kKK * 128, tf32_split(e == 0 && F == FP ? wj : 0.f));
  if constexpr (kP2Bf16)
    b2h[L::kKK * 128] = bf16_bits(e == 0 && F == FP ? wj : 0.f);
  ns += shfl_xor(ns, 1);
  ns += shfl_xor(ns, 2);
  ns += shfl_xor(ns, 4);
  if (e == 0) {
    smem[L::kNw + 2 * j] = ns;
    smem[L::kNw + 2 * j + 1] = kP2Bf16 ? bf16_round(wj) : wj;
  }
}

// tf32_split of four values, as mma operand bits
__device__ __forceinline__ void tf32_split_bits(const float (&v)[4],
                                                unsigned (&hi)[4],
                                                unsigned (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 hl = tf32_split(v[i]);
    hi[i] = float_bits(hl.x);
    lo[i] = float_bits(hl.y);
  }
}

// x~'s A fragment of k-step kk for rows r0, r0 + 8 (lane's t), split
template <int FP>
__device__ __forceinline__ void tc_x_fragment(const float* xs, int r0, int t,
                                              int kk, unsigned (&hi)[4],
                                              unsigned (&lo)[4]) {
  constexpr int S_ = TcSmem<FP>::kXS;
  const float v[4] = {xs[r0 * S_ + 8 * kk + t], xs[(r0 + 8) * S_ + 8 * kk + t],
                      xs[r0 * S_ + 8 * kk + t + 4],
                      xs[(r0 + 8) * S_ + 8 * kk + t + 4]};
  tf32_split_bits(v, hi, lo);
}

// The score of the block's rows against supports s [S, F] with weights
// w [S]. On entry the caller has written each row's points x [FP]
// (zeros past F) to TcSmem<FP>::kX + row kXS, and has started chunk 0
// with tc_stage(s, w, 0, S, F, smem, 0) if S > 0; every thread calls.
// On return (all threads synced) row i's score is at kScore + i and its
// sums at kSu + i kSuS (su~ at f < F, rowsum at F): tc_row_sums reads
// them. kMeasure counts the guard's recomputations into *guard_pairs,
// with kappa in place of kTcGuard (a measurement build only).
// kSums: how product 2 sums over the chunks (kTcSumsOne, kTcSumsRegs,
// kTcSumsShared). With kTcSumsRegs x~'s fragments stay in registers only
// up to kTcChunkRegMaxFP components, for the registers the second
// accumulator takes; kTcSumsShared keeps the running sums at `run`
// (TcSmem<FP>::kRunFloats floats of shared memory, outside the block's).
// kStage, kP2 and Sync: the hooks of the file comment. Before
// kTcStageFull kScore + i holds the stage's sum (kTcStageDot: sum_j s_j .
// x_i, from the centred products as sum_j s~_j . x~_i + c . sum_j s~_j +
// S c . x~_i + S |c|^2) and kSu is not written; with kTcP2Bf16 the sums
// at kSu are su (not su~) and rowsum. Only threads 0 .. kTcThreads - 1
// call, and Sync is how they meet.
template <int FP, bool kMeasure, int kSums = kTcSumsOne,
          int kStage = kTcStageFull, int kP2 = kTcP2Tf32x3,
          class Sync = TcSyncBlock>
__device__ __forceinline__ void tc_score_block(
    const float* __restrict__ s, const float* __restrict__ w, int S, int F,
    float* smem, float kappa, unsigned long long* guard_pairs,
    float* run = nullptr) {
  using L = TcSmem<FP>;
  constexpr int K = kTcChunk;
  constexpr int KK = L::kKK, NT2 = L::kNT2;
  constexpr bool kFull = kStage == kTcStageFull;
  constexpr bool kBf16 = kP2 == kTcP2Bf16;
  constexpr bool kChunkSums = kSums == kTcSumsRegs && kFull;
  constexpr bool kRunShared = kSums == kTcSumsShared && kFull;
  constexpr bool kXRegs =
      FP <= (kChunkSums ? kTcChunkRegMaxFP : kTcRegMaxFP);
  // two n-tiles per pass of the support loop where x~'s fragments stay in
  // registers (their products and pair work interleave); one on wider
  // rows, which would spill; all four with the bf16 product 2, whose k =
  // 16 fragment takes the rinv of two n-tiles
  constexpr int kUnroll = kBf16 ? K / 8 : kXRegs ? 2 : 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;  // and r0 + 8
  float* xs = smem + L::kX;
  if (!kMeasure) kappa = kTcGuard;
  // the raw buffers' components F..FP-1, which the staging never writes
  for (int i = tid; i < 2 * K * FP; i += kTcThreads)
    if (i % FP >= F) smem[L::kRawS + i] = 0.f;

  // the centre: the mean of the block's rows
  Sync::sync();
  // eight lanes per component, 16 rows each, then summed across them
  for (int f = tid / 8; f < (FP + 31) / 32 * 32; f += kTcThreads / 8) {
    float acc = 0.f;
    if (f < FP)
#pragma unroll 4
      for (int r = tid % 8; r < kTcRows; r += 8) acc += xs[r * L::kXS + f];
    acc += shfl_xor(acc, 1);
    acc += shfl_xor(acc, 2);
    acc += shfl_xor(acc, 4);
    if (f < FP && tid % 8 == 0) smem[L::kCen + f] = acc * (1.f / kTcRows);
  }
  Sync::sync();
  if (tid < kTcRows) {
    double nx = 0.0;
#pragma unroll 4
    for (int f = 0; f < FP; ++f) {
      const float v = xs[tid * L::kXS + f] - smem[L::kCen + f];
      xs[tid * L::kXS + f] = v;
      nx += static_cast<double>(v) * v;
    }
    const float hi = static_cast<float>(nx);
    smem[L::kNx + 2 * tid] = hi;
    smem[L::kNx + 2 * tid + 1] = static_cast<float>(nx - hi);
  }
  Sync::sync();

  unsigned ahi[kXRegs ? KK : 1][4], alo[kXRegs ? KK : 1][4];
  if constexpr (kTcDist && kXRegs) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      tc_x_fragment<FP>(xs, r0, t, kk, ahi[kk], alo[kk]);
  }
  const float nxh[2] = {smem[L::kNx + 2 * r0], smem[L::kNx + 2 * r0 + 16]};
  // the low part of |x~|^2 carries the 1e-12 floor
  const float nxl[2] = {smem[L::kNx + 2 * r0 + 1] + 1e-12f,
                        smem[L::kNx + 2 * r0 + 17] + 1e-12f};
  const int nt2 = (F + 8) / 8;  // product 2's column tiles (F + 1 columns)
  float sc[2] = {0.f, 0.f}, cc[2] = {0.f, 0.f};
  float ssum[kStage == kTcStageDot ? KK : 1] = {};  // sum_j s~_j (Dot)
  float acc[NT2][4];
#pragma unroll
  for (int n2 = 0; n2 < NT2; ++n2)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[n2][i] = 0.f;
      if constexpr (kRunShared) run[(4 * n2 + i) * kTcThreads + tid] = 0.f;
    }

  const float4* b1s = reinterpret_cast<const float4*>(smem + L::kB1);
  const float4* b2s = reinterpret_cast<const float4*>(smem + L::kB2);
  const uint2* b2h = reinterpret_cast<const uint2*>(smem + L::kB2);
  const int nch = (S + K - 1) / K;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_all();
    Sync::sync();  // chunk ch landed; the last chunk's reads are done
    if (ch + 1 < nch)
      tc_stage<FP>(s, w, (ch + 1) * K, S, F, smem, (ch + 1) & 1);
    tc_transform<FP, kStage, kP2>(smem, ch & 1, min(K, S - ch * K), F,
                                  ssum);
    Sync::sync();
    // the chunk's raw supports, for the direct differences
    const float* raw = smem + L::kRawS + (ch & 1) * K * FP;
    // product 2 of this chunk, added to acc after it (kChunkSums)
    float part[NT2][4];
    if constexpr (kChunkSums) {
#pragma unroll
      for (int n2 = 0; n2 < NT2; ++n2)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n2][i] = 0.f;
    }
    unsigned a16[4];  // the bf16 product 2's A fragment (two n-tiles)
#pragma unroll (kUnroll)
    for (int nt = 0; nt < K / 8; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, ds[4] = {0.f, 0.f, 0.f, 0.f},
            dt[4] = {0.f, 0.f, 0.f, 0.f};
      if (kTcDist) {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const float4 b = b1s[(nt * KK + kk) * 32 + lane];
          if constexpr (kXRegs) {
            mma_split(d, ds, dt, ahi[kk], alo[kk], b);
          } else {
            unsigned h[4], l[4];
            tc_x_fragment<FP>(xs, r0, t, kk, h, l);
            mma_split(d, ds, dt, h, l, b);
          }
        }
      }
      if constexpr (kStage == kTcStageDot) {  // the rows' x~ . s~ sums
        two_sum_add((d[0] + (ds[0] + dt[0])) + (d[1] + (ds[1] + dt[1])),
                    sc[0], cc[0]);
        two_sum_add((d[2] + (ds[2] + dt[2])) + (d[3] + (ds[3] + dt[3])),
                    sc[1], cc[1]);
        continue;
      }
      // (|s~|^2, w) of supports 2t and 2t + 1 of the n-tile
      const float4 nw = *reinterpret_cast<const float4*>(
          smem + L::kNw + 2 * (8 * nt + 2 * t));
      const float nsv[2] = {nw.x, nw.z}, wv[2] = {nw.y, nw.w};
      float d2[4], ri[4], r[4];  // pairs (r0, 2t), (r0, 2t + 1), (r0 + 8, 2t)..
      if (kTcDist) {
        float norms[4], slack[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          norms[p] = nxh[p >> 1] + nsv[p & 1];
          d2[p] = fmaf(-2.f, d[p] + (ds[p] + dt[p]), norms[p]) + nxl[p >> 1];
          slack[p] = fmaf(-kappa, norms[p], d2[p]);
        }
        if (fminf(fminf(slack[0], slack[1]), fminf(slack[2], slack[3])) <
            0.f) {  // rare: some pair below the guard's threshold
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (d2[p] < kappa * norms[p]) {
              d2[p] = tc_guard<FP>(xs + (r0 + 8 * (p >> 1)) * L::kXS,
                                   raw + (8 * nt + 2 * t + (p & 1)) * FP,
                                   smem + L::kCen) +
                      1e-12f;
              if constexpr (kMeasure) atomicAdd(guard_pairs, 1ull);
            }
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          d2[p] = tc_direct<FP>(xs + (r0 + 8 * (p >> 1)) * L::kXS,
                                raw + (8 * nt + 2 * t + (p & 1)) * FP,
                                smem + L::kCen) +
                  1e-12f;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        ri[p] = tc_rsqrt(d2[p]);
        r[p] = d2[p] * ri[p];
      }
      if constexpr (kStage == kTcStageRsqrt) {  // live supports only
        const int j = ch * K + 8 * nt + 2 * t;
        const float l0 = j < S ? 1.f : 0.f, l1 = j + 1 < S ? 1.f : 0.f;
        two_sum_add(fmaf(l1, r[1] + ri[1], l0 * (r[0] + ri[0])), sc[0],
                    cc[0]);
        two_sum_add(fmaf(l1, r[3] + ri[3], l0 * (r[2] + ri[2])), sc[1],
                    cc[1]);
        continue;
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int p = 0; p < 4; ++p) r[p] = bf16_round(r[p]);
      }
      // a row's two terms summed, then added with compensation
      two_sum_add(fmaf(wv[1], r[1], wv[0] * r[0]), sc[0], cc[0]);
      two_sum_add(fmaf(wv[1], r[3], wv[0] * r[2]), sc[1], cc[1]);
      if constexpr (kFull && kBf16) {
        // the even n-tile's supports 2t, 2t + 1 are k = 2t, 2t + 1 of the
        // k = 16 fragment, the odd one's k = 2t + 8, 2t + 9
        a16[2 * (nt & 1)] = bf16_pack(ri[0], ri[1]);      // row r0
        a16[2 * (nt & 1) + 1] = bf16_pack(ri[2], ri[3]);  // row r0 + 8
        if (nt & 1) {
          __syncwarp();
#pragma unroll
          for (int n2 = 0; n2 < NT2; ++n2) {
            float(&sums)[4] = kChunkSums ? part[n2] : acc[n2];
            if (n2 < nt2) {
              mma_bf16(sums, a16, b2h[((nt / 2) * NT2 + n2) * 32 + lane]);
            }
          }
        }
      } else if constexpr (kFull) {
        // product 2's A fragment: (g, k = t) support 2t, (g, t + 4) 2t + 1
        unsigned hi[4], lo[4];
        tf32_split_bits({ri[0], ri[2], ri[1], ri[3]}, hi, lo);
        __syncwarp();
#pragma unroll
        for (int n2 = 0; n2 < NT2; ++n2) {
          float(&sums)[4] = kChunkSums ? part[n2] : acc[n2];
          if (n2 < nt2)
            mma_split(sums, sums, sums, hi, lo,
                      b2s[(nt * NT2 + n2) * 32 + lane]);
        }
      }
    }
    if constexpr (kChunkSums) {
#pragma unroll
      for (int n2 = 0; n2 < NT2; ++n2)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n2][i] += part[n2][i];
    }
    if constexpr (kRunShared) {  // acc held this chunk's sums alone
#pragma unroll
      for (int n2 = 0; n2 < NT2; ++n2)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          run[(4 * n2 + i) * kTcThreads + tid] += acc[n2][i];
          acc[n2][i] = 0.f;
        }
    }
  }
  if constexpr (kRunShared) {
#pragma unroll
    for (int n2 = 0; n2 < NT2; ++n2)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[n2][i] = run[(4 * n2 + i) * kTcThreads + tid];
  }

  // the four lanes of a row merge their compensated scores
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int m = 1; m <= 2; m *= 2) {
      const float so = shfl_xor(sc[rr], m), co = shfl_xor(cc[rr], m);
      two_sum_add(so, sc[rr], cc[rr]);
      cc[rr] += co;
    }
  if constexpr (kStage == kTcStageDot) {
    // sum_j s~_j: over the lanes of a warp that share e = lane % 8
#pragma unroll
    for (int m = 0; m < KK; ++m) {
      ssum[m] += shfl_xor(ssum[m], 8);
      ssum[m] += shfl_xor(ssum[m], 16);
    }
  }
  Sync::sync();  // every warp is done with the chunk buffers
  float* su = smem + L::kSu;
  if constexpr (kFull) {
#pragma unroll
    for (int n2 = 0; n2 < NT2; ++n2) {
      const int col = 8 * n2 + 2 * t;
      su[r0 * L::kSuS + col] = acc[n2][0];
      su[r0 * L::kSuS + col + 1] = acc[n2][1];
      su[(r0 + 8) * L::kSuS + col] = acc[n2][2];
      su[(r0 + 8) * L::kSuS + col + 1] = acc[n2][3];
    }
  }
  if constexpr (kStage == kTcStageDot) {  // each warp's sums, [8][FP]
    if (lane < 8)
#pragma unroll
      for (int m = 0; m < KK; ++m) su[warp * FP + lane + 8 * m] = ssum[m];
  }
  if (t == 0) {
    smem[L::kScore + r0] = sc[0] + cc[0];
    smem[L::kScore + r0 + 8] = sc[1] + cc[1];
  }
  Sync::sync();
  if constexpr (kStage == kTcStageDot) {
    if (tid < kTcRows) {
      float cs = 0.f, cx = 0.f, c2 = 0.f;
#pragma unroll 4
      for (int f = 0; f < FP; ++f) {
        float sf = 0.f;
#pragma unroll
        for (int i = 0; i < kTcThreads / 32; ++i) sf += su[i * FP + f];
        const float c = smem[L::kCen + f];
        cs = fmaf(c, sf, cs);
        cx = fmaf(c, xs[tid * L::kXS + f], cx);
        c2 = fmaf(c, c, c2);
      }
      smem[L::kScore + tid] += cs + static_cast<float>(S) * (cx + c2);
    }
    Sync::sync();
  }
}

// Row `row`'s sums after tc_score_block, turned in place into the rows'
// own frame (su = su~ + c rowsum at f < F): returns them, su then rowsum
// at F, in shared memory.
template <int FP>
__device__ __forceinline__ float* tc_row_sums(float* smem, int row, int F) {
  using L = TcSmem<FP>;
  float* r = smem + L::kSu + row * L::kSuS;
  const float rowsum = r[F];
#pragma unroll
  for (int f = 0; f < FP; ++f)
    if (f < F) r[f] = fmaf(smem[L::kCen + f], rowsum, r[f]);
  return r;
}

}  // namespace diffco
