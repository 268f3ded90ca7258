// The greedy kernel-perceptron trainer over a dense Gram (perceptron.py::
// _train_columns: the min-margin update or the redundant-support removal
// of every label column, iteration after iteration) as one persistent
// kernel: every iteration, until each column is done or max_iteration
// iterations ran, in a single launch.
//
// Replaces no TPU kernel. The JAX package runs the loop as a
// lax.while_loop that XLA compiles into one device loop; the port's eager
// loop launched ~63 PyTorch kernels an iteration (argmin, argmax, a dozen
// where / mul / sub, index_put with its _assert_async, the Gram row's
// gather and axpy), each over a vector of ~820-9000 floats, and spent
// ~1 ms of host dispatch an iteration: 92-93 % of a proxy update.
//
// What bounds it on this card: neither bytes nor operations. An iteration
// reads one Gram row (4N bytes) and does ~12N operations: at N = 4500,
// 18 KB and 54 kFLOP, ~5 ns at 3.35 TB/s. What is left is latency: one
// block reduction and the dependent read of the picked row, a few
// microseconds an iteration.
//
// Design: one block of kGreedyThreads threads a label column (grid = C).
// Thread t holds rows t, t + T, ... (R of them, R = 1, 2, 4, 8 or 16 by
// N): their hypotheses in registers and their validity as a bit mask; the
// labels, the Gram's diagonal and the gains lie in shared memory (12 N
// bytes). An iteration is one fused block reduction (warp shuffles, then
// warp 0 over the warps' results) of the min-margin pick (margin, row,
// hypothesis there), the removal pick (modified margin, row) and the count
// of nonzero gains; one thread decides the row and the step and updates
// that row's gain; every thread then reads the picked Gram row, coalesced,
// and updates its hypotheses.
//
// Bit for bit the eager loop: each product, difference, sum and quotient
// is rounded where the eager op rounds it (__fmul_rn, __fsub_rn,
// __fadd_rn, __fdiv_rn: nothing is contracted into a multiply-add), the
// picks follow ATen's argmin / argmax (NaN first, then the value, ties to
// the lowest row: a total order, so the order of the reduction does not
// matter), and a column stops at the first iteration at which it is done,
// after applying that iteration's zero step: a done state is a fixed point
// of the eager step, which the eager loop keeps applying until its next
// read of the done flag.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

// the block's shared words: the warps' picks, the iteration's decision,
// then the labels, the Gram's diagonal and the gains [N] each
extern __shared__ __align__(16) float diffco_greedy_smem[];

namespace diffco {
namespace {

constexpr int kGreedyThreads = 1024;
constexpr int kGreedyMaxRows = 16;   // rows a thread
constexpr int kGreedyMaxN = kGreedyThreads * kGreedyMaxRows;

// A thread's, a warp's or the block's candidates for one iteration.
struct GreedyPick {
  float mv;   // least margin y h (+inf on an invalid row)
  int mi;     // its row
  float mh;   // the hypothesis there
  float xv;   // greatest modified margin y (h - g K_ii) [g != 0] [valid]
  int xi;     // its row
  int nz;     // nonzero gains
};

__device__ __forceinline__ GreedyPick greedy_identity() {
  return GreedyPick{INFINITY, INT_MAX, 0.f, -INFINITY, INT_MAX, 0};
}

// ATen's argmin order (LessOrNan): a NaN first, then the lesser value,
// ties to the lower row.
__device__ __forceinline__ bool before_min(float a, int ia, float b,
                                           int ib) {
  if (a != a) return b != b ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

// ATen's argmax order (GreaterOrNan).
__device__ __forceinline__ bool before_max(float a, int ia, float b,
                                           int ib) {
  if (a != a) return b != b ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

__device__ __forceinline__ void greedy_combine(GreedyPick& a,
                                               const GreedyPick& b) {
  if (before_min(b.mv, b.mi, a.mv, a.mi)) {
    a.mv = b.mv;
    a.mi = b.mi;
    a.mh = b.mh;
  }
  if (before_max(b.xv, b.xi, a.xv, a.xi)) {
    a.xv = b.xv;
    a.xi = b.xi;
  }
  a.nz += b.nz;
}

__device__ __forceinline__ GreedyPick greedy_shfl_xor(const GreedyPick& p,
                                                      int mask) {
#if defined(DIFFCO_REPLAY)
  return diffco_replay_shfl(p, mask);
#else
  constexpr unsigned kAll = 0xffffffffu;
  return GreedyPick{__shfl_xor_sync(kAll, p.mv, mask),
                    __shfl_xor_sync(kAll, p.mi, mask),
                    __shfl_xor_sync(kAll, p.mh, mask),
                    __shfl_xor_sync(kAll, p.xv, mask),
                    __shfl_xor_sync(kAll, p.xi, mask),
                    __shfl_xor_sync(kAll, p.nz, mask)};
#endif
}

// The shared words before the labels: the picks of T / 32 warps, the
// picked row, the done flag; the step comes next.
__host__ __device__ constexpr int greedy_head_words(int T) {
  return T / 32 * static_cast<int>(sizeof(GreedyPick) / 4) + 2;
}

// The block's shared bytes at N rows.
__host__ __device__ constexpr int greedy_smem_bytes(int T, int N) {
  return 4 * (greedy_head_words(T) + 1 + 3 * N);
}

// Every lane of the warp ends with the warp's pick.
__device__ __forceinline__ void greedy_warp_reduce(GreedyPick& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) greedy_combine(p, greedy_shfl_xor(p, o));
}

// Column blockIdx.x of the labels y [N, C]: greedy training over the Gram
// K [N, N] from gains0 and hyp0 [N, C] (null: zeros) with valid [N] (null:
// every row), at most max_iteration iterations -> gains, hyp [N, C] of
// that column and iters[c], the iterations until the column was first done
// (that iteration included), or max_iteration. T threads, T * R >= N.
template <int T, int R>
__global__ void __launch_bounds__(T, 1)
greedy_train_kernel(const float* __restrict__ K, const float* __restrict__ y,
                    const float* __restrict__ gains0,
                    const float* __restrict__ hyp0,
                    const unsigned char* __restrict__ valid, int N, int C,
                    float beta, int max_iteration, float* __restrict__ gains,
                    float* __restrict__ hyp, long long* __restrict__ iters) {
  GreedyPick* s_warp = reinterpret_cast<GreedyPick*>(diffco_greedy_smem);
  int* s_idx = reinterpret_cast<int*>(s_warp + T / 32);
  int* s_done = s_idx + 1;
  float* s_delta = diffco_greedy_smem + greedy_head_words(T);
  float* s_y = s_delta + 1;
  float* s_d = s_y + N;
  float* s_g = s_d + N;
  const int t = threadIdx.x, c = blockIdx.x;
  const int lane = t % 32, warp = t / 32;

  for (int r = t; r < N; r += T) {
    const size_t rc = static_cast<size_t>(r) * C + c;
    s_y[r] = y[rc];
    s_d[r] = K[static_cast<size_t>(r) * N + r];
    s_g[r] = gains0 ? gains0[rc] : 0.f;
  }
  float h[R];
  unsigned vbits = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = t + k * T;
    h[k] = 0.f;
    if (r < N) {
      if (hyp0) h[k] = hyp0[static_cast<size_t>(r) * C + c];
      if (!valid || valid[r]) vbits |= 1u << k;
    }
  }
  __syncthreads();

  long long n_iter = max_iteration;
  for (int it = 0; it < max_iteration; ++it) {
    // this thread's rows, as _class_picks computes them: margin =
    // where(valid, y h, inf), modified = y (h - g K_ii) [g != 0] [valid]
    GreedyPick p = greedy_identity();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = t + k * T;
      if (r < N) {
        const float yr = s_y[r], g = s_g[r];
        const float vf = (vbits >> k) & 1u ? 1.f : 0.f;
        const float m = vf != 0.f ? __fmul_rn(yr, h[k]) : INFINITY;
        const float nzf = g != 0.f ? 1.f : 0.f;
        const float mod = __fmul_rn(
            __fmul_rn(__fmul_rn(yr, __fsub_rn(h[k], __fmul_rn(g, s_d[r]))),
                      nzf),
            vf);
        p.nz += g != 0.f;
        if (before_min(m, r, p.mv, p.mi)) {
          p.mv = m;
          p.mi = r;
          p.mh = h[k];
        }
        if (before_max(mod, r, p.xv, p.xi)) {
          p.xv = mod;
          p.xi = r;
        }
      }
    }
    greedy_warp_reduce(p);
    if (lane == 0) s_warp[warp] = p;
    __syncthreads();
    if (warp == 0) {
      p = lane < T / 32 ? s_warp[lane] : greedy_identity();
      greedy_warp_reduce(p);
      if (lane == 0) {
        // take the min-margin update if its margin is <= 0, else remove
        // the support whose removal raises its own margin, else done
        const bool take_update = p.mv <= 0.f;
        const float target = s_y[p.mi] > 0.f ? beta : -1.f;
        const float du = __fdiv_rn(__fsub_rn(target, p.mh), s_d[p.mi]);
        const bool removable = p.xv > 0.f && p.nz > 1;
        const int idx = take_update ? p.mi : p.xi;
        const float delta =
            take_update ? du : (removable ? -s_g[p.xi] : 0.f);
        s_g[idx] = __fadd_rn(s_g[idx], delta);
        *s_idx = idx;
        *s_delta = delta;
        *s_done = !take_update && !removable;
      }
    }
    __syncthreads();
    // hyp += K[idx] delta (the done iteration's zero step included)
    const float delta = *s_delta;
    const float* row = K + static_cast<size_t>(*s_idx) * N;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = t + k * T;
      if (r < N) h[k] = __fadd_rn(h[k], __fmul_rn(row[r], delta));
    }
    if (*s_done) {
      n_iter = it + 1;
      break;
    }
  }

  for (int r = t; r < N; r += T)
    gains[static_cast<size_t>(r) * C + c] = s_g[r];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = t + k * T;
    if (r < N) hyp[static_cast<size_t>(r) * C + c] = h[k];
  }
  if (t == 0) iters[c] = n_iter;
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

namespace diffco {
namespace {

template <int R>
int greedy_launch(const float* K, const float* y, const float* gains0,
                  const float* hyp0, const unsigned char* valid, int N,
                  int C, float beta, int max_iteration, float* gains,
                  float* hyp, long long* iters, cudaStream_t st) {
  auto kernel = greedy_train_kernel<kGreedyThreads, R>;
  const int smem = greedy_smem_bytes(kGreedyThreads, N);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<C, kGreedyThreads, smem, st>>>(K, y, gains0, hyp0, valid, N, C,
                                          beta, max_iteration, gains, hyp,
                                          iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace diffco

// Greedy training of the C label columns of y [N, C] over the Gram K
// [N, N] (row-major), from gains0 and hyp0 [N, C] (null: zeros), with
// valid [N] (bool bytes; null: every row) and target beta for a positive
// label, -1 otherwise: gains and hyp [N, C] after at most max_iteration
// iterations, and iters [C] (int64) each column's iterations until done.
// Every pointer but the optional ones is device memory; 1 <= N <=
// kGreedyMaxN. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch.
extern "C" int greedy_train(const float* K, const float* y,
                            const float* gains0, const float* hyp0,
                            const unsigned char* valid, int N, int C,
                            float beta, int max_iteration, float* gains,
                            float* hyp, long long* iters, void* stream) {
  if (N < 1 || N > diffco::kGreedyMaxN || C < 1 || max_iteration < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(R)                                                   \
  diffco::greedy_launch<R>(K, y, gains0, hyp0, valid, N, C, beta,          \
                           max_iteration, gains, hyp, iters, st)
  const int rows = (N + diffco::kGreedyThreads - 1) / diffco::kGreedyThreads;
  if (rows <= 1) return DIFFCO_LAUNCH(1);
  if (rows <= 2) return DIFFCO_LAUNCH(2);
  if (rows <= 4) return DIFFCO_LAUNCH(4);
  if (rows <= 8) return DIFFCO_LAUNCH(8);
  return DIFFCO_LAUNCH(16);
#undef DIFFCO_LAUNCH
}
