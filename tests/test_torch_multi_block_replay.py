"""The multi-class kernels B4 (csrc/dh_multi_score.cu) and B5
(csrc/chain_multi_score.cu) on their shared block
(csrc/multi_score_block.cuh), replayed on the CPU with g++ against their
plain PyTorch twins.

Each kernel source is compiled up to its launch code with the CUDA
qualifiers defined away, ``__syncthreads()`` as a C++20 ``std::barrier``
and ``cp.async`` as the plain copy the block falls back to off the
device. A block runs as its 256 threads (``std::thread``), one block at a
time, with its dynamic shared memory filled with NaN first, so that a
value the kernel never staged shows up as a NaN in an output. The launch
rule is the kernels' own (``multi_dispatch``), and the instance it picks
is held to ``ops/_native.py::multi_plan``. The arithmetic and indexing of
every instance (register, narrow, full) runs this way at a ragged batch
(B = 128 + 5: two blocks, the second nearly empty) and a ragged last
chunk (S = 70 supports, chunks of 32)."""
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffco_tpu_torch import robot_data
from diffco_tpu_torch.ops import _native, fk_score, fused_score
from diffco_tpu_torch.robots import PandaFK, URDFRobot
from diffco_tpu_torch.robots.urdf import FrankaPanda
from diffco_tpu_torch.robots.analytic import baxter_arm, panda_with_points
from diffco_tpu_torch.scripts import ab_dual_tile as ab
from diffco_tpu_torch.scripts import roofline_fk_score as rf

torch.set_num_threads(1)

B, S = 128 + 5, 70
LAUNCH_MARKER = '// ---- launch code'

# Everything a kernel's device code needs from CUDA, for g++ -std=c++20.
PRELUDE = r'''
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __CUDACC__ 1

struct Dim3 { unsigned x, y, z; };
thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline float rsqrtf(float v) { return 1.f / std::sqrt(v); }
using std::min;
std::barrier<>* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
'''

# The block runner and a main that reads a case from a file:
#   replay dh|chain B S C IN OUT
# IN holds the spec struct, then q [B, D], s [S, 3P], W [S, C] (float32);
# OUT gets the instance (int32), score [B, C] and dq [C, B, D].
RUNNER = r'''
alignas(16) float diffco_multi_smem[1 << 15];
// the wide block's (chain_wide.cuh, included by both sources; its
// prologue kernel is compiled here, not run)
alignas(16) float diffco_tc_smem[4];

template <class K>
void run_blocks(int nblocks, K&& kernel) {
  for (int blk = 0; blk < nblocks; ++blk) {
    std::fill(std::begin(diffco_multi_smem), std::end(diffco_multi_smem),
              std::nanf(""));
    std::barrier<> bar(diffco::kMultiThreads);
    g_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < diffco::kMultiThreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx = Dim3{unsigned(t), 0u, 0u};
        blockIdx = Dim3{unsigned(blk), 0u, 0u};
        blockDim = Dim3{unsigned(diffco::kMultiThreads), 1u, 1u};
        kernel();
      });
    for (auto& th : threads) th.join();
  }
}

template <int FP, class Kernel>
int replay(int B, int C, Kernel&& kernel) {
  return diffco::multi_dispatch<FP>(C, [&](auto inst, auto nc) {
    constexpr int I = decltype(inst)::value, N = decltype(nc)::value;
    run_blocks((B + diffco::kMultiRows - 1) / diffco::kMultiRows,
               [&] { kernel.template operator()<FP, I, N>(); });
    return I;
  });
}

template <class T>
std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) std::exit(3);
  return v;
}

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const std::string kind = argv[1];
  const int B = std::atoi(argv[2]), S = std::atoi(argv[3]),
            C = std::atoi(argv[4]);
  FILE* in = std::fopen(argv[5], "rb");
  if (!in) return 2;
  int inst = -1, D = 0;
  std::vector<float> score(size_t(B) * C), dq;
  if (kind == "dh") {
    const diffco::DHSpec sp = take<diffco::DHSpec>(in, 1)[0];
    D = sp.J;
    const auto q = take<float>(in, size_t(B) * D);
    const auto s = take<float>(in, size_t(S) * 3 * sp.P);
    const auto W = take<float>(in, size_t(S) * C);
    dq.resize(size_t(C) * B * D);
    auto k = [&]<int FP, int I, int N>() {
      diffco::dh_multi_score_grad_kernel<FP, I, N>(
          q.data(), s.data(), W.data(), score.data(), dq.data(), B, S, C,
          sp);
    };
    switch ((3 * sp.P + 7) / 8 * 8) {
      case 8: inst = replay<8>(B, C, k); break;
      case 16: inst = replay<16>(B, C, k); break;
      case 24: inst = replay<24>(B, C, k); break;
      case 32: inst = replay<32>(B, C, k); break;
      case 40: inst = replay<40>(B, C, k); break;
      case 48: inst = replay<48>(B, C, k); break;
      default: return 4;
    }
  } else {
    const diffco::ChainSpec sp = take<diffco::ChainSpec>(in, 1)[0];
    D = sp.D;
    const auto q = take<float>(in, size_t(B) * D);
    const auto s = take<float>(in, size_t(S) * 3 * sp.P);
    const auto W = take<float>(in, size_t(S) * C);
    dq.resize(size_t(C) * B * D);
    auto k = [&]<int FP, int I, int N>() {
      diffco::chain_multi_score_grad_kernel<FP, I, N>(
          q.data(), s.data(), W.data(), score.data(), dq.data(), B, S, C,
          sp);
    };
    switch ((3 * sp.P + 7) / 8 * 8) {
      case 24: inst = replay<24>(B, C, k); break;
      default: return 4;
    }
  }
  std::fclose(in);
  FILE* out = std::fopen(argv[6], "wb");
  if (!out) return 2;
  std::fwrite(&inst, sizeof(int), 1, out);
  std::fwrite(score.data(), sizeof(float), score.size(), out);
  std::fwrite(dq.data(), sizeof(float), dq.size(), out);
  std::fclose(out);
  return 0;
}
'''


def _device_code(name):
    """A kernel source up to its launch code, with the namespaces it opens
    there closed and the CUDA runtime header left out."""
    text = (_native._CSRC / name).read_text()
    assert text.count(LAUNCH_MARKER) == 1, name
    text = text[:text.index(LAUNCH_MARKER)]
    return (text.replace('#include <cuda_runtime.h>', '')
            + '\n}  // namespace\n}  // namespace diffco\n')


@pytest.fixture(scope='module')
def replay_bin(tmp_path_factory):
    """The replay executable, built once for the module; skips when no
    g++ with C++20 (std::barrier) is present."""
    gxx = _gxx()
    d = tmp_path_factory.mktemp('multi_block_replay')
    src = d / 'replay.cpp'
    src.write_text(PRELUDE + _device_code('dh_multi_score.cu')
                   + _device_code('chain_multi_score.cu') + RUNNER)
    exe = d / 'replay'
    build = subprocess.run(
        [gxx, '-std=c++20', '-O1', '-pthread', '-w', '-I',
         str(_native._CSRC), '-o', str(exe), str(src)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def _run(exe, kind, spec, q, sup, W, tmp_path):
    Bq, D = q.shape
    C = W.shape[1]
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    src.write_bytes(bytes(spec) + q.tobytes() + sup.tobytes()
                    + W.tobytes())
    proc = subprocess.run([str(exe), kind, str(Bq), str(sup.shape[0]),
                           str(C), str(src), str(dst)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    out = np.frombuffer(dst.read_bytes(), np.float32)
    inst = int(out[:1].view(np.int32)[0])
    score = out[1:1 + Bq * C].reshape(Bq, C)
    dq = out[1 + Bq * C:].reshape(C, Bq, D)
    return _native.MULTI_INSTANCES[inst], score, dq


def _inputs(robot, C, seed):
    """q [B, D]; supports = FK points of S random configurations;
    W [S, C] ~ N(0, 0.05^2): numpy from a seed."""
    lims = np.asarray(robot.joint_limits, np.float32)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S + B, lims.shape[0])).astype(np.float32)
    qs = u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
    sup = robot.fkine(torch.from_numpy(qs[:S])).reshape(S, -1).numpy()
    W = (rng.normal(size=(S, C)) * 0.05).astype(np.float32)
    return (np.ascontiguousarray(qs[S:]), np.ascontiguousarray(sup), W)


def _check(exe, kind, robot, spec, c_spec, plain, C, seed, tmp_path):
    q, sup, W = _inputs(robot, C, seed)
    inst, score, dq = _run(exe, kind, c_spec, q, sup, W, tmp_path)
    P = sup.shape[1] // 3
    assert inst == _native.multi_plan(P, C)['instance'], (P, C, inst)
    assert np.isfinite(score).all() and np.isfinite(dq).all(), (P, C, inst)
    ref, ref_dq = plain(*(torch.from_numpy(a) for a in (q, sup, W)), spec)
    np.testing.assert_allclose(score, ref.numpy(), rtol=1e-4, atol=1e-4)
    tol = 1e-3 * float(ref_dq.abs().max())
    np.testing.assert_allclose(dq, ref_dq.numpy(), rtol=1e-3, atol=tol)
    return inst


# PandaFK's 7 points take FP = 24 (C <= 2 register, 3-5 one full pass,
# 8 two); Baxter's arm with 2 points FP = 8 (C <= 5 register, 6-7 narrow,
# 8 full), with 4 points FP = 16 (C <= 2 register, 3 narrow, 4-7 full,
# whose pass reads the points from shared memory); PandaFK's chain with
# 10, 13 and 16 points FP = 32, 40 and 48 (no register instance: C = 1
# narrow, 2 one full pass, 5 two or three)
BAXTER_MASKS = {'Baxter arm, 2 points': (False, False, True, False, False,
                                         False, True),
                'Baxter arm, 4 points': (True, False, True, False, True,
                                         False, True)}
WIDE_POINTS = {'PandaFK chain, 10 points': 10,
               'PandaFK chain, 13 points': 13,
               'PandaFK chain, 16 points': 16}
DH_CASES = [('PandaFK', C) for C in (1, 2, 3, 5, 8)] + \
           [('Baxter arm, 2 points', C) for C in (1, 2, 3, 5, 8)] + \
           [('Baxter arm, 4 points', C) for C in (2, 5)] + \
           [(name, C) for name in WIDE_POINTS for C in (1, 2, 5)]


@pytest.mark.parametrize('robot_name,C', DH_CASES)
def test_dh_multi_block_replay_matches_plain(replay_bin, tmp_path,
                                             robot_name, C):
    robot = (PandaFK() if robot_name == 'PandaFK' else
             panda_with_points(WIDE_POINTS[robot_name])
             if robot_name in WIDE_POINTS else
             baxter_arm(BAXTER_MASKS[robot_name]))
    spec = fk_score.robot_spec(robot)
    _check(replay_bin, 'dh', robot, spec, fk_score._c_spec(spec),
           fk_score._dh_multi_score_grad_plain, C, seed=C, tmp_path=tmp_path)


def test_chain_multi_register_instance_replay_matches_plain(replay_bin,
                                                            tmp_path):
    """B5's launches at C <= 2 on FrankaPanda (FP = 24) take the block's
    register instance."""
    robot = FrankaPanda(load_gripper=True, device='cpu')
    cs = fk_score.robot_chain_statics(robot)
    inst = _check(replay_bin, 'chain', robot, cs, fk_score._c_chain_spec(cs),
                  fk_score._chain_multi_score_grad_plain, 2, seed=11,
                  tmp_path=tmp_path)
    assert inst == 'register'


# ---- B1 (csrc/dh_score.cu) on the tensor-core block (csrc/tc_score_block.cuh)
#
# The tensor-core instructions are emulated on the host: each lane writes
# its fragments to its warp's scratch, the warp's 32 threads meet at a
# barrier, and each lane computes its own accumulator fragment from the
# whole tile, with the operands cut to TF32 (their low 13 bits dropped, as
# the tensor cores read them) and the eight products (exact in fp32) added
# in order to the accumulator in fp32; a shuffle goes through the same
# scratch. ``cvt.rna.tf32.f32`` is the header's own host version. The
# emulation is not bit-exact to the tensor core, whose accumulation order
# and rounding within a tile are not specified, so the replay is held to
# the plain twin at the tolerances chip_smoke.py holds the card's kernel
# to (score 1e-4, dq 1e-3 of max): 3xTF32 with fp32 accumulation lies
# within both, plain TF32 does not.

TC_PRELUDE = PRELUDE.replace('#include <algorithm>', '#include <algorithm>\n'
                             '#include <array>\n#include <memory>\n'
                             '#include <mutex>') + r'''
#define DIFFCO_REPLAY 1
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline void __syncwarp() {}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
struct WarpScratch {
  float a[32][4], b[32][2], v[32];
  unsigned ua[32][4], ub[32][2];
  double dv[32], fa[2][32][8], fb[2][32][4];
  std::barrier<>* bar;
};
WarpScratch g_warps[16];
// named barriers (bar.sync / bar.arrive id, count): one std::barrier per
// id, made at its first use in a block with that use's count
std::mutex g_named_mu;
std::barrier<>* g_named[16];
void diffco_replay_bar(int id, int count, bool wait) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(g_named_mu);
    if (!g_named[id]) g_named[id] = new std::barrier<>(count);
    b = g_named[id];
  }
  if (wait)
    b->arrive_and_wait();
  else
    (void)b->arrive();
}
inline WarpScratch& my_warp() { return g_warps[threadIdx.x / 32]; }
inline float tf32_cut(unsigned u) {
  u &= 0xffffe000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
void diffco_replay_mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                       unsigned b1) {
  WarpScratch& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = tf32_cut(a[i]);
  w.b[lane][0] = tf32_cut(b0);
  w.b[lane][1] = tf32_cut(b1);
  w.bar->arrive_and_wait();
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int m = i < 2 ? g : g + 8, n = 2 * t + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 8; ++k) {
      // A (m, k) lies in lane 4 (m % 8) + k % 4, register (m / 8) + 2 (k / 4);
      // B (k, n) in lane 4 n + k % 4, register k / 4
      const float av = w.a[4 * (m % 8) + k % 4][m / 8 + 2 * (k / 4)];
      const float bv = w.b[4 * n + k % 4][k / 4];
      acc += av * bv;
    }
    out[i] = acc;
  }
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
// m16n8k16 bf16: each register two bf16 (the lower k in the low half);
// the products are exact in fp32 and added in order of k
inline float bf16_half(unsigned u, int half) {
  return tf32_cut(half ? u & 0xffff0000u : u << 16);
}
void diffco_replay_mma_bf16(float (&d)[4], const unsigned (&a)[4],
                            unsigned b0, unsigned b1) {
  WarpScratch& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) w.ua[lane][i] = a[i];
  w.ub[lane][0] = b0;
  w.ub[lane][1] = b1;
  w.bar->arrive_and_wait();
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int m = i < 2 ? g : g + 8, n = 2 * t + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 16; ++k) {
      // A (m, k) in lane 4 (m % 8) + (k % 8) / 2, register m / 8 + 2 (k / 8);
      // B (k, n) in lane 4 n + (k % 8) / 2, register k / 8; half k % 2
      const float av = bf16_half(
          w.ua[4 * (m % 8) + (k % 8) / 2][m / 8 + 2 * (k / 8)], k % 2);
      const float bv = bf16_half(w.ub[4 * n + (k % 8) / 2][k / 8], k % 2);
      acc += av * bv;
    }
    out[i] = acc;
  }
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
float diffco_replay_shfl_xor(float v, int mask) {
  WarpScratch& w = my_warp();
  const int lane = threadIdx.x % 32;
  w.v[lane] = v;
  w.bar->arrive_and_wait();
  const float o = w.v[lane ^ mask];
  w.bar->arrive_and_wait();
  return o;
}
// m16n8kKK fp64 (mma.sync .f64, KK = 4, 8, 16): A a[i] at (row, k) =
// (g + 8 (i % 2), t + 4 (i / 2)); B b[i] at (k, n) = (t + 4 i, g); C
// c0..c3 at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); each
// product added to the accumulator in order of k, in double. The operands
// alternate between two scratch slots, so one meeting of the warp a
// product suffices: a lane can write a slot again only after every lane
// has met it at the next product, past its reads.
thread_local unsigned g_mma_f64_calls = 0;
template <int KK>
void diffco_replay_mma_f64(double (&d)[4], const double (&a)[KK / 2],
                           const double (&b)[KK / 4]) {
  WarpScratch& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int p = g_mma_f64_calls++ & 1;
  for (int i = 0; i < KK / 2; ++i) w.fa[p][lane][i] = a[i];
  for (int i = 0; i < KK / 4; ++i) w.fb[p][lane][i] = b[i];
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int m = i < 2 ? g : g + 8, n = 2 * t + (i & 1);
    double acc = d[i];
    for (int k = 0; k < KK; ++k)
      // A (m, k) in lane 4 (m % 8) + k % 4, register 2 (k / 4) + m / 8;
      // B (k, n) in lane 4 n + k % 4, register k / 4
      acc = std::fma(w.fa[p][4 * (m % 8) + k % 4][2 * (k / 4) + m / 8],
                     w.fb[p][4 * n + k % 4][k / 4], acc);
    d[i] = acc;
  }
}
void diffco_replay_syncwarp() { my_warp().bar->arrive_and_wait(); }
double diffco_replay_shfl_xor_f64(double v, int mask) {
  WarpScratch& w = my_warp();
  const int lane = threadIdx.x % 32;
  w.dv[lane] = v;
  w.bar->arrive_and_wait();
  const double o = w.dv[lane ^ mask];
  w.bar->arrive_and_wait();
  return o;
}
'''

# The block runner of the tensor-core kernels (B1, B2, B3) and of B2's
# wide instance, after their device code: each block of ``rows`` rows
# runs as its 256 threads, one block at a time, with shared memory filled
# with NaN first; OUT gets the guard's recomputations (int64), then the
# score and the gradient (float32).
TC_COMMON = r'''
alignas(16) float diffco_tc_smem[1 << 16];

template <class K>
void run_tc_blocks(int B, int smem_bytes, K&& kernel,
                   int rows = diffco::kTcRows,
                   int nthreads = diffco::kTcThreads, int grid = 0) {
  if (smem_bytes > int(sizeof(diffco_tc_smem))) std::exit(5);
  const int nblocks = grid ? grid : (B + rows - 1) / rows;
  for (int blk = 0; blk < nblocks; ++blk) {
    std::fill(std::begin(diffco_tc_smem), std::end(diffco_tc_smem),
              std::nanf(""));
    std::barrier<> bar(nthreads);
    g_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    for (int i = 0; i < nthreads / 32; ++i) {
      warp_bars.emplace_back(new std::barrier<>(32));
      g_warps[i].bar = warp_bars.back().get();
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx = Dim3{unsigned(t), 0u, 0u};
        blockIdx = Dim3{unsigned(blk), 0u, 0u};
        blockDim = Dim3{unsigned(nthreads), 1u, 1u};
        gridDim = Dim3{unsigned(nblocks), 1u, 1u};
        kernel();
      });
    for (auto& th : threads) th.join();
    for (auto& b : g_named) {
      delete b;
      b = nullptr;
    }
  }
}

template <class T>
std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) std::exit(3);
  return v;
}

int put(const char* path, unsigned long long guard,
        const std::vector<float>& score, const std::vector<float>& grad) {
  FILE* out = std::fopen(path, "wb");
  if (!out) return 2;
  std::fwrite(&guard, sizeof(guard), 1, out);
  std::fwrite(score.data(), sizeof(float), score.size(), out);
  std::fwrite(grad.data(), sizeof(float), grad.size(), out);
  std::fclose(out);
  return 0;
}
'''

# The wide block's prologue (csrc/wide_score_block.cuh's wide_prep_kernel)
# on its grid, as csrc/wide_launch.cuh launches it: the buffer, filled
# with NaN first, that B2's and the FK kernels' wide instances read.
WIDE_PREP = r'''
std::vector<double> run_wide_prep(const std::vector<float>& s,
                                  const std::vector<float>& W, int S, int F,
                                  int C) {
  std::vector<double> prep(diffco::wide_prep_doubles(S, F, C),
                           std::nan(""));
  const int grid = S > 0 ? diffco::wide_padded(S) / diffco::kWideChunk : 1;
  run_tc_blocks(0, 8 * diffco::wide_stride(F), [&] {
    diffco::wide_prep_kernel(s.data(), W.data(), S, F, C, prep.data());
  }, 1, diffco::kWidePrepThreads, grid);
  return prep;
}
'''

# B1 (its measurement build, at the production threshold):
#   replay B S IN OUT
# IN holds the DHSpec, then q [B, J], s [S, 3P], w [S] (float32);
# `replay plan` prints DhSmem<FP>::kBytes at FP = 8-48 and kTcGuard.
TC_RUNNER = TC_COMMON + r'''
template <int FP>
void run_tc(const std::vector<float>& q, const std::vector<float>& s,
            const std::vector<float>& w, std::vector<float>& score,
            std::vector<float>& dq, int B, int S, const diffco::DHSpec& sp,
            unsigned long long* guard) {
  run_tc_blocks(B, diffco::DhSmem<FP>::kBytes, [&] {
    diffco::dh_score_tc_kernel<FP, true>(
        q.data(), s.data(), w.data(), score.data(), dq.data(), B, S, sp,
        diffco::kTcGuard, guard);
  });
}

int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "plan") {
    for (int b : {diffco::DhSmem<8>::kBytes, diffco::DhSmem<16>::kBytes,
                  diffco::DhSmem<24>::kBytes, diffco::DhSmem<32>::kBytes,
                  diffco::DhSmem<40>::kBytes, diffco::DhSmem<48>::kBytes})
      std::printf("%d\n", b);
    std::printf("%.9g\n", diffco::kTcGuard);
    return 0;
  }
  if (argc != 5) return 2;
  const int B = std::atoi(argv[1]), S = std::atoi(argv[2]);
  FILE* in = std::fopen(argv[3], "rb");
  if (!in) return 2;
  const diffco::DHSpec sp = take<diffco::DHSpec>(in, 1)[0];
  const auto q = take<float>(in, size_t(B) * sp.J);
  const auto s = take<float>(in, size_t(S) * 3 * sp.P);
  const auto w = take<float>(in, size_t(S));
  std::fclose(in);
  std::vector<float> score(B, std::nanf("")), dq(size_t(B) * sp.J,
                                                  std::nanf(""));
  unsigned long long guard = 0;
  switch ((3 * sp.P + 7) / 8 * 8) {
    case 8: run_tc<8>(q, s, w, score, dq, B, S, sp, &guard); break;
    case 16: run_tc<16>(q, s, w, score, dq, B, S, sp, &guard); break;
    case 24: run_tc<24>(q, s, w, score, dq, B, S, sp, &guard); break;
    case 48: run_tc<48>(q, s, w, score, dq, B, S, sp, &guard); break;
    default: return 4;
  }
  return put(argv[4], guard, score, dq);
}
'''

# B2 (its measurement build, at the production threshold; at F <= 8 its
# fp64 instance, kF64Rows threads a block, and at F > 64 its wide
# instance, kWideRows rows a block, neither with a guard):
#   replay B S F IN OUT
# IN holds x [B, F], s [S, F], w [S] (float32); `replay plan` prints
# kF64Smem, then PolySmem<FP>::kBytes at FP = 16-64, then the wide
# instance's shared bytes and rows at K = 3-6.
POLY_RUNNER = TC_COMMON + WIDE_PREP + r'''
template <int F>
void run_poly_f64(const std::vector<float>& x, const std::vector<float>& s,
                  const std::vector<float>& w, std::vector<float>& score,
                  std::vector<float>& dx, int B, int S) {
  const int nblocks = (B + diffco::kF64Rows - 1) / diffco::kF64Rows;
  for (int blk = 0; blk < nblocks; ++blk) {
    std::fill(std::begin(diffco_tc_smem), std::end(diffco_tc_smem),
              std::nanf(""));
    std::barrier<> bar(diffco::kF64Rows);
    g_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < diffco::kF64Rows; ++t)
      threads.emplace_back([&, t] {
        threadIdx = Dim3{unsigned(t), 0u, 0u};
        blockIdx = Dim3{unsigned(blk), 0u, 0u};
        blockDim = Dim3{unsigned(diffco::kF64Rows), 1u, 1u};
        diffco::poly_score_f64_kernel<F>(x.data(), s.data(), w.data(),
                                         score.data(), dx.data(), B, S);
      });
    for (auto& th : threads) th.join();
  }
}

template <int K>
void run_poly_wide(const std::vector<float>& x, const std::vector<float>& s,
                   const std::vector<float>& w, std::vector<float>& score,
                   std::vector<float>& dx, int B, int S, int F) {
  const std::vector<double> prep = run_wide_prep(s, w, S, F, 1);
  run_tc_blocks(B, diffco::WideSmem<K>::kBytes, [&] {
    diffco::poly_score_wide_kernel<K>(x.data(), prep.data(), score.data(),
                                      dx.data(), B, S, F);
  }, diffco::kWideRows, diffco::kWideThreads<K>);
}

template <int FP>
void run_poly(const std::vector<float>& x, const std::vector<float>& s,
              const std::vector<float>& w, std::vector<float>& score,
              std::vector<float>& dx, int B, int S, int F,
              unsigned long long* guard) {
  run_tc_blocks(B, diffco::PolySmem<FP>::kBytes, [&] {
    diffco::poly_score_tc_kernel<FP, true>(
        x.data(), s.data(), w.data(), score.data(), dx.data(), B, S, F,
        diffco::kTcGuard, guard);
  });
}

int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "plan") {
    for (int b : {diffco::kF64Smem, diffco::PolySmem<16>::kBytes,
                  diffco::PolySmem<24>::kBytes, diffco::PolySmem<32>::kBytes,
                  diffco::PolySmem<40>::kBytes, diffco::PolySmem<48>::kBytes,
                  diffco::PolySmem<56>::kBytes, diffco::PolySmem<64>::kBytes})
      std::printf("%d\n", b);
    std::printf("%d %d\n", diffco::WideSmem<3>::kBytes, diffco::kWideRows);
    std::printf("%d %d\n", diffco::WideSmem<4>::kBytes, diffco::kWideRows);
    std::printf("%d %d\n", diffco::WideSmem<5>::kBytes, diffco::kWideRows);
    std::printf("%d %d\n", diffco::WideSmem<6>::kBytes, diffco::kWideRows);
    return 0;
  }
  if (argc != 6) return 2;
  const int B = std::atoi(argv[1]), S = std::atoi(argv[2]),
            F = std::atoi(argv[3]);
  FILE* in = std::fopen(argv[4], "rb");
  if (!in) return 2;
  const auto x = take<float>(in, size_t(B) * F);
  const auto s = take<float>(in, size_t(S) * F);
  const auto w = take<float>(in, size_t(S));
  std::fclose(in);
  std::vector<float> score(B, std::nanf("")), dx(size_t(B) * F,
                                                  std::nanf(""));
  unsigned long long guard = 0;
  switch (F <= diffco::kF64MaxF ? F : F > 64 ? 1000 + (F + 31) / 32
                                              : (F + 7) / 8 * 8) {
    case 2: run_poly_f64<2>(x, s, w, score, dx, B, S); break;
    case 5: run_poly_f64<5>(x, s, w, score, dx, B, S); break;
    case 24: run_poly<24>(x, s, w, score, dx, B, S, F, &guard); break;
    case 64: run_poly<64>(x, s, w, score, dx, B, S, F, &guard); break;
    case 1003: run_poly_wide<3>(x, s, w, score, dx, B, S, F); break;
    case 1004: run_poly_wide<4>(x, s, w, score, dx, B, S, F); break;
    case 1005: run_poly_wide<5>(x, s, w, score, dx, B, S, F); break;
    case 1006: run_poly_wide<6>(x, s, w, score, dx, B, S, F); break;
    default: return 4;
  }
  return put(argv[5], guard, score, dx);
}
'''

# B3 (its measurement build, at the production threshold):
#   replay B S IN OUT
# and the wide instance of B1, B3, B4 and B5 (csrc/chain_wide.cuh):
#   replay wide B S C IN OUT
# `replay wideplan` prints chain_wide_smem_bytes<K>() and kWideRows
# for each (P, M) of WIDE_PLAN_PM.
# IN holds the ChainSpec, then q [B, D], s [S, 3P], w [S] (float32);
# `replay plan` prints ChainSmem<FP>::bytes(M) at FP = 8-64 (rows) for
# M in CHAIN_PLAN_M (columns); `replay prep S F C IN OUT` runs the wide
# block's prologue alone on s [S, F] and W [S, C].
CHAIN_PLAN_M = (1, 4, 7, 9, 11, 16)
WIDE_PLAN_PM = ((19, 20), (34, 35), (9, 9), (64, 64), (50, 40), (22, 16))
CHAIN_RUNNER = TC_COMMON + WIDE_PREP + r'''
template <int FP>
void run_chain(const std::vector<float>& q, const std::vector<float>& s,
               const std::vector<float>& w, std::vector<float>& score,
               std::vector<float>& dq, int B, int S,
               const diffco::ChainSpec& sp, unsigned long long* guard) {
  run_tc_blocks(B, diffco::ChainSmem<FP>::bytes(sp.M), [&] {
    diffco::chain_score_tc_kernel<FP, true>(
        q.data(), s.data(), w.data(), score.data(), dq.data(), B, S, sp,
        diffco::kTcGuard, guard);
  });
}

template <int FP>
void plan_row() {
  for (int m : {M_LIST}) std::printf("%d ", diffco::ChainSmem<FP>::bytes(m));
  std::printf("\n");
}

template <int K>
void run_wide(const std::vector<float>& q, const std::vector<float>& s,
              const std::vector<float>& W, std::vector<float>& score,
              std::vector<float>& dq, int B, int S, int C,
              const diffco::ChainSpecWide& sp) {
  std::vector<float> zo(size_t(B) * sp.M * 6, std::nanf(""));
  const std::vector<double> prep = run_wide_prep(s, W, S, 3 * sp.P, C);
  run_tc_blocks(B, diffco::chain_wide_smem_bytes<K>(), [&] {
    diffco::chain_wide_score_kernel<K>(q.data(), prep.data(), score.data(),
                                       dq.data(), B, S, C, &sp, zo.data());
  }, diffco::kWideRows, diffco::kWideThreads<K>);
}

// the prologue alone: replay prep S F C IN OUT, IN holding s [S, F] and
// W [S, C]; OUT gets the buffer (wide_prep_doubles(S, F, C) doubles)
int run_prep_main(char** argv) {
  const int S = std::atoi(argv[2]), F = std::atoi(argv[3]),
            C = std::atoi(argv[4]);
  FILE* in = std::fopen(argv[5], "rb");
  if (!in) return 2;
  const auto s = take<float>(in, size_t(S) * F);
  const auto W = take<float>(in, size_t(S) * C);
  std::fclose(in);
  const std::vector<double> prep = run_wide_prep(s, W, S, F, C);
  FILE* out = std::fopen(argv[6], "wb");
  if (!out) return 2;
  std::fwrite(prep.data(), sizeof(double), prep.size(), out);
  std::fclose(out);
  return 0;
}

// the wide instance: replay wide B S C IN OUT, IN holding the
// ChainSpecWide, q [B, D], s [S, 3P], W [S, C]; OUT gets 0 (no guard),
// score [B, C] and dq [C, B, D]
int run_wide_main(char** argv) {
  const int B = std::atoi(argv[2]), S = std::atoi(argv[3]),
            C = std::atoi(argv[4]);
  FILE* in = std::fopen(argv[5], "rb");
  if (!in) return 2;
  const diffco::ChainSpecWide sp = take<diffco::ChainSpecWide>(in, 1)[0];
  if (!diffco::spec_ok(sp)) return 6;
  const auto q = take<float>(in, size_t(B) * sp.D);
  const auto s = take<float>(in, size_t(S) * 3 * sp.P);
  const auto W = take<float>(in, size_t(S) * C);
  std::fclose(in);
  std::vector<float> score(size_t(B) * C, std::nanf("")),
      dq(size_t(C) * B * sp.D, std::nanf(""));
  switch ((3 * sp.P + 31) / 32) {
    case 1: run_wide<1>(q, s, W, score, dq, B, S, C, sp); break;
    case 2: run_wide<2>(q, s, W, score, dq, B, S, C, sp); break;
    case 3: run_wide<3>(q, s, W, score, dq, B, S, C, sp); break;
    case 4: run_wide<4>(q, s, W, score, dq, B, S, C, sp); break;
    case 5: run_wide<5>(q, s, W, score, dq, B, S, C, sp); break;
    case 6: run_wide<6>(q, s, W, score, dq, B, S, C, sp); break;
    default: return 4;
  }
  return put(argv[6], 0, score, dq);
}

template <int K>
void wide_plan(int /* M: the plan does not depend on it */) {
  std::printf("%d %d\n", diffco::chain_wide_smem_bytes<K>(),
              diffco::kWideRows);
}

int main(int argc, char** argv) {
  if (argc == 7 && std::string(argv[1]) == "wide") return run_wide_main(argv);
  if (argc == 7 && std::string(argv[1]) == "prep") return run_prep_main(argv);
  if (argc == 2 && std::string(argv[1]) == "wideplan") {
    WIDE_PLAN_CALLS
    return 0;
  }
  if (argc == 2 && std::string(argv[1]) == "plan") {
    plan_row<8>(); plan_row<16>(); plan_row<24>(); plan_row<32>();
    plan_row<40>(); plan_row<48>(); plan_row<56>(); plan_row<64>();
    return 0;
  }
  if (argc != 5) return 2;
  const int B = std::atoi(argv[1]), S = std::atoi(argv[2]);
  FILE* in = std::fopen(argv[3], "rb");
  if (!in) return 2;
  const diffco::ChainSpec sp = take<diffco::ChainSpec>(in, 1)[0];
  const auto q = take<float>(in, size_t(B) * sp.D);
  const auto s = take<float>(in, size_t(S) * 3 * sp.P);
  const auto w = take<float>(in, size_t(S));
  std::fclose(in);
  std::vector<float> score(B, std::nanf("")), dq(size_t(B) * sp.D,
                                                  std::nanf(""));
  unsigned long long guard = 0;
  switch ((3 * sp.P + 7) / 8 * 8) {
    case 16: run_chain<16>(q, s, w, score, dq, B, S, sp, &guard); break;
    case 24: run_chain<24>(q, s, w, score, dq, B, S, sp, &guard); break;
    case 32: run_chain<32>(q, s, w, score, dq, B, S, sp, &guard); break;
    case 64: run_chain<64>(q, s, w, score, dq, B, S, sp, &guard); break;
    default: return 4;
  }
  return put(argv[4], guard, score, dq);
}
'''.replace('M_LIST', ', '.join(map(str, CHAIN_PLAN_M))).replace(
    'WIDE_PLAN_CALLS', ' '.join(f'wide_plan<{-(-3 * P // 32)}>({M});'
                                for P, M in WIDE_PLAN_PM))


# B6 (dh_dual_score.cu, variant V: 0 dual_seq, 1 dual_pipe, 2
# dual_pipe_persist on a grid of two blocks, whose first walks halves 0
# and 2) and B7 (dh_ablation.cu, rung M), production builds (no guard
# count):
#   replay dual V B S IN OUT    and    replay abl M B S IN OUT
# IN holds the DHSpec, then q [B, J], s [S, 3P], w [S] (float32); OUT gets
# 0, then score [B] and dq [B, J] (B6) or the rung's out [B] (B7).
ROOF_RUNNER = TC_COMMON + r"""
template <int M>
void run_abl(const std::vector<float>& q, const std::vector<float>& s,
             const std::vector<float>& w, std::vector<float>& out, int B,
             int S, const diffco::DHSpec& sp) {
  run_tc_blocks(B, diffco::DhSmem<24>::kBytes, [&] {
    diffco::dh_ablation_kernel<M>(q.data(), s.data(), w.data(), out.data(),
                                  B, S, sp);
  });
}

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const std::string kind = argv[1];
  const int V = std::atoi(argv[2]), B = std::atoi(argv[3]),
            S = std::atoi(argv[4]);
  FILE* in = std::fopen(argv[5], "rb");
  if (!in) return 2;
  const diffco::DHSpec sp = take<diffco::DHSpec>(in, 1)[0];
  const auto q = take<float>(in, size_t(B) * sp.J);
  const auto s = take<float>(in, size_t(S) * 3 * sp.P);
  const auto w = take<float>(in, size_t(S));
  std::fclose(in);
  std::vector<float> score(B, std::nanf("")), dq;
  if (kind == "dual") {
    dq.assign(size_t(B) * sp.J, std::nanf(""));
    auto k = [&]<int P>() {
      diffco::dh_dual_score_tc_kernel<P>(q.data(), s.data(), w.data(),
                                         score.data(), dq.data(), B, S, sp);
    };
    const int pipe = 2 * diffco::HalfSmem::kBytes;
    if (V == 0)
      run_tc_blocks(B, diffco::SeqSmem::kBytes,
                    [&] { k.template operator()<0>(); }, diffco::kDualRows);
    else if (V == 1)
      run_tc_blocks(B, pipe, [&] { k.template operator()<1>(); },
                    diffco::kDualRows, diffco::kPipeThreads);
    else
      run_tc_blocks(B, pipe, [&] { k.template operator()<2>(); },
                    diffco::kDualRows, diffco::kPipeThreads, 2);
  } else {
    switch (V) {
      case 0: run_abl<0>(q, s, w, score, B, S, sp); break;
      case 1: run_abl<1>(q, s, w, score, B, S, sp); break;
      case 2: run_abl<2>(q, s, w, score, B, S, sp); break;
      case 3: run_abl<3>(q, s, w, score, B, S, sp); break;
      case 4: run_abl<4>(q, s, w, score, B, S, sp); break;
      case 5: run_abl<5>(q, s, w, score, B, S, sp); break;
      default: return 4;
    }
  }
  return put(argv[6], 0, score, dq);
}
"""

def _gxx():
    """g++ with C++20's <barrier>, or skip."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to replay the kernels on the CPU')
    probe = subprocess.run([gxx, '-std=c++20', '-x', 'c++', '-fsyntax-only',
                            '-'], input='#include <barrier>\n',
                           capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip('needs g++ with -std=c++20 and <barrier>')
    return gxx


def _tc_device_code(name):
    """A tensor-core kernel's source up to its launch code."""
    text = (_native._CSRC / name).read_text()
    assert text.count(LAUNCH_MARKER) == 1, name
    return text[:text.index(LAUNCH_MARKER)].replace(
        '#include <cuda_runtime.h>', '')


@pytest.fixture(scope='module')
def tc_bins(tmp_path_factory):
    """The replay executables of B1, B2, B3 and of B6 and B7 together
    (g++ -std=c++20, the four builds started together)."""
    gxx = _gxx()
    d = tmp_path_factory.mktemp('tc_block_replay')
    procs = {}
    for kind, sources, runner in (
            ('dh', ('dh_score.cu',), TC_RUNNER),
            ('poly', ('poly_score.cu',), POLY_RUNNER),
            ('chain', ('chain_score.cu',), CHAIN_RUNNER),
            ('roof', ('dh_dual_score.cu', 'dh_ablation.cu'), ROOF_RUNNER)):
        src, exe = d / f'{kind}.cpp', d / kind
        src.write_text(TC_PRELUDE + ''.join(map(_tc_device_code, sources))
                       + runner)
        procs[kind] = (exe, subprocess.Popen(
            [gxx, '-std=c++20', '-O1', '-pthread', '-w', '-I',
             str(_native._CSRC), '-o', str(exe), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    bins = {}
    for kind, (exe, proc) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, (kind, log[-4000:])
        bins[kind] = exe
    return bins


@pytest.fixture(scope='module')
def tc_replay_bin(tc_bins):
    return tc_bins['dh']


def _near_support_inputs(robot, seed, rows=B):
    """q [rows, J] and supports s [S, 3P] whose first rows sit on query
    rows' FK points: supports 0-3 exactly on rows 0-3, 4-7 at 1e-3 from
    rows 4-7 and 8-11 at 1e-2 from rows 8-11 (random directions in point
    space), the rest FK points of random configurations; w [S] ~
    N(0, 0.05^2). numpy from a seed."""
    lims = np.asarray(robot.joint_limits, np.float32)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S + rows, lims.shape[0])).astype(np.float32)
    qs = u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
    q = np.ascontiguousarray(qs[S:])
    sup = robot.fkine(torch.from_numpy(qs[:S])).reshape(S, -1).numpy()
    x = robot.fkine(torch.from_numpy(q[:12])).reshape(12, -1).numpy()
    d = rng.normal(size=x.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sup[:12] = x + np.repeat([0.0, 1e-3, 1e-2], 4)[:, None] * d
    w = (rng.normal(size=S) * 0.05).astype(np.float32)
    return q, np.ascontiguousarray(sup, np.float32), w


def _run_tc(exe, args, blobs, n_grad, tmp_path, rows=B):
    """Run a tensor-core replay on the inputs ``blobs`` (bytes, in order)
    with the command-line ``args`` before IN and OUT: (the guard's
    recomputations, score [rows], gradient [rows, n_grad])."""
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    src.write_bytes(b''.join(blobs))
    proc = subprocess.run([str(exe), *map(str, args), str(src), str(dst)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    raw = dst.read_bytes()
    guard = int(np.frombuffer(raw[:8], np.int64)[0])
    out = np.frombuffer(raw[8:], np.float32)
    return guard, out[:rows], out[rows:].reshape(rows, n_grad)


def _check_tc(guard, score, grad, ref, ref_grad, guarded=True):
    """Score 1e-4 on every row, the gradient 1e-3 of max on all but rows
    0-3: they sit exactly on a support, where the gradient is divided by
    a distance of ~1e-7 (ill-conditioned in kernel and twin alike) and
    only has to be finite. The near-pair guard must have recomputed
    those (``guarded``: a kernel on the tensor-core block)."""
    ref, ref_grad = ref.numpy(), ref_grad.numpy()
    assert np.isfinite(score).all() and np.isfinite(grad).all()
    np.testing.assert_allclose(score, ref, rtol=1e-4, atol=1e-4)
    tol = 1e-3 * float(np.abs(ref_grad[4:]).max())
    np.testing.assert_allclose(grad[4:], ref_grad[4:], rtol=1e-3, atol=tol)
    assert guard >= 4 if guarded else guard == 0, guard


@pytest.mark.parametrize('robot_name', ['PandaFK', 'Baxter arm, 2 points',
                                        'Baxter arm, 4 points',
                                        'PandaFK chain, 16 points'])
def test_dh_tc_block_replay_matches_plain(tc_replay_bin, tmp_path,
                                          robot_name):
    """B1 at FP = 24, 8, 16 and 48 (whose x~ fragments come from shared
    memory) against its plain twin at B = 128 + 5 (two
    blocks, the second nearly empty) and S = 70 (two full chunks of 32 and
    a ragged one), shared memory filled with NaN (``_check_tc``)."""
    robot = (PandaFK() if robot_name == 'PandaFK' else
             panda_with_points(16) if robot_name.endswith('16 points') else
             baxter_arm(BAXTER_MASKS[robot_name]))
    spec = fk_score.robot_spec(robot)
    q, sup, w = _near_support_inputs(robot, seed=len(robot_name))
    out = _run_tc(tc_replay_bin, (B, S), (bytes(fk_score._c_spec(spec)),
                                          q.tobytes(), sup.tobytes(),
                                          w.tobytes()), q.shape[1], tmp_path)
    _check_tc(*out, *fk_score._dh_score_grad_plain(
        *(torch.from_numpy(a) for a in (q, sup, w)), spec))


@pytest.mark.parametrize('F', [2, 5, 21, 64, 72, 102, 150, 192])
def test_poly_tc_block_replay_matches_plain(tc_bins, tmp_path, F):
    """B2 as the launch dispatches it: its fp64 instance at F = 2 and 5
    (one block of 256 rows, no guard), the tensor-core block at FP = 24
    and 64 (F = 64 fills the row: product 2 takes its extra column tile
    for the weights), its wide instance at F = 72 and 102 (K = 3 and 4
    components a lane, two rows a warp, 16 rows a block: nine blocks,
    the last with 5 live rows and the supports in chunks of 32, 32 and
    6; no guard) and at F = 150 and 192 (K = 5 and 6, one row a warp, 8
    rows a block), against its plain twin, as B1's replay: B = 128 + 5,
    whose second tensor-core block holds 5 live rows and 123 copies of
    row B - 1, S = 70, shared memory filled with NaN. Rows and supports
    are uniform in a box off the origin, so that the block's centre
    matters; supports 0-11 sit on rows 0-3, 1e-3 from rows 4-7 and 1e-2
    from rows 8-11."""
    rng = np.random.default_rng(F)
    x = rng.uniform(-0.3, 0.9, size=(B, F)).astype(np.float32)
    sup = rng.uniform(-0.3, 0.9, size=(S, F))
    d = rng.normal(size=(12, F))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sup[:12] = x[:12] + np.repeat([0.0, 1e-3, 1e-2], 4)[:, None] * d
    sup = sup.astype(np.float32)
    w = (rng.normal(size=S) * 0.05).astype(np.float32)
    out = _run_tc(tc_bins['poly'], (B, S, F),
                  (x.tobytes(), sup.tobytes(), w.tobytes()), F, tmp_path)
    _check_tc(*out, *fused_score._poly_score_grad_plain(
        *(torch.from_numpy(a) for a in (x, sup, w))),
        guarded=_native.F64_MAX_F < F <= _native.TC_MAX_F)


def _chain_robot(name, tmp_path):
    if name == 'FrankaPanda':
        return FrankaPanda(load_gripper=True, device='cpu')
    path = (robot_data.generate_marked_rope_urdf(
        path=str(tmp_path / 'marked_rope.urdf')) if name == 'marked rope'
        else f'{robot_data.ensure_default_assets()}/{name}')
    return URDFRobot(path, device='cpu', setup_acm=False, link_spheres=1)


# FP = 24 (FrankaPanda, P = 8), 32 (the branching trifinger, P = 9), 16
# (the prismatic + mimic lift rig, P = 4) and 64 (the marked rope, P = 21
# on 11 moving joints)
CHAIN_TC_ROBOTS = ['FrankaPanda', 'trifinger_simple.urdf', 'lift_rig.urdf',
                   'marked rope']


@pytest.mark.parametrize('robot_name', CHAIN_TC_ROBOTS)
def test_chain_tc_block_replay_matches_plain(tc_bins, tmp_path, robot_name):
    """B3 on the tensor-core block against its plain twin, as B1's replay
    (``_check_tc``), on every joint type and at the widest rows the
    kernel takes."""
    robot = _chain_robot(robot_name, tmp_path)
    cs = fk_score.robot_chain_statics(robot)
    q, sup, w = _near_support_inputs(robot, seed=len(robot_name))
    out = _run_tc(tc_bins['chain'], (B, S), (
        bytes(fk_score._c_chain_spec(cs)), q.tobytes(), sup.tobytes(),
        w.tobytes()), q.shape[1], tmp_path)
    _check_tc(*out, *fk_score._chain_score_grad_plain(
        *(torch.from_numpy(a) for a in (q, sup, w)), cs))


def test_dh_tc_plan_matches_the_block(tc_replay_bin):
    """ops/_native.py::dh_tc_plan's shared bytes are those of B1's kernel
    (csrc/dh_score.cu: csrc/tc_score_block.cuh's TcSmem<FP> and the rows'
    joint axes) at every FP, and TC_GUARD the block's kTcGuard (on
    the card,
    test_dh_score_kernel_at_wide_rows holds the plan to the occupancy
    calculator)."""
    proc = subprocess.run([str(tc_replay_bin), 'plan'], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0
    *got, guard = proc.stdout.split()
    assert [int(v) for v in got] == [_native.dh_tc_plan(P)['smem_bytes']
                                     for P in (1, 5, 8, 10, 13, 16)]
    assert float(guard) == np.float32(_native.TC_GUARD)
    assert all(_native.dh_tc_plan(P)['warps_per_sm'] == 16
               for P in range(1, 17))


def _plan(exe):
    proc = subprocess.run([str(exe), 'plan'], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0
    return proc.stdout.split()


def test_poly_tc_plan_matches_the_block(tc_bins):
    """ops/_native.py::poly_tc_plan's shared bytes are B2's kernel's
    (csrc/poly_score.cu: kF64Smem for the fp64 instance at F <= 8,
    PolySmem<FP> at every FP = 16-64, and the wide instance's rows, ring
    and rows a block at K = 3-6, F = 65-192), two blocks (16 warps) per SM
    on the tensor-core block up to FP = 56, one (8 warps) at FP = 64,
    whose per-chunk running sums take 36 KB of shared memory, 8 warps on
    the wide instance (two blocks of 4 at K = 3, 4, 78 and 102 KB; one of
    8 at K = 5, 6, 126 and 151 KB), and at least three (24 warps) on the
    fp64 instance (on the card, test_poly_score_kernel_at_every_fp holds
    the plan to the occupancy calculator)."""
    got = [int(v) for v in _plan(tc_bins['poly'])]
    assert got[:8] == [_native.poly_tc_plan(F)['smem_bytes']
                       for F in range(8, 65, 8)]
    wide = [(_native.poly_tc_plan(F)['smem_bytes'],
             _native.poly_tc_plan(F)['rows']) for F in (96, 128, 160, 192)]
    assert list(zip(got[8::2], got[9::2])) == wide
    assert all(_native.poly_tc_plan(F)['warps_per_sm']
               == (24 if F <= _native.F64_MAX_F else 8 if F > 56 else 16)
               for F in range(1, _native.MAX_F + 1))


def test_chain_tc_plan_matches_the_block(tc_bins):
    """ops/_native.py::chain_tc_plan's shared bytes are B3's kernel's
    (csrc/chain_score.cu: TcSmem<FP>, the running sums at FP = 56 and
    64, and each row's zo, 6 M + 1 floats) at every FP = 8-64 and several
    M; FrankaPanda's shape (P = 8, M = 7)
    keeps two blocks (16 warps) per SM."""
    got = [int(v) for v in _plan(tc_bins['chain'])]
    want = [_native.chain_tc_plan(fp // 3, M)['smem_bytes']
            for fp in range(8, 65, 8) for M in CHAIN_PLAN_M]
    assert got == want
    assert _native.chain_tc_plan(8, 7)['warps_per_sm'] == 16


def _dh9():
    """A 9-joint DH chain with a point on every frame (J = 9 > MAX_J)."""
    from diffco_tpu_torch.robots.analytic import DHChainRobot, DHParameters
    n = 9
    return DHChainRobot(DHParameters(a=[0.1] * n, alpha=[0.5] * n,
                                     d=[0.05] * n, theta=[0.3] * n),
                        [[-np.pi, np.pi]] * n, [True] * n)


def _wide_case(name, tmp_path):
    """(robot, the wide instance's spec, its plain twin at one weight
    column, at several, the twins' spec argument): the ropes and the DH
    chain lie past the narrow kernels' bounds; the lift rig (prismatic,
    mimic) and the trifinger (a branching tree) are forced onto the wide
    instance."""
    if name == 'dh9':
        robot = _dh9()
        spec = fk_score.robot_spec(robot)
        return (robot, fk_score._c_spec(spec), fk_score._dh_score_grad_plain,
                fk_score._dh_multi_score_grad_plain, spec)
    if name.startswith('rope'):
        robot = URDFRobot(robot_data.generate_rope_urdf(
            n_links=int(name[4:]), path=str(tmp_path / f'{name}.urdf')),
            device='cpu', setup_acm=False, link_spheres=1)
    else:
        robot = _chain_robot(name, tmp_path)
    cs = fk_score.robot_chain_statics(robot)
    c = fk_score._chain_struct(*fk_score._fold_chain(cs), cs.n_dofs,
                               'chain_score_grad', narrow=False)
    if name.startswith('rope'):
        assert bytes(fk_score._c_chain_spec(cs)) == bytes(c)
    return (robot, c, fk_score._chain_score_grad_plain,
            fk_score._chain_multi_score_grad_plain, cs)


# the 20-link rope (20 moving joints, 19 points: K = 2), the 35-link rope
# (34 points, F = 102: K = 4) at one and three classes, the lift rig and
# the trifinger (K = 1 and 1) and the 9-joint DH chain folded into chain
# form (K = 1) at one and two; the 28-, 48- and 60-link ropes (F = 81,
# 141, 177: K = 3, 5 and 6, the last two with two warps a row tile) at one
# and three
WIDE_CASES = [('rope20', 1), ('rope35', 1), ('rope35', 3),
              ('lift_rig.urdf', 2), ('trifinger_simple.urdf', 1),
              ('dh9', 1), ('dh9', 2), ('rope28', 1), ('rope28', 3),
              ('rope48', 1), ('rope48', 3), ('rope60', 1), ('rope60', 3)]


@pytest.mark.parametrize('name,C', WIDE_CASES)
def test_chain_wide_replay_matches_plain(tc_bins, tmp_path, name, C):
    """The wide instance of B1, B3, B4 and B5 (csrc/chain_wide.cuh) after
    its prologue against the plain twins, as B1's replay (``_check_tc``:
    score 1e-4, dq 1e-3 of max away from rows 0-3, which sit on a
    support), at B = 128 + 5 (blocks of 64, 64 and 5 live rows) and S = 70
    (the prologue's chunks of 32, 32 and 6 with 26 zero supports), shared
    memory and the prologue's buffer filled with NaN; with C > 1 the
    classes' weight columns W [S, C] give score [B, C] and dq [C, B, D]."""
    robot, c, plain, plain_multi, spec = _wide_case(name, tmp_path)
    assert isinstance(c, _native.ChainSpecWide)
    q, sup, w = _near_support_inputs(robot, seed=len(name) + C)
    W = (np.random.default_rng(C).normal(size=(S, C)) * 0.05).astype(
        np.float32)
    if C == 1:
        W[:, 0] = w
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    src.write_bytes(bytes(c) + q.tobytes() + sup.tobytes() + W.tobytes())
    proc = subprocess.run([str(tc_bins['chain']), 'wide', str(B), str(S),
                           str(C), str(src), str(dst)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    raw = dst.read_bytes()
    out = np.frombuffer(raw[8:], np.float32)
    D = q.shape[1]
    score, dq = out[:B * C].reshape(B, C), out[B * C:].reshape(C, B, D)
    args = (torch.from_numpy(a) for a in (q, sup, W))
    if C == 1:
        ref, ref_dq = plain(*(torch.from_numpy(a) for a in (q, sup, w)),
                            spec)
        ref, ref_dq = ref[:, None], ref_dq[None]
    else:
        ref, ref_dq = plain_multi(*args, spec)
    for k in range(C):
        _check_tc(0, score[:, k], dq[k], ref[:, k], ref_dq[k],
                  guarded=False)


@pytest.mark.parametrize('S,F,C', [(70, 102, 3), (32, 192, 1),
                                   (5, 72, 2), (0, 81, 1)])
def test_wide_prep_replay_lays_out_the_supports(tc_bins, tmp_path, S, F, C):
    """The wide block's prologue (csrc/wide_score_block.cuh's
    wide_prep_kernel on its grid, its buffer filled with NaN first) writes
    every double of its buffer: the centre (the mean of the first chunk's
    supports, zeros past F), s~ = s - c at the row stride 32 ceil(F / 32)
    + 4 with 1 at component F and zeros after it, and per weight column
    (|s~|^2, w), supports past S zeros with weight 0 up to whole chunks of
    32; at S = 0 the centre alone (zeros)."""
    rng = np.random.default_rng(S + F)
    s = rng.uniform(-0.3, 0.9, size=(S, F)).astype(np.float32)
    W = rng.normal(size=(S, C)).astype(np.float32)
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    src.write_bytes(s.tobytes() + W.tobytes())
    proc = subprocess.run([str(tc_bins['chain']), 'prep', str(S), str(F),
                           str(C), str(src), str(dst)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    got = np.frombuffer(dst.read_bytes(), np.float64)
    stride, sp = _native.wide_stride(F), -(-S // _native.WIDE_CHUNK) * 32
    assert got.size == _native.wide_prep_doubles(S, F, C)
    c = np.zeros(stride)
    if S:
        c[:F] = s[:min(S, 32)].astype(np.float64).mean(0)
    st = np.zeros((sp, stride))
    st[:, F] = 1.0
    st[:S, :F] = s - c[:F]
    nsw = np.zeros((C, sp, 2))
    nsw[:, :S, 0] = (st[:S, :F] ** 2).sum(1)
    nsw[:, :S, 1] = W.T
    want = np.concatenate([c, st.ravel(), nsw.ravel()])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_chain_wide_plan_matches_the_kernel(tc_bins):
    """ops/_native.py::chain_wide_plan's shared bytes and rows are the wide
    instance's (csrc/chain_wide.cuh: the wide block's WideSmem<K>, the
    ChainSpecWide, the ancestor masks and the warps' joints' values,
    whatever the chain's joints), and it keeps 16 warps per SM at K = 1
    (four blocks of 4), 12 at K = 2 (three), and 8 from K = 3 (two blocks
    of 4 warps up to K = 4, the 35-link rope, whose warps each hold ~200
    registers of accumulators; one of 8 at K = 5 and 6)."""
    got = [tuple(map(int, ln.split())) for ln in
           subprocess.run([str(tc_bins['chain']), 'wideplan'],
                          capture_output=True, text=True,
                          timeout=60).stdout.splitlines()]
    want = [(_native.chain_wide_plan(P, M)['smem_bytes'],
             _native.chain_wide_plan(P, M)['rows'])
            for P, M in WIDE_PLAN_PM]
    assert got == want
    assert [_native.chain_wide_plan(P, M)['warps_per_sm']
            for P, M in WIDE_PLAN_PM] == [12, 8, 16, 8, 8, 8]


def _cancelling_rope_case(S_fit, seed):
    """The 35-link rope (34 points on 35 moving joints, F = 102: the wide
    instances) with fitted weights that cancel: the small regularised
    polyharmonic solve (reg 1e-6, float64) over the +-1 labels of
    ``ab_kernel.rope_ball_gt`` at S_fit supports, as ``ab_kernel
    --wide-rope`` fits them on the card. (robot, its chain statics, q [B,
    D], points x [B, F], supports [S_fit, F], w [S_fit]) in float32."""
    from diffco_tpu_torch.kernels import Polyharmonic
    from diffco_tpu_torch.perceptron import masked_rbf_solve
    from diffco_tpu_torch.scripts.ab_kernel import rope_ball_gt
    robot = URDFRobot(robot_data.generate_rope_urdf(n_links=35),
                      device='cpu', setup_acm=False, link_spheres=1)
    lims = np.asarray(robot.joint_limits, np.float32)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S_fit + B, lims.shape[0])).astype(np.float32)
    qs = torch.from_numpy(u * (lims[:, 1] - lims[:, 0]) + lims[:, 0])
    pts = robot.fkine(qs).reshape(S_fit + B, -1)
    sup = pts[:S_fit]
    y = rope_ball_gt(robot)(qs[:S_fit]).double() * 2 - 1
    w = masked_rbf_solve(Polyharmonic(k=1, epsilon=1)(sup.double(),
                                                      sup.double()), y,
                         torch.ones(S_fit, dtype=torch.bool), reg=1e-6)
    return (robot, fk_score.robot_chain_statics(robot),
            np.ascontiguousarray(qs[S_fit:].numpy()),
            np.ascontiguousarray(pts[S_fit:].numpy()),
            np.ascontiguousarray(sup.numpy()), w.float().numpy())


@pytest.mark.parametrize('kernel', ['poly', 'chain'])
def test_wide_replay_holds_float64_on_cancelling_weights(tc_bins, tmp_path,
                                                         kernel):
    """The wide block on fitted weights that cancel (sum_j |w_j| r_j far
    above |score|): B2's wide instance on the 35-link rope's points (F =
    102) and B3's on its configurations, B = 128 + 5, S = 96 (chunks of 32,
    all full), held to the float64 twin at score 1e-4 and gradient 1e-3 of
    max; the fp32 twin's own error on the same inputs is measured beside it
    and is no smaller than the block's (the block's products and pair work
    are fp64)."""
    S_fit = 96
    robot, cs, q, x, sup, w = _cancelling_rope_case(S_fit, seed=17)
    if kernel == 'poly':
        F = x.shape[1]
        _, score, grad = _run_tc(tc_bins['poly'], (B, S_fit, F),
                                 (x.tobytes(), sup.tobytes(), w.tobytes()),
                                 F, tmp_path)
        args = [torch.from_numpy(a) for a in (x, sup, w)]
        ref, ref_g = fused_score._poly_score_grad_plain(
            *(a.double() for a in args))
        f32, f32_g = fused_score._poly_score_grad_plain(*args)
    else:
        c = fk_score._c_chain_spec(cs)
        assert isinstance(c, _native.ChainSpecWide)
        src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
        src.write_bytes(bytes(c) + q.tobytes() + sup.tobytes() + w.tobytes())
        proc = subprocess.run([str(tc_bins['chain']), 'wide', str(B),
                               str(S_fit), '1', str(src), str(dst)],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
        out = np.frombuffer(dst.read_bytes()[8:], np.float32)
        score, grad = out[:B], out[B:].reshape(B, q.shape[1])
        args = [torch.from_numpy(a) for a in (q, sup, w)]
        ref, ref_g = fk_score._chain_score_grad_plain(
            *(a.double() for a in args), cs)
        f32, f32_g = fk_score._chain_score_grad_plain(*args, cs)
    ref, ref_g = ref.numpy(), ref_g.numpy()
    # the weights cancel: their terms' magnitudes far above the scores
    r = np.linalg.norm(x[:, None, :] - sup[None], axis=-1)
    assert (np.abs(w) * r).sum(1).min() > 20 * np.abs(ref).max()
    assert np.isfinite(score).all() and np.isfinite(grad).all()
    tol = 1e-3 * float(np.abs(ref_g).max())
    np.testing.assert_allclose(score, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, ref_g, rtol=1e-3, atol=tol)
    err = (np.abs(score - ref).max(), np.abs(grad - ref_g).max())
    err32 = (np.abs(f32.numpy() - ref).max(),
             np.abs(f32_g.numpy() - ref_g).max())
    assert err[0] <= err32[0] and err[1] <= err32[1], (err, err32)


# ---- B6 (csrc/dh_dual_score.cu) and B7 (csrc/dh_ablation.cu) on B1's
# tensor-core block: two 256-row tiles, the second with 5 live rows (half
# A) and none (half B), and S = 70 (a ragged last chunk)
ROOF_B = 2 * 128 + 5


@pytest.mark.parametrize('variant', list(ab.VARIANTS))
def test_dual_tc_replay_matches_plain(tc_bins, tmp_path, variant):
    """B6 in each variant (dual_seq: B1's block on each half in turn;
    dual_pipe and its persistent form: 384 threads, the FK warpgroup and
    the loop warps handing over on named barriers) against B1's plain
    twin as B1's replay (``_check_tc``), rows 0-11 on and next to
    supports."""
    robot = PandaFK()
    spec = fk_score.robot_spec(robot)
    q, sup, w = _near_support_inputs(robot, seed=21, rows=ROOF_B)
    out = _run_tc(tc_bins['roof'], ('dual', ab.VARIANTS[variant], ROOF_B, S),
                  (bytes(fk_score._c_spec(spec)), q.tobytes(), sup.tobytes(),
                   w.tobytes()), q.shape[1], tmp_path, rows=ROOF_B)
    _check_tc(*out, *fk_score._dh_score_grad_plain(
        *(torch.from_numpy(a) for a in (q, sup, w)), spec), guarded=False)


@pytest.mark.parametrize('mode', list(rf.MODES))
def test_ablation_tc_replay_matches_plain(tc_bins, tmp_path, mode):
    """Each B7 rung against its twin (``rf._dh_ablation_plain``) at
    ``rf.ABLATION_TOL`` of max |twin|, on FK points of random
    configurations."""
    robot = PandaFK()
    spec = fk_score.robot_spec(robot)
    lims = np.asarray(robot.joint_limits, np.float32)
    rng = np.random.default_rng(22)
    qs = (rng.uniform(size=(S + ROOF_B, 7)) * (lims[:, 1] - lims[:, 0])
          + lims[:, 0]).astype(np.float32)
    q = np.ascontiguousarray(qs[S:])
    sup = robot.fkine(torch.from_numpy(qs[:S])).reshape(S, -1).numpy()
    w = (rng.normal(size=S) * 0.05).astype(np.float32)
    _, out, _ = _run_tc(tc_bins['roof'], ('abl', rf.MODES[mode], ROOF_B, S),
                        (bytes(fk_score._c_spec(spec)), q.tobytes(),
                         sup.tobytes(), w.tobytes()), 0, tmp_path,
                        rows=ROOF_B)
    ref = rf._dh_ablation_plain(*(torch.from_numpy(a) for a in (q, sup, w)),
                                spec, mode).numpy()
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= rf.ABLATION_TOL[mode] * np.abs(ref).max(), (mode, err)


# The FK kernels (csrc/dh_fk.cu: robots/fk_jvp.py::_DHFkine's forward and
# VJP) replayed a block of kFkThreads threads at a time, their shared
# arrays as statics (one block runs at a time):
#   replay fk|vjp B LDQ COL0 IN OUT
# IN holds the DHSpec, q [B, LDQ] (the chain reads columns COL0 to
# COL0 + J - 1) and, for the VJP, g [B, 3P]; OUT gets x [B, 3P] or
# dq [B, J], NaN where the kernel wrote nothing.
FK_RUNNER = r'''
template <class K>
void run_blocks(int B, K kernel) {
  const int T = diffco::kFkThreads;
  for (int bx = 0; bx * T < B; ++bx) {
    std::barrier<> bar(T);
    g_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t)
      ts.emplace_back([&, t] {
        threadIdx = Dim3{unsigned(t), 0, 0};
        blockIdx = Dim3{unsigned(bx), 0, 0};
        blockDim = Dim3{unsigned(T), 1, 1};
        kernel();
      });
    for (auto& th : ts) th.join();
  }
}

template <int KP>
void run(bool vjp, const float* q, long long ldq, const float* g,
         float* out, int B, const diffco::DHSpec& sp) {
  if (vjp)
    run_blocks(B, [&] {
      diffco::dh_fk_vjp_kernel<KP>(q, ldq, g, out, B, sp);
    });
  else
    run_blocks(B, [&] { diffco::dh_fk_kernel<KP>(q, ldq, out, B, sp); });
}

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const bool vjp = std::string(argv[1]) == "vjp";
  const int B = std::atoi(argv[2]);
  const long long ldq = std::atoll(argv[3]);
  const int col0 = std::atoi(argv[4]);
  FILE* f = std::fopen(argv[5], "rb");
  if (!f) return 3;
  diffco::DHSpec sp;
  size_t got = std::fread(&sp, sizeof sp, 1, f);
  std::vector<float> q(static_cast<size_t>(B) * ldq);
  std::vector<float> g(static_cast<size_t>(B) * 3 * sp.P);
  got += std::fread(q.data(), 4, q.size(), f);
  if (vjp) got += std::fread(g.data(), 4, g.size(), f);
  std::fclose(f);
  std::vector<float> out(static_cast<size_t>(B) * (vjp ? sp.J : 3 * sp.P),
                         NAN);
  const float* qc = q.data() + col0;
  if (sp.P <= 8)
    run<8>(vjp, qc, ldq, g.data(), out.data(), B, sp);
  else
    run<16>(vjp, qc, ldq, g.data(), out.data(), B, sp);
  f = std::fopen(argv[6], "wb");
  if (!f) return 3;
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
'''


@pytest.fixture(scope='module')
def fk_replay_bin(tmp_path_factory):
    """The FK kernels' replay executable (g++ -std=c++20)."""
    gxx = _gxx()
    d = tmp_path_factory.mktemp('dh_fk_replay')
    src, exe = d / 'fk.cpp', d / 'fk'
    src.write_text(PRELUDE + '#undef __shared__\n#define __shared__ static\n'
                   + _tc_device_code('dh_fk.cu') + FK_RUNNER)
    build = subprocess.run(
        [_gxx(), '-std=c++20', '-O1', '-pthread', '-w', '-I',
         str(_native._CSRC), '-o', str(exe), str(src)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def _fk_case(name):
    """(the FK closure, q [B, LDQ] as numpy, the chain's first column): the
    KP = 8 instance at 4 and 7 points, the KP = 16 one, and the dual arm's
    right chain (a non-identity base) on the right half of 14 columns."""
    from diffco_tpu_torch.robots.analytic import (BaxterDualArmFK,
                                                  BaxterLeftArmFK)
    if name == 'dual arm, right':
        robot = BaxterDualArmFK()
        fk, col0 = robot._arm_fkine[1], 7
    else:
        robot = {'Baxter arm': BaxterLeftArmFK, 'PandaFK': PandaFK,
                 'PandaFK chain, 16 points': lambda: panda_with_points(16)
                 }[name]()
        fk, col0 = robot._fkine_flat, 0
    lims = np.asarray(robot.joint_limits, np.float32)
    u = np.random.default_rng(31).uniform(size=(B, lims.shape[0]))
    q = (u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]).astype(np.float32)
    return fk, q, col0


@pytest.mark.parametrize('vjp', [False, True], ids=['fk', 'vjp'])
@pytest.mark.parametrize('name', ['Baxter arm', 'PandaFK',
                                  'PandaFK chain, 16 points',
                                  'dual arm, right'])
def test_dh_fk_replay_matches_the_eager_ops(fk_replay_bin, tmp_path, name,
                                            vjp):
    """The FK kernel and its VJP against the eager ops (``dh_chain``,
    ``dh_vjp``) in float32 on the same rows, B = 133 (a ragged second
    block): points 1e-5, dq 1e-5 of its largest component, every output
    written."""
    from diffco_tpu_torch.robots import fk_jvp
    fk, q, col0 = _fk_case(name)
    st, c = fk.statics, fk.dh_spec
    J, P = st.n_joints, len(st.point_specs)
    g = np.random.default_rng(32).normal(size=(B, 3 * P)).astype(np.float32)
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    src.write_bytes(bytes(c) + q.tobytes() + (g.tobytes() if vjp else b''))
    proc = subprocess.run([str(fk_replay_bin), 'vjp' if vjp else 'fk',
                           str(B), str(q.shape[1]), str(col0), str(src),
                           str(dst)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    out = np.frombuffer(dst.read_bytes(), np.float32)
    qt = torch.from_numpy(q[:, col0:col0 + J])
    axes, pts = fk_jvp.dh_chain(st, qt)
    if vjp:
        ref = fk_jvp.dh_vjp(st, axes, pts, torch.from_numpy(g)).numpy()
        out = out.reshape(B, J)
        tol = 1e-5 * float(np.abs(ref).max())
    else:
        ref = torch.stack([v for p in pts for v in p], -1).numpy()
        out = out.reshape(B, 3 * P)
        tol = 1e-5
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
