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

from diffco_tpu_torch.ops import _native, fk_score
from diffco_tpu_torch.robots import PandaFK
from diffco_tpu_torch.robots.urdf import FrankaPanda
from diffco_tpu_torch.robots.analytic import baxter_arm

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
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __CUDACC__ 1

struct Dim3 { unsigned x, y, z; };
thread_local Dim3 threadIdx, blockIdx, blockDim;
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
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to replay the kernels on the CPU')
    d = tmp_path_factory.mktemp('multi_block_replay')
    src = d / 'replay.cpp'
    src.write_text(PRELUDE + _device_code('dh_multi_score.cu')
                   + _device_code('chain_multi_score.cu') + RUNNER)
    exe = d / 'replay'
    probe = subprocess.run([gxx, '-std=c++20', '-x', 'c++', '-fsyntax-only',
                            '-'], input='#include <barrier>\n',
                           capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip('needs g++ with -std=c++20 and <barrier>')
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
# whose pass reads the points from shared memory)
BAXTER_MASKS = {'Baxter arm, 2 points': (False, False, True, False, False,
                                         False, True),
                'Baxter arm, 4 points': (True, False, True, False, True,
                                         False, True)}
DH_CASES = [('PandaFK', C) for C in (1, 2, 3, 5, 8)] + \
           [('Baxter arm, 2 points', C) for C in (1, 2, 3, 5, 8)] + \
           [('Baxter arm, 4 points', C) for C in (2, 5)]


@pytest.mark.parametrize('robot_name,C', DH_CASES)
def test_dh_multi_block_replay_matches_plain(replay_bin, tmp_path,
                                             robot_name, C):
    robot = (PandaFK() if robot_name == 'PandaFK' else
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
