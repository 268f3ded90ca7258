"""The greedy trainer's kernel (csrc/greedy_train.cu, perceptron.py::
_train_kernel): which calls take it, and that it is the eager loop
(``_train_columns`` without a Gram) bit for bit.

On the CPU: the route, decided on the Gram's metadata (``takes_train_kernel``,
with stand-ins for card tensors); the dense, unsharded callers reaching the
C entry (a stub that runs the eager loop on the memory behind the pointers
it is given) and the other trainers not reaching it; the counters; and the
kernel's device code replayed with g++ (a block's threads as
``std::thread``s, ``__syncthreads()`` as a ``std::barrier``, the warp
shuffles through a scratch) against the eager loop, equal in every bit.

On the card (``pytest -m cuda tests/test_torch_greedy_kernel.py``; the
fixture skips without one): every trainer call of the benchmark's fits and
updates, and direct calls at the kernel's edges, run both ways, equal in
every bit and in the iterations."""
import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from diffco_tpu_torch import perceptron, profiling
from diffco_tpu_torch.kernels import RQKernel
from diffco_tpu_torch.ops import _native

torch.set_num_threads(1)

CARD = torch.device('cuda')


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(out, ref):
    """Equal gains and hypotheses in every bit (a -0.0 is not a 0.0) and
    equal iterations."""
    assert torch.equal(_bits(out[0]), _bits(ref[0]))
    assert torch.equal(_bits(out[1]), _bits(ref[1]))
    assert int(out[2]) == int(ref[2])


def _problem(N, C=1, seed=0, dup=0):
    """A Gram K [N, N] (RQ kernel, gamma 10) of rows uniform in a cube, the
    first ``dup`` rows repeated at the end (ties in every pick), and labels
    y [N, C] in +-1 from a wave, a phase a column (about half positive;
    the trainer runs ~0.4 N iterations, removals among them), float32 on
    the CPU."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(N - dup, 3)).astype(np.float32)
    X = np.concatenate([X, X[:dup]])
    y = np.stack([np.where(np.sin(3 * X[:, 0] + c) * np.cos(3 * X[:, 1])
                           + 0.3 * X[:, 2] > 0, 1.0, -1.0)
                  for c in range(C)], 1).astype(np.float32)
    Xt = torch.from_numpy(X)
    return RQKernel(10.0)(Xt, Xt).contiguous(), torch.from_numpy(y)


def _eager(K, y, beta, max_iteration, g0=None, h0=None, valid=None):
    """The eager loop, called directly: no Gram handed over."""
    return perceptron._train_columns(lambda idx: K[idx], torch.diagonal(K),
                                     y, beta, max_iteration, g0, h0, valid)


def _warm(K, y, n_invalid=0, seed=1):
    """A warm start for (K, y): the gains and hypothesis of a short eager
    run on the first half of the rows (zeros elsewhere), and a validity
    mask with ``n_invalid`` rows off, at random."""
    N, C = y.shape
    h = N // 2
    g, _, _ = _eager(K[:h, :h].contiguous(), y[:h], 1.0, 60)
    g0 = torch.cat([g, g.new_zeros(N - h, C)])
    h0 = K @ g0
    valid = torch.ones(N, dtype=torch.bool)
    valid[np.random.default_rng(seed).permutation(N)[:n_invalid]] = False
    return g0, h0, valid


# ---- the route (no card needed: decided on metadata)

def _standin(shape, dtype=torch.float32, device=CARD):
    """The metadata ``takes_train_kernel`` reads of a tensor."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                           device=torch.device(device),
                           dim=lambda: len(shape))


# (case, K, y, max_iteration, warm gains, takes the kernel)
ROUTES = {
    'card, N = 820': ((820, 820), (820, 1), 2460, None, True),
    'card, C = 2': ((820, 820), (820, 2), 2460, None, True),
    'card, warm start': ((820, 820), (820, 1), 2460, (820, 1), True),
    'card, N = 1': ((1, 1), (1, 1), 3, None, True),
    'card, N = 16384': ((16384, 16384), (16384, 1), 49152, None, True),
    'card, no iterations': ((64, 64), (64, 1), 0, None, True),
    'cpu': ((820, 820), (820, 1), 2460, None, False),
    'float64': ((820, 820), (820, 1), 2460, None, False),
    'float64 warm start': ((820, 820), (820, 1), 2460, (820, 1), False),
    'N = 16385': ((16385, 16385), (16385, 1), 49155, None, False),
    'not square': ((820, 821), (820, 1), 2460, None, False),
    'no columns': ((820, 820), (820, 0), 2460, None, False),
    'negative max_iteration': ((820, 820), (820, 1), -1, None, False),
    'max_iteration past int32': ((820, 820), (820, 1), 2 ** 31, None,
                                 False),
}


@pytest.mark.parametrize('case', list(ROUTES))
def test_takes_train_kernel(case):
    k, yshape, it, warm, takes = ROUTES[case]
    dtype = torch.float64 if case == 'float64' else torch.float32
    device = 'cpu' if case == 'cpu' else 'cuda'
    K = _standin(k, dtype, device)
    y = _standin(yshape, dtype, device)
    g0 = None if warm is None else _standin(
        warm, torch.float64 if 'float64' in case else torch.float32)
    assert perceptron.takes_train_kernel(K, y, it, g0) is takes


def _host_array(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


@pytest.fixture
def stub(monkeypatch):
    """The C entry ``greedy_train`` replaced by a stand-in on host memory
    (it reads its inputs at the pointers it is given, runs the eager loop
    and writes its outputs there), and the route's device test by one on
    a card stand-in: every other condition of ``takes_train_kernel`` still
    holds. Returns the calls' (N, C, beta, max_iteration, warm gains,
    warm hypothesis, valid)."""
    calls = []

    def greedy_train(K, y, g0, h0, valid, N, C, beta, max_iteration, gains,
                     hyp, iters, stream):
        calls.append((N, C, beta, max_iteration, g0 is not None,
                       h0 is not None, valid is not None))
        f32 = ctypes.c_float

        def t(ptr, shape, ctype=f32):
            if ptr is None:
                return None
            n = int(np.prod(shape))
            return torch.from_numpy(_host_array(ptr, n, ctype).reshape(shape))
        Kt = t(K, (N, N))
        counted = dict(profiling._counters)   # the stand-in's own steps
        out = _eager(Kt, t(y, (N, C)), beta, max_iteration,
                     t(g0, (N, C)), t(h0, (N, C)),
                     t(valid, (N,), ctypes.c_bool))
        profiling._counters.clear()
        profiling._counters.update(counted)
        _host_array(gains, N * C, f32)[:] = out[0].reshape(-1).numpy()
        _host_array(hyp, N * C, f32)[:] = out[1].reshape(-1).numpy()
        _host_array(iters, C, ctypes.c_longlong)[:] = int(out[2])
        return 0

    def card(t):
        return None if t is None else _standin(tuple(t.shape), t.dtype)

    takes = perceptron.takes_train_kernel
    monkeypatch.setattr(perceptron, 'takes_train_kernel',
                        lambda K, y, it, g0=None, h0=None: takes(
                            card(K), card(y), it, card(g0), card(h0)))
    monkeypatch.setattr(_native, 'build',
                        lambda: {'greedy_train': SimpleNamespace(
                            greedy_train=greedy_train)})
    monkeypatch.setattr(_native, 'check_cuda_inputs', lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls


def _diffco_fit(cls, y_cols, dtype=torch.float32, lazy=False, warm=False):
    """A proxy trained on 160 rows (labels [N] or [N, 2]), then, with
    ``warm``, warm-started on 120 new rows and its supports."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.uniform(-1, 1, (160, 4))).to(dtype)
    y = torch.stack([torch.where(torch.linalg.norm(X - c, dim=1) < 0.8,
                                 1.0, -1.0) for c in (0.2, -0.3)], 1)
    y = y[:, 0].to(dtype) if y_cols == 1 else y.to(dtype)
    p = cls(kernel_func=RQKernel(10.0))
    if lazy:
        p.lazy_gram_threshold = 100
    p.train(X, y, max_iteration=480)
    if warm:
        nv = p.num_valid
        X1 = torch.from_numpy(rng.uniform(-1, 1, (120, 4))).to(dtype)
        Xw = torch.cat([X1, p.support_points[:nv]])
        yw = torch.cat([torch.where(torch.linalg.norm(X1 - 0.2, dim=1)
                                    < 0.8, 1.0, -1.0).to(dtype),
                        p.y[:nv].reshape(-1)])
        em = np.zeros(Xw.shape[0], bool)
        em[-nv:] = True
        p.train(Xw, yw, update=True, exist_mask=em,
                max_iteration=3 * Xw.shape[0])
    return p


def _vector_fit():
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.uniform(-1, 1, (120, 3, 2)).astype(np.float32))
    y = torch.where(X[:, 0, 0] > 0, 1.0, -1.0)
    p = perceptron.MultiDimDiffCo()
    p.train(X, y, max_iteration=360)
    return p


def _sharded():
    K, y = _problem(150, seed=5)
    shard = SimpleNamespace(offset=0, n_local=150, gather=lambda t, dim=0: t)
    return perceptron._train_columns(lambda idx: K[:, idx].T,
                                     torch.diagonal(K), y, 1.0, 450,
                                     shard=shard, gram=K)


# (case, the call, kernel calls it makes)
CALLS = {
    'DiffCo': (lambda: _diffco_fit(perceptron.DiffCo, 1), 1),
    'DiffCo, warm start': (lambda: _diffco_fit(perceptron.DiffCo, 1,
                                               warm=True), 2),
    'MultiDiffCo, C = 2': (lambda: _diffco_fit(perceptron.MultiDiffCo, 2),
                           1),
    'DiffCoBeta': (lambda: perceptron.DiffCoBeta(
        kernel_func=RQKernel(10.0)).train(
            torch.from_numpy(np.random.default_rng(6).uniform(
                -1, 1, (200, 4)).astype(np.float32)),
            torch.from_numpy(np.random.default_rng(7).normal(
                size=200).astype(np.float32)), max_iteration=300), 1),
    'perceptron_train_loop': (lambda: perceptron.perceptron_train_loop(
        *(lambda K, y: (K, y[:, 0]))(*_problem(150, seed=8)), 1.0, 450), 1),
    'multiclass_train_loop': (lambda: perceptron.multiclass_train_loop(
        *_problem(150, 2, seed=9), 1.0, 450, 2), 1),
    'float64': (lambda: _diffco_fit(perceptron.DiffCo, 1, torch.float64),
                0),
    'lazy rows': (lambda: _diffco_fit(perceptron.DiffCo, 1, lazy=True), 0),
    'vector gains': (_vector_fit, 0),
    'shard': (_sharded, 0),
}


@pytest.mark.parametrize('case', list(CALLS))
def test_dense_unsharded_calls_reach_the_kernel(stub, case):
    """A dense, unsharded float32 trainer call of a Gram on the card
    reaches the C entry once, with its sizes, beta and max_iteration;
    float64, the lazy rows, the vector gains and a shard keep the eager
    loop."""
    call, n = CALLS[case]
    call()
    assert len(stub) == n
    for N, C, beta, it, *_ in stub:
        assert N >= 1 and C == (2 if 'C = 2' in case or 'multiclass' in case
                                else 1)
        assert beta == 1.0 and it == 3 * N


@pytest.mark.parametrize('case', ['DiffCo', 'DiffCo, warm start',
                                  'MultiDiffCo, C = 2'])
def test_the_kernel_route_gives_the_eager_result(stub, monkeypatch, case):
    """Through the stub the proxy is the eager loop's, bit for bit: the
    wrapper hands the entry the right rows, columns, warm start and
    mask, and takes back the right outputs."""
    cls = perceptron.MultiDiffCo if 'Multi' in case else perceptron.DiffCo
    got = _diffco_fit(cls, 2 if 'Multi' in case else 1,
                      warm='warm' in case)
    assert stub and (not ('warm' in case) or stub[-1][4:] == (True, True,
                                                              False))
    monkeypatch.undo()
    ref = _diffco_fit(cls, 2 if 'Multi' in case else 1, warm='warm' in case)
    assert got.train_iterations == ref.train_iterations
    for name in ('gains', 'hypothesis', 'support_points', 'valid_mask'):
        a, b = getattr(got, name), getattr(ref, name)
        assert torch.equal(a, b), name


def test_the_counters_follow_the_kernel(stub):
    """``perceptron.greedy_steps`` adds the kernel's iterations (read back
    once a call), ``launches.greedy_train`` one a kernel launch."""
    steps = profiling.counter('perceptron.greedy_steps')
    calls = profiling.counter('launches.greedy_train')
    p = _diffco_fit(perceptron.DiffCo, 1)
    assert profiling.counter('launches.greedy_train') - calls == 1
    assert (profiling.counter('perceptron.greedy_steps') - steps
            == p.train_iterations > 0)
    steps = profiling.counter('perceptron.greedy_steps')
    calls = profiling.counter('launches.greedy_train')
    _diffco_fit(perceptron.DiffCo, 1, lazy=True)
    assert profiling.counter('launches.greedy_train') == calls
    assert profiling.counter('perceptron.greedy_steps') > steps


# ---- the device code, replayed with g++

LAUNCH_MARKER = '// ---- launch code'

PRELUDE = r'''
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define DIFFCO_REPLAY 1

struct Dim3 { unsigned x, y, z; };
thread_local Dim3 threadIdx, blockIdx, blockDim;
std::barrier<>* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }

// a warp's lanes exchange a value through a slot each, between two waits
// on the warp's barrier
struct Warp {
  std::barrier<>* bar;
  alignas(64) unsigned char slot[32][64];
};
Warp g_warps[32];
template <class T>
T diffco_replay_shfl(const T& v, int mask) {
  static_assert(sizeof(T) <= 64);
  Warp& w = g_warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  std::memcpy(w.slot[lane], &v, sizeof(T));
  w.bar->arrive_and_wait();
  T o;
  std::memcpy(&o, w.slot[lane ^ mask], sizeof(T));
  w.bar->arrive_and_wait();
  return o;
}
'''

# replay T N C BETA MAXIT HAS_G0 HAS_H0 HAS_VALID IN OUT
# IN: K [N, N], y [N, C], then g0, h0 [N, C] and valid [N] (bytes) where
# given; OUT: gains, hyp [N, C] (float32), iters [C] (int64). Each column
# runs as one block of T threads, the instance R as the launch code picks
# it; shared memory is NaN before each block.
RUNNER = r'''
alignas(16) float diffco_greedy_smem[1 << 16];

template <int T, int R>
void run(const float* K, const float* y, const float* g0, const float* h0,
         const unsigned char* valid, int N, int C, float beta, int maxit,
         float* gains, float* hyp, long long* iters) {
  if (diffco::greedy_smem_bytes(T, N) > int(sizeof(diffco_greedy_smem)))
    std::exit(5);
  for (int blk = 0; blk < C; ++blk) {
    std::fill(std::begin(diffco_greedy_smem), std::end(diffco_greedy_smem),
              std::nanf(""));
    std::barrier<> bar(T);
    g_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    for (int i = 0; i < T / 32; ++i) {
      warp_bars.emplace_back(new std::barrier<>(32));
      g_warps[i].bar = warp_bars.back().get();
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t)
      ts.emplace_back([&, t] {
        threadIdx = Dim3{unsigned(t), 0u, 0u};
        blockIdx = Dim3{unsigned(blk), 0u, 0u};
        blockDim = Dim3{unsigned(T), 1u, 1u};
        diffco::greedy_train_kernel<T, R>(K, y, g0, h0, valid, N, C, beta,
                                          maxit, gains, hyp, iters);
      });
    for (auto& th : ts) th.join();
  }
}

template <int T>
void pick(int N, int rows, const float* K, const float* y, const float* g0,
          const float* h0, const unsigned char* valid, int C, float beta,
          int maxit, float* gains, float* hyp, long long* iters) {
#define DIFFCO_RUN(R) \
  run<T, R>(K, y, g0, h0, valid, N, C, beta, maxit, gains, hyp, iters)
  if (rows <= 1) DIFFCO_RUN(1);
  else if (rows <= 2) DIFFCO_RUN(2);
  else if (rows <= 4) DIFFCO_RUN(4);
  else if (rows <= 8) DIFFCO_RUN(8);
  else if (rows <= 16) DIFFCO_RUN(16);
  else std::exit(6);
#undef DIFFCO_RUN
}

template <class V>
void take(FILE* f, V& v) {
  if (!v.empty() && fread(v.data(), sizeof(v[0]), v.size(), f) != v.size())
    std::exit(3);
}

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const int T = std::atoi(argv[1]), N = std::atoi(argv[2]),
            C = std::atoi(argv[3]);
  const float beta = std::strtof(argv[4], nullptr);
  const int maxit = std::atoi(argv[5]);
  const bool has_g = std::atoi(argv[6]), has_h = std::atoi(argv[7]),
             has_v = std::atoi(argv[8]);
  FILE* f = std::fopen(argv[9], "rb");
  if (!f) return 3;
  std::vector<float> K(size_t(N) * N), y(size_t(N) * C);
  std::vector<float> g0(has_g ? size_t(N) * C : 0), h0(has_h ? size_t(N) * C : 0);
  std::vector<unsigned char> valid(has_v ? N : 0);
  take(f, K);
  take(f, y);
  take(f, g0);
  take(f, h0);
  take(f, valid);
  std::fclose(f);
  std::vector<float> gains(size_t(N) * C, std::nanf("")),
      hyp(size_t(N) * C, std::nanf(""));
  std::vector<long long> iters(C, -1);
  const int rows = (N + T - 1) / T;
  const float* gp = has_g ? g0.data() : nullptr;
  const float* hp = has_h ? h0.data() : nullptr;
  const unsigned char* vp = has_v ? valid.data() : nullptr;
  switch (T) {
    case 32: pick<32>(N, rows, K.data(), y.data(), gp, hp, vp, C, beta,
                      maxit, gains.data(), hyp.data(), iters.data()); break;
    case 64: pick<64>(N, rows, K.data(), y.data(), gp, hp, vp, C, beta,
                      maxit, gains.data(), hyp.data(), iters.data()); break;
    default: return 4;
  }
  f = std::fopen(argv[10], "wb");
  if (!f) return 3;
  std::fwrite(gains.data(), 4, gains.size(), f);
  std::fwrite(hyp.data(), 4, hyp.size(), f);
  std::fwrite(iters.data(), 8, iters.size(), f);
  std::fclose(f);
  return 0;
}
'''


@pytest.fixture(scope='module')
def replay_bin(tmp_path_factory):
    """The kernel's device code with the replay's runner, built with g++
    -std=c++20 (no contraction of products and sums), or skip."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to replay the kernel on the CPU')
    text = (_native._CSRC / 'greedy_train.cu').read_text()
    assert text.count(LAUNCH_MARKER) == 1
    device = text[:text.index(LAUNCH_MARKER)].replace(
        '#include <cuda_runtime.h>', '')
    d = tmp_path_factory.mktemp('greedy_replay')
    src, exe = d / 'greedy.cpp', d / 'greedy'
    src.write_text(PRELUDE + device + RUNNER)
    build = subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off',
                            '-pthread', '-w', '-o', str(exe), str(src)],
                           capture_output=True, text=True, timeout=300)
    if build.returncode != 0 and '<barrier>' in build.stderr:
        pytest.skip('needs g++ with -std=c++20 and <barrier>')
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


def _replay(exe, tmp_path, T, K, y, beta, max_iteration, g0=None, h0=None,
            valid=None):
    N, C = y.shape
    blobs = [K.numpy().tobytes(), y.numpy().tobytes()]
    blobs += [t.numpy().tobytes() for t in (g0, h0) if t is not None]
    if valid is not None:
        blobs.append(valid.numpy().astype(np.uint8).tobytes())
    src, dst = tmp_path / 'in.bin', tmp_path / 'out.bin'
    src.write_bytes(b''.join(blobs))
    args = [T, N, C, repr(float(np.float32(beta))), max_iteration,
            int(g0 is not None), int(h0 is not None), int(valid is not None),
            src, dst]
    proc = subprocess.run([str(exe), *map(str, args)], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    raw = dst.read_bytes()
    out = np.frombuffer(raw[:8 * N * C], np.float32)
    iters = np.frombuffer(raw[8 * N * C:], np.int64)
    assert iters.shape == (C,) and (iters >= 0).all()
    return (torch.from_numpy(out[:N * C].reshape(N, C).copy()),
            torch.from_numpy(out[N * C:].reshape(N, C).copy()),
            torch.tensor(int(iters.max())))


# (case: T, N, C, dup rows, warm start, invalid rows, max_iteration (None:
# 3N), beta)
REPLAYS = {
    'cold, ties': (64, 300, 1, 40, False, 0, None, 1.0),
    'warm start, padded rows': (64, 260, 1, 0, True, 37, None, 1.0),
    'max_iteration cut': (64, 300, 1, 0, False, 0, 40, 1.0),
    'C = 2, one warp': (32, 150, 2, 10, True, 5, None, 1.0),
    'fewer rows than threads': (64, 20, 1, 0, False, 0, None, 1.0),
    'beta 0.3': (32, 120, 1, 0, False, 0, None, 0.3),
}


@pytest.mark.parametrize('case', list(REPLAYS))
def test_replay_is_the_eager_loop(replay_bin, tmp_path, case):
    """The kernel's block, replayed on the CPU, against the eager loop on
    the CPU (IEEE float32 both): the same gains and hypothesis in every
    bit and the same iterations, with ties in the picks (repeated rows),
    a warm start with rows masked off, a cut before done, two columns
    and idle threads."""
    T, N, C, dup, warm, n_invalid, it, beta = REPLAYS[case]
    K, y = _problem(N, C, seed=11, dup=dup)
    g0 = h0 = valid = None
    if warm:
        g0, h0, valid = _warm(K, y, n_invalid)
    it = 3 * N if it is None else it
    ref = _eager(K, y, beta, it, g0, h0, valid)
    out = _replay(replay_bin, tmp_path, T, K, y, beta, it, g0, h0, valid)
    _same(out, ref)
    if case == 'max_iteration cut':
        assert int(ref[2]) == it


# ---- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return CARD


@pytest.fixture
def both(monkeypatch):
    """Every ``_train_columns`` call that hands over a Gram runs twice: as
    the program runs it (the kernel, where it takes the call) and as the
    eager loop (no Gram); the program goes on with the first. Returns
    (kernel launches, first, eager) a call."""
    seen = []
    train = perceptron._train_columns

    def twice(*args, gram=None, **kw):
        before = profiling.counter('launches.greedy_train')
        out = train(*args, gram=gram, **kw)
        if gram is not None:
            ran = profiling.counter('launches.greedy_train') - before
            seen.append((ran, out, train(*args, **kw)))
        return out
    monkeypatch.setattr(perceptron, '_train_columns', twice)
    return seen


def _held(seen, n):
    assert len(seen) == n
    for ran, out, ref in seen:
        assert ran == 1
        _same(out, ref)
    return [int(out[2]) for _, out, _ in seen]


def _system(name, seed=1):
    from portbench.harness import cell, manifest
    config = manifest.config(manifest.load(), name)
    return cell.System(config, cell.seeds(seed), CARD)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['panda_dh', 'baxter_dh', 'rope35'])
def test_benchmark_fits_on_the_card(cuda, both, name):
    """The benchmark's fits (panda_dh and baxter_dh: 4500 rows; rope35:
    9000), kernel and eager loop equal in every bit."""
    _system(name)
    its = _held(both, 1)
    print(name, 'iterations', its)


@pytest.mark.cuda
def test_updates_after_the_sphere_moves_on_the_card(cuda, both):
    """``panda_dh.update``'s warm-started updates (1024 rows less the
    verify split: 820) after sphere1 moves, kernel and eager loop equal in
    every bit."""
    from portbench.harness import cell
    _, _, _, kind = cell.build('panda_dh.update', 3, CARD)
    for i in range(1, 4):
        kind.before(i)
        kind.request(i)
    its = _held(both, 5)       # the fit, the warm-up update, three more
    print('update iterations', its)


# (case: N, C, dup rows, warm start, invalid rows, max_iteration)
CARD_CASES = {
    'one row': (1, 1, 0, False, 0, 3),
    'N = 1024': (1024, 1, 0, False, 0, None),
    'N = 1025, ties': (1025, 1, 64, False, 0, None),
    'padded rows': (3000, 1, 0, True, 300, None),
    'max_iteration cut': (4500, 1, 0, False, 0, 100),
    'C = 2': (2000, 2, 0, True, 20, None),
    'C = 3, N = 16384': (16384, 3, 0, False, 0, 2000),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(CARD_CASES))
def test_direct_calls_on_the_card(cuda, case):
    """``multiclass_train_loop`` (the kernel) against the eager loop at the
    kernel's edges: one row, each side of an instance's rows (R = 1, 2),
    a warm start with rows masked off, a cut before done, two and three
    columns, and the largest N (R = 16)."""
    N, C, dup, warm, n_invalid, it = CARD_CASES[case]
    K, y = _problem(N, C, seed=12, dup=dup)
    g0 = h0 = valid = None
    if warm:
        g0, h0, valid = _warm(K, y, n_invalid)
    K, y = K.to(cuda), y.to(cuda)
    g0, h0, valid = (None if t is None else t.to(cuda)
                     for t in (g0, h0, valid))
    it = 3 * N if it is None else it
    before = profiling.counter('launches.greedy_train')
    out = perceptron.multiclass_train_loop(K, y, 1.0, it, C, g0, h0, valid)
    assert profiling.counter('launches.greedy_train') == before + 1
    ref = _eager(K, y, 1.0, it, g0, h0, valid)
    _same(out, ref)
    print(case, 'iterations', int(out[2]))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    K, y = _problem(64)
    K, y = K.to(cuda), y.to(cuda)
    with pytest.raises(ValueError):
        perceptron._train_kernel(K, y, 1.0, 10,
                                 valid_mask=torch.ones(64, dtype=torch.bool))
    with pytest.raises(ValueError):
        perceptron._train_kernel(K.double(), y.double(), 1.0, 10)
    fn = _native.build()['greedy_train'].greedy_train
    out = torch.empty(64, device=cuda)
    iters = torch.empty(1, dtype=torch.int64, device=cuda)
    for N in (0, _native.GREEDY_MAX_N + 1):
        assert fn(K.data_ptr(), y.data_ptr(), None, None, None, N, 1, 1.0,
                  10, out.data_ptr(), out.data_ptr(), iters.data_ptr(),
                  None) != 0
