// DH-chain forward kinematics and its VJP, written by hand for Hopper: the
// two passes of robots/fk_jvp.py::_DHFkine on a float32 CUDA batch.
//
// Replaces no TPU kernel. The JAX package's FK (diffco_tpu/robots/
// fk_jvp.py) is plain jnp that XLA fuses into a few kernels; the port's
// eager structure-of-arrays FK launched one kernel per component op, about
// 550 for a 7-joint, 4-point chain and 730 more for its VJP, which
// recomputes the chain. In the trajectory optimizers' Adam step (FK twice
// and its VJP twice a step) those launches were 94 % of the step's and
// left the card idle 95 % of the time.
//
// What bounds it on this card: neither bytes nor operations. At the
// optimizers' shapes (B = 448 to 28672 configurations) a row reads J
// floats (and 3P cotangents) and writes 3P floats (or J), and costs about
// 700 flops forward and 900 for the VJP: at B = 28672, J = 7 and P = 4
// both passes move 5.2 MB and compute 46 MFLOP, 1.5 us at 3.35 TB/s. The
// launch, a few microseconds, bounds it.
//
// Design: one thread a configuration, the chain in registers through
// dh_chain<KP> (dh_chain.cuh, the FK of B1's rows) and the VJP as dh_vjp
// below, the suffix sums of dh_backward on plain point cotangents; the VJP
// rebuilds the chain from q rather than reading anything the forward
// kept. A block of kFkThreads rows stages its output
// rows (and the VJP its cotangent rows) in shared memory, so the block
// reads and writes them as consecutive floats. q may be a block of columns
// of a wider tensor: its rows are read at a stride `ldq`. The DH constants
// arrive in a DHSpec kernel argument, so one build serves every DH robot
// with J <= 8 and P <= 16; instances at KP = 8 and 16 points (at KP = 4
// the forward spilled 4 B).
#include <cuda_runtime.h>

#include "dh_chain.cuh"

namespace diffco {
namespace {

constexpr int kFkThreads = 128;

// The joint angles of row b (zeros past J).
DIFFCO_HD void load_q(const float* q, long long ldq, int b, int J,
                      float* qr) {
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qr[j] = j < J ? q[static_cast<size_t>(b) * ldq + j] : 0.f;
}

// The suffix sums of dh_chain.cuh's dh_backward on plain point cotangents
// g [3P], read as given (robots/fk_jvp.py::dh_vjp): dq_j = z_j . (sm -
// o_j x sg), sg and sm the sums of g_k and x_k x g_k over the points on
// frames >= j, visited in descending k. Kept here, and not beside
// dh_backward, so that the headers of B1 (dh_score.cu) stay as they were.
template <int KP>
DIFFCO_HD void dh_vjp(const DHSpec& sp, const float* x, const float* az,
                      const float* ao, const float* g, float* dq) {
  float sgx = 0.f, sgy = 0.f, sgz = 0.f;
  float smx = 0.f, smy = 0.f, smz = 0.f;
#pragma unroll
  for (int j = kMaxJ; j >= 1; --j) {
    if (j <= sp.J) {
#pragma unroll
      for (int k = KP - 1; k >= 0; --k) {
        if (k < sp.P && sp.frame[k] == j) {
          const float px = x[3 * k], py = x[3 * k + 1], pz = x[3 * k + 2];
          const float gx = g[3 * k], gy = g[3 * k + 1], gz = g[3 * k + 2];
          smx += py * gz - pz * gy;
          smy += pz * gx - px * gz;
          smz += px * gy - py * gx;
          sgx += gx;
          sgy += gy;
          sgz += gz;
        }
      }
      const float zx = az[3 * (j - 1)], zy = az[3 * (j - 1) + 1],
                  zz = az[3 * (j - 1) + 2];
      const float ox = ao[3 * (j - 1)], oy = ao[3 * (j - 1) + 1],
                  oz = ao[3 * (j - 1) + 2];
      const float cx = oy * sgz - oz * sgy;
      const float cy = oz * sgx - ox * sgz;
      const float cz = ox * sgy - oy * sgx;
      dq[j - 1] = zx * (smx - cx) + zy * (smy - cy) + zz * (smz - cz);
    }
  }
}

// q [B, ldq] (J columns read) -> x [B, 3P].
template <int KP>
__global__ void __launch_bounds__(kFkThreads)
dh_fk_kernel(const float* __restrict__ q, long long ldq,
             float* __restrict__ x, int B, const __grid_constant__ DHSpec sp) {
  __shared__ float x_sh[kFkThreads * 3 * KP];
  const int F = 3 * sp.P;
  const int row0 = blockIdx.x * kFkThreads;
  const int n = min(kFkThreads, B - row0);
  const int t = threadIdx.x;
  if (t < n) {
    float qr[kMaxJ], xr[3 * KP], az[3 * kMaxJ], ao[3 * kMaxJ];
    load_q(q, ldq, row0 + t, sp.J, qr);
    dh_chain<KP>(qr, sp, xr, az, ao);
#pragma unroll
    for (int f = 0; f < 3 * KP; ++f)
      if (f < F) x_sh[t * F + f] = xr[f];
  }
  __syncthreads();
  float* out = x + static_cast<size_t>(row0) * F;
  for (int i = t; i < n * F; i += kFkThreads) out[i] = x_sh[i];
}

// q [B, ldq] (J columns read), point cotangents g [B, 3P] -> dq [B, J].
template <int KP>
__global__ void __launch_bounds__(kFkThreads)
dh_fk_vjp_kernel(const float* __restrict__ q, long long ldq,
                 const float* __restrict__ g, float* __restrict__ dq, int B,
                 const __grid_constant__ DHSpec sp) {
  __shared__ float g_sh[kFkThreads * 3 * KP];
  __shared__ float dq_sh[kFkThreads * kMaxJ];
  const int F = 3 * sp.P, J = sp.J;
  const int row0 = blockIdx.x * kFkThreads;
  const int n = min(kFkThreads, B - row0);
  const int t = threadIdx.x;
  const float* in = g + static_cast<size_t>(row0) * F;
  for (int i = t; i < n * F; i += kFkThreads) g_sh[i] = in[i];
  __syncthreads();
  if (t < n) {
    float qr[kMaxJ], xr[3 * KP], az[3 * kMaxJ], ao[3 * kMaxJ], dqr[kMaxJ];
    load_q(q, ldq, row0 + t, J, qr);
    dh_chain<KP>(qr, sp, xr, az, ao);
    dh_vjp<KP>(sp, xr, az, ao, g_sh + t * F, dqr);
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) dq_sh[t * J + j] = dqr[j];
  }
  __syncthreads();
  float* out = dq + static_cast<size_t>(row0) * J;
  for (int i = t; i < n * J; i += kFkThreads) out[i] = dq_sh[i];
}

}  // namespace
}  // namespace diffco

// ---- launch code (the CPU replay test compiles the file up to here)

namespace diffco {
namespace {

int fk_blocks(int B) { return (B + kFkThreads - 1) / kFkThreads; }

template <int KP>
int fk_launch(const float* q, long long ldq, float* x, int B,
              const DHSpec& sp, cudaStream_t st) {
  dh_fk_kernel<KP><<<fk_blocks(B), kFkThreads, 0, st>>>(q, ldq, x, B, sp);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
int fk_vjp_launch(const float* q, long long ldq, const float* g, float* dq,
                  int B, const DHSpec& sp, cudaStream_t st) {
  dh_fk_vjp_kernel<KP><<<fk_blocks(B), kFkThreads, 0, st>>>(q, ldq, g, dq,
                                                             B, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace diffco

#define DIFFCO_KP_SWITCH(P, CALL) \
  if ((P) <= 8) return CALL(8);   \
  return CALL(16);

static bool dh_fk_args_ok(const diffco::DHSpec& sp, int B, long long ldq) {
  return B > 0 && ldq >= 0 && sp.J >= 1 && sp.J <= diffco::kMaxJ &&
         sp.P >= 1 && sp.P <= diffco::kMaxP;
}

// x [B, 3P] = the control points of q [B, ldq] (its first J columns).
// `spec` is a host pointer, copied into the kernel's arguments. Launches on
// `stream`, does not synchronise; returns the cudaError_t of the launch.
extern "C" int dh_fk(const float* q, long long ldq, float* x, int B,
                     const diffco::DHSpec* spec, void* stream) {
  const diffco::DHSpec sp = *spec;
  if (!dh_fk_args_ok(sp, B, ldq)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(KP) diffco::fk_launch<KP>(q, ldq, x, B, sp, st)
  DIFFCO_KP_SWITCH(sp.P, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}

// dq [B, J] = the VJP of dh_fk at q [B, ldq] with point cotangents
// g [B, 3P] (contiguous). As dh_fk otherwise.
extern "C" int dh_fk_vjp(const float* q, long long ldq, const float* g,
                         float* dq, int B, const diffco::DHSpec* spec,
                         void* stream) {
  const diffco::DHSpec sp = *spec;
  if (!dh_fk_args_ok(sp, B, ldq)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIFFCO_LAUNCH(KP) \
  diffco::fk_vjp_launch<KP>(q, ldq, g, dq, B, sp, st)
  DIFFCO_KP_SWITCH(sp.P, DIFFCO_LAUNCH)
#undef DIFFCO_LAUNCH
}
