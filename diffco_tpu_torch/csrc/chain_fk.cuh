// Per-thread general-chain forward kinematics and its moving-ancestor
// backward, for chain_score.cu (the port of diffco_tpu/robots/fk_jvp.py::
// eval_chain as the TPU kernel _make_chain_score_kernel runs it, and of
// that kernel's dq accumulation).
//
// The chain arrives folded (ops/fk_score.py::_fold_chain): every fixed
// joint is composed on the host into the constant transform in front of
// the next moving joint, so the kernel composes only the M moving joints
// (revolute or prismatic, mimics included) of a topologically sorted tree
//
//   W_m = W_{mparent[m]} * (pre_r[m], pre_t[m]) * Motion_m(theta_m),
//   theta_m = q[dof[m]] * mult[m] + off[m],
//
// with Motion = (Rodrigues(axis, theta), 0) for a revolute joint and
// (I, axis * theta) for a prismatic one (W_{-1} = identity: the base
// transform is folded into the root's pre-transform). Point k sits at
// offset poff[k] in the frame of moving joint pframe[k], or is the
// constant world point poff[k] when pframe[k] = -1 (an all-fixed subtree).
// One build serves every chain within kMaxM moving joints, kMaxD dofs and
// kMaxCP points (ChainSpec), and the wide instances every chain within
// kWideMaxM, kWideMaxD and kWideMaxCP (ChainSpecWide).
#pragma once

#include "score_block.cuh"

namespace diffco {

constexpr int kMaxM = 16;   // moving joints
constexpr int kMaxD = 16;   // dofs
constexpr int kMaxCP = 21;  // control points (F = 3P <= 64)
// the wide instances (chain_wide.cuh): F = 3P <= 192, B2's kWideMaxF
constexpr int kWideMaxM = 64;
constexpr int kWideMaxD = 64;
constexpr int kWideMaxCP = 64;
constexpr int kRevolute = 1;
constexpr int kPrismatic = 2;

// Layout mirrored by diffco_tpu_torch/ops/_native.py::ChainSpec and
// ChainSpecWide (ctypes), at (MM, MD, MCP) = (kMaxM, kMaxD, kMaxCP) and
// (kWideMaxM, kWideMaxD, kWideMaxCP).
template <int MM, int MD, int MCP>
struct ChainSpecT {
  static constexpr int kM = MM, kD = MD, kCP = MCP;
  int M;                      // moving joints
  int P;                      // control points
  int D;                      // dofs (columns of q and dq)
  int mparent[MM];            // moving parent, < m; -1 = the base
  int jtype[MM];              // kRevolute or kPrismatic
  int dof[MM];                // column of q driving the joint
  float mult[MM];             // mimic multiplier (1 for a plain joint)
  float off[MM];              // mimic offset (0 for a plain joint)
  float axis[MM][3];          // unit joint axis in the joint frame
  float pre_r[MM][9];         // row-major rotation in front of the motion
  float pre_t[MM][3];         // translation in front of the motion
  int pframe[MCP];            // moving joint carrying point k, -1 = fixed
  float poff[MCP][3];         // offset in that frame (world if fixed)
};
using ChainSpec = ChainSpecT<kMaxM, kMaxD, kMaxCP>;
using ChainSpecWide = ChainSpecT<kWideMaxM, kWideMaxD, kWideMaxCP>;
// passed by value as a __grid_constant__ kernel argument
static_assert(sizeof(ChainSpec) <= 4096,
              "ChainSpec must fit the 4 KB kernel-parameter space");

// The indices the kernel follows must stay in range and the moving-parent
// walk must end: mparent[m] < m, and every dof and frame id in bounds.
template <class Spec>
inline bool spec_ok(const Spec& sp) {
  if (sp.M < 1 || sp.M > Spec::kM || sp.D < 1 || sp.D > Spec::kD ||
      sp.P < 1 || sp.P > Spec::kCP)
    return false;
  for (int m = 0; m < sp.M; ++m) {
    if (sp.mparent[m] < -1 || sp.mparent[m] >= m) return false;
    if (sp.dof[m] < 0 || sp.dof[m] >= sp.D) return false;
    if (sp.jtype[m] != kRevolute && sp.jtype[m] != kPrismatic) return false;
  }
  for (int k = 0; k < sp.P; ++k)
    if (sp.pframe[k] < -1 || sp.pframe[k] >= sp.M) return false;
  return true;
}

// FK of one configuration. qb holds the configuration's D values (read
// only when live). Writes each moving joint's world frame to fr[m]
// (rotation row-major in [0..8], translation in [9..11]), its world axis
// and origin to zo[m] (axis in [0..2], origin in [3..5]), and point k to
// x[3k..3k+2] for k < min(P, KP). The point loop unrolls over KP so x
// keeps constant indices (registers); fr and zo are indexed by data, so
// they live in local memory (chain_score.cu passes zo in shared memory).
template <int KP, class Spec>
DIFFCO_HD void chain_fk(const float* qb, bool live, const Spec& sp,
                        float (*fr)[12], float (*zo)[6], float* x) {
  for (int m = 0; m < sp.M; ++m) {
    const int p = sp.mparent[m];
    float pr[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    float pt[3] = {0.f, 0.f, 0.f};
    if (p >= 0) {
      for (int i = 0; i < 9; ++i) pr[i] = fr[p][i];
      for (int i = 0; i < 3; ++i) pt[i] = fr[p][9 + i];
    }
    // A = parent * pre
    float ar[9], at[3];
    for (int row = 0; row < 3; ++row) {
      const float r0 = pr[3 * row], r1 = pr[3 * row + 1], r2 = pr[3 * row + 2];
      for (int c = 0; c < 3; ++c)
        ar[3 * row + c] = r0 * sp.pre_r[m][c] + r1 * sp.pre_r[m][3 + c] +
                          r2 * sp.pre_r[m][6 + c];
      at[row] = pt[row] + r0 * sp.pre_t[m][0] + r1 * sp.pre_t[m][1] +
                r2 * sp.pre_t[m][2];
    }
    const float th = live ? qb[sp.dof[m]] * sp.mult[m] + sp.off[m] : 0.f;
    const float ux = sp.axis[m][0], uy = sp.axis[m][1], uz = sp.axis[m][2];
    // the world axis A * axis serves both joint types: a revolute axis is
    // invariant under its own rotation, and a prismatic joint slides
    // along the parent-composed f_rot * axis
    const float zx = ar[0] * ux + ar[1] * uy + ar[2] * uz;
    const float zy = ar[3] * ux + ar[4] * uy + ar[5] * uz;
    const float zz = ar[6] * ux + ar[7] * uy + ar[8] * uz;
    if (sp.jtype[m] == kRevolute) {
      float s, c;
      sincosf(th, &s, &c);
      const float C = 1.f - c;
      const float rod[9] = {ux * ux * C + c,      ux * uy * C - uz * s,
                            ux * uz * C + uy * s, uy * ux * C + uz * s,
                            uy * uy * C + c,      uy * uz * C - ux * s,
                            uz * ux * C - uy * s, uz * uy * C + ux * s,
                            uz * uz * C + c};
      for (int row = 0; row < 3; ++row)
        for (int c2 = 0; c2 < 3; ++c2)
          fr[m][3 * row + c2] = ar[3 * row] * rod[c2] +
                                ar[3 * row + 1] * rod[3 + c2] +
                                ar[3 * row + 2] * rod[6 + c2];
      for (int i = 0; i < 3; ++i) fr[m][9 + i] = at[i];
    } else {
      for (int i = 0; i < 9; ++i) fr[m][i] = ar[i];
      fr[m][9] = at[0] + zx * th;
      fr[m][10] = at[1] + zy * th;
      fr[m][11] = at[2] + zz * th;
    }
    zo[m][0] = zx;
    zo[m][1] = zy;
    zo[m][2] = zz;
    zo[m][3] = fr[m][9];
    zo[m][4] = fr[m][10];
    zo[m][5] = fr[m][11];
  }
  // fully unrolled within kMaxCP (x in registers); a loop for the wide
  // instance, whose x lies in shared memory
#pragma unroll(KP <= kMaxCP ? KP : 1)
  for (int k = 0; k < KP; ++k) {
    if (k < sp.P) {
      const int m = sp.pframe[k];
      const float ox = sp.poff[k][0], oy = sp.poff[k][1], oz = sp.poff[k][2];
      if (m < 0) {
        x[3 * k] = ox;
        x[3 * k + 1] = oy;
        x[3 * k + 2] = oz;
      } else {
        const float* f = fr[m];
        x[3 * k] = f[9] + f[0] * ox + f[1] * oy + f[2] * oz;
        x[3 * k + 1] = f[10] + f[3] * ox + f[4] * oy + f[5] * oz;
        x[3 * k + 2] = f[11] + f[6] * ox + f[7] * oy + f[8] * oz;
      }
    }
  }
}

// Moving-ancestor backward: with point gradients g_k = x_k * rowsum - su_k,
//   dq[dof_m] += mult_m * (z_m x (x_k - o_m)) . g_k   (revolute m)
//   dq[dof_m] += mult_m * z_m . g_k                   (prismatic m)
// over every moving ancestor m of point k (its pframe and that joint's
// chain of moving parents), as the TPU kernel accumulates per point.
template <int KP, class Spec>
DIFFCO_HD void chain_backward(const Spec& sp, const float (*zo)[6],
                              const float* x, float rowsum, const float* su,
                              float* dq) {
  for (int d = 0; d < sp.D; ++d) dq[d] = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k < sp.P) {
      const float px = x[3 * k], py = x[3 * k + 1], pz = x[3 * k + 2];
      const float gx = px * rowsum - su[3 * k];
      const float gy = py * rowsum - su[3 * k + 1];
      const float gz = pz * rowsum - su[3 * k + 2];
      for (int m = sp.pframe[k]; m >= 0; m = sp.mparent[m]) {
        const float zx = zo[m][0], zy = zo[m][1], zz = zo[m][2];
        float val;
        if (sp.jtype[m] == kRevolute) {
          const float rx = px - zo[m][3], ry = py - zo[m][4],
                      rz = pz - zo[m][5];
          val = (zy * rz - zz * ry) * gx + (zz * rx - zx * rz) * gy +
                (zx * ry - zy * rx) * gz;
        } else {
          val = zx * gx + zy * gy + zz * gz;
        }
        dq[sp.dof[m]] += sp.mult[m] * val;
      }
    }
  }
}

}  // namespace diffco
