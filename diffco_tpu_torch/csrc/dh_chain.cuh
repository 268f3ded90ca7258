// Per-thread DH-chain forward kinematics and its suffix-sum backward, for
// dh_score.cu (the port of diffco_tpu/ops/fk_score.py::_dh_chain_tile and
// the backward of _make_dh_score_kernel).
//
// The chain constants arrive in a DHSpec passed by value as a kernel
// argument, so one build serves every DH robot of up to kMaxJ joints and
// kMaxP control points.
#pragma once

#include "score_block.cuh"

namespace diffco {

constexpr int kMaxJ = 8;
constexpr int kMaxP = 16;

// Layout mirrored by diffco_tpu_torch/ops/_native.py::DHSpec (ctypes).
struct DHSpec {
  int J;                  // joints
  int P;                  // control points
  float dh[kMaxJ][5];     // a, d, sin(alpha), cos(alpha), theta offset
  int frame[kMaxP];       // 1-based frame of each point, non-decreasing
  float off[kMaxP][3];    // point offset in its frame
  float base_r[9];        // base rotation, row-major
  float base_t[3];        // base translation
};

// FK of one configuration: writes control point k to x[3k..3k+2] for
// k < min(P, KP), and per joint j its world axis az[3j..] and origin
// ao[3j..] taken BEFORE the joint's rotation. Loops are unrolled over the
// compile-time bounds so every array index is a constant (registers).
template <int KP>
DIFFCO_HD void dh_chain(const float* q, const DHSpec& sp, float* x,
                        float* az, float* ao) {
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = sp.base_r[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sp.base_t[i];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < sp.J) {
      az[3 * j] = r[2];
      az[3 * j + 1] = r[5];
      az[3 * j + 2] = r[8];
      ao[3 * j] = t[0];
      ao[3 * j + 1] = t[1];
      ao[3 * j + 2] = t[2];
      const float a = sp.dh[j][0], d = sp.dh[j][1];
      const float sa = sp.dh[j][2], ca = sp.dh[j][3], th = sp.dh[j][4];
      float st, ct;
      sincosf(q[j] + th, &st, &ct);
      // joint transform: rows (ct, -st ca, st sa), (st, ct ca, -ct sa),
      // (0, sa, ca); translation (a ct, a st, d)
      const float b00 = ct, b01 = -st * ca, b02 = st * sa;
      const float b10 = st, b11 = ct * ca, b12 = -ct * sa;
      const float b21 = sa, b22 = ca;
      const float tx = a * ct, ty = a * st, tz = d;
      t[0] = t[0] + r[0] * tx + r[1] * ty + r[2] * tz;
      t[1] = t[1] + r[3] * tx + r[4] * ty + r[5] * tz;
      t[2] = t[2] + r[6] * tx + r[7] * ty + r[8] * tz;
      float n[9];
#pragma unroll
      for (int row = 0; row < 3; ++row) {
        const float r0 = r[3 * row], r1 = r[3 * row + 1], r2 = r[3 * row + 2];
        n[3 * row] = r0 * b00 + r1 * b10;
        n[3 * row + 1] = r0 * b01 + r1 * b11 + r2 * b21;
        n[3 * row + 2] = r0 * b02 + r1 * b12 + r2 * b22;
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = n[i];
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < sp.P && sp.frame[k] == j + 1) {
          const float ox = sp.off[k][0], oy = sp.off[k][1], oz = sp.off[k][2];
          x[3 * k] = t[0] + r[0] * ox + r[1] * oy + r[2] * oz;
          x[3 * k + 1] = t[1] + r[3] * ox + r[4] * oy + r[5] * oz;
          x[3 * k + 2] = t[2] + r[6] * ox + r[7] * oy + r[8] * oz;
        }
      }
    }
  }
}

// Suffix-sum backward: with point gradients g_k = x_k * rowsum - su_k,
// dq_j = z_j . (sm - o_j x sg), where sg and sm sum g_k and x_k x g_k over
// the points on frames >= j (visited in descending k, as the TPU kernel).
template <int KP>
DIFFCO_HD void dh_backward(const DHSpec& sp, const float* x, const float* az,
                           const float* ao, float rowsum, const float* su,
                           float* dq) {
  float sgx = 0.f, sgy = 0.f, sgz = 0.f;
  float smx = 0.f, smy = 0.f, smz = 0.f;
#pragma unroll
  for (int j = kMaxJ; j >= 1; --j) {
    if (j <= sp.J) {
#pragma unroll
      for (int k = KP - 1; k >= 0; --k) {
        if (k < sp.P && sp.frame[k] == j) {
          const float px = x[3 * k], py = x[3 * k + 1], pz = x[3 * k + 2];
          const float gx = px * rowsum - su[3 * k];
          const float gy = py * rowsum - su[3 * k + 1];
          const float gz = pz * rowsum - su[3 * k + 2];
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

}  // namespace diffco
