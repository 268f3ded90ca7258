"""Analytic geometric-Jacobian derivatives for batched DH-chain FK.

For a revolute chain ``dp/dtheta_j = z_j x (p - o_j)``, where ``z_j`` and
``o_j`` are the world axis and origin of joint j *before* its rotation and
``p`` is any point rigidly attached downstream. Both AD modes factor
through sums over the chain:

* forward (JVP), prefix sums over joints::

      dp_k = W_{f(k)} x p_k - V_{f(k)},  W_f = sum_{j<=f} dq_j z_j,
                                         V_f = sum_{j<=f} dq_j (z_j x o_j)

* reverse (VJP), suffix sums over points (frame ids non-decreasing)::

      dq_j = z_j . (sm_j - o_j x sg_j),  sg_j = sum_{f(k)>=j} g_k,
                                         sm_j = sum_{f(k)>=j} p_k x g_k

``make_dh_fkine`` wraps both in one ``torch.autograd.Function``. Its
``backward`` recomputes the chain from ``q`` with differentiable ops, so
the FK stays differentiable to higher orders in reverse mode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .soa import dh_rot_trans, stack_points, transform_compose

_ZERO3 = (0.0, 0.0, 0.0)
_IDENT9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


class DHStatics(NamedTuple):
    """Constant description of a DH chain and its control points."""
    dh_const: Tuple      # per joint (a, d, sin_alpha, cos_alpha, theta0)
    point_specs: Tuple   # per point (1-based frame id, (ox, oy, oz))
    base_rot: Tuple      # 9 floats
    base_trans: Tuple    # 3 floats

    @property
    def n_joints(self) -> int:
        return len(self.dh_const)

    @property
    def frame_ids(self):
        return [fi for fi, _ in self.point_specs]


def dh_chain(st: DHStatics, q):
    """Per-joint (axis, origin) before each rotation and the world control
    points, all SoA tuples of [B] tensors (or floats for the base)."""
    r_acc, t_acc = st.base_rot, st.base_trans
    axes, frames = [], []
    for i, (a, d, sa, ca, th) in enumerate(st.dh_const):
        axes.append(((r_acc[2], r_acc[5], r_acc[8]), t_acc))
        r_j, t_j = dh_rot_trans(q[:, i] + th, a, d, sa, ca)
        r_acc, t_acc = transform_compose(r_acc, t_acc, r_j, t_j)
        frames.append((r_acc, t_acc))
    pts = []
    for fi, (ox, oy, oz) in st.point_specs:
        r, t = frames[fi - 1]
        if (ox, oy, oz) == _ZERO3:
            pts.append(t)
        else:
            pts.append((t[0] + r[0] * ox + r[1] * oy + r[2] * oz,
                        t[1] + r[3] * ox + r[4] * oy + r[5] * oz,
                        t[2] + r[6] * ox + r[7] * oy + r[8] * oz))
    return axes, pts


def dh_vjp(st: DHStatics, axes, pts, g):
    """Suffix-sum VJP: point cotangents g [B, 3P] -> dq [B, J]."""
    zero = torch.zeros_like(g[:, 0])
    sg = (zero, zero, zero)
    sm = (zero, zero, zero)
    frame_ids = st.frame_ids
    k = len(pts) - 1
    dq = [None] * st.n_joints
    for j in range(st.n_joints, 0, -1):
        while k >= 0 and frame_ids[k] >= j:
            gk = (g[:, 3 * k], g[:, 3 * k + 1], g[:, 3 * k + 2])
            cx, cy, cz = _cross(pts[k], gk)
            sm = (sm[0] + cx, sm[1] + cy, sm[2] + cz)
            sg = (sg[0] + gk[0], sg[1] + gk[1], sg[2] + gk[2])
            k -= 1
        z, o = axes[j - 1]
        ox_, oy_, oz_ = _cross(o, sg)
        dq[j - 1] = (z[0] * (sm[0] - ox_) + z[1] * (sm[1] - oy_)
                     + z[2] * (sm[2] - oz_))
    return torch.stack(dq, dim=-1)


def dh_jvp(st: DHStatics, axes, pts, dq):
    """Prefix-sum JVP: joint tangents dq [B, J] -> point tangents [B, 3P]."""
    zero = torch.zeros_like(dq[:, 0])
    w = (zero, zero, zero)          # sum dq_j z_j
    v = (zero, zero, zero)          # sum dq_j (z_j x o_j)
    prefix = []
    for j in range(st.n_joints):
        z_j, o_j = axes[j]
        dqj = dq[:, j]
        cx, cy, cz = _cross(z_j, o_j)
        w = (w[0] + dqj * z_j[0], w[1] + dqj * z_j[1], w[2] + dqj * z_j[2])
        v = (v[0] + dqj * cx, v[1] + dqj * cy, v[2] + dqj * cz)
        prefix.append((w, v))
    cols = []
    for k, fi in enumerate(st.frame_ids):
        w, v = prefix[fi - 1]
        dx, dy, dz = _cross(w, pts[k])
        cols.extend((dx - v[0], dy - v[1], dz - v[2]))
    return torch.stack(cols, dim=-1)


class _DHFkine(torch.autograd.Function):
    """q [B, J] -> control points [B, 3P] with analytic VJP and JVP."""

    @staticmethod
    def forward(q, st):
        _, pts = dh_chain(st, q)
        return stack_points(pts, flat=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, st = inputs
        ctx.st = st
        ctx.save_for_backward(q)
        ctx.save_for_forward(q)

    @staticmethod
    def backward(ctx, g):
        q, = ctx.saved_tensors
        axes, pts = dh_chain(ctx.st, q)
        return dh_vjp(ctx.st, axes, pts, g), None

    @staticmethod
    def jvp(ctx, dq, _):
        q, = ctx.saved_tensors
        axes, pts = dh_chain(ctx.st, q)
        return dh_jvp(ctx.st, axes, pts, dq)


def make_dh_fkine(dh_const: Sequence[Tuple[float, float, float, float,
                                           float]],
                  point_specs: Sequence[Tuple[int, Tuple[float, float,
                                                         float]]],
                  base: Optional[Tuple[Tuple, Tuple]] = None):
    """Build a flat-output DH-chain FK ``q [B, J] -> pts [B, 3 * P]`` with
    the analytic VJP (``backward``) and JVP (``jvp``).

    dh_const: per-joint ``(a, d, sin_alpha, cos_alpha, theta_offset)``.
    point_specs: ``(frame_idx, (ox, oy, oz))`` per control point: 1-based
        frame index in chain order (non-decreasing) and an offset in that
        frame.
    base: optional base transform ``(rot 9 floats, trans 3 floats)``.
    """
    dh_const = tuple(tuple(float(v) for v in row) for row in dh_const)
    point_specs = tuple((int(fi), tuple(float(v) for v in off))
                        for fi, off in point_specs)
    frame_ids = [fi for fi, _ in point_specs]
    assert frame_ids == sorted(frame_ids), 'points must follow chain order'
    assert all(1 <= fi <= len(dh_const) for fi in frame_ids)
    if base is None:
        st = DHStatics(dh_const, point_specs, _IDENT9, _ZERO3)
    else:
        st = DHStatics(dh_const, point_specs,
                       tuple(float(v) for v in base[0]),
                       tuple(float(v) for v in base[1]))

    def fkine_flat(q):
        return _DHFkine.apply(q, st)

    fkine_flat.statics = st
    return fkine_flat
