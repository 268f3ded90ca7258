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
the FK stays differentiable to higher orders in reverse mode. A float32
CUDA batch of a chain within the kernels' bounds runs the forward, and the
backward where no graph of the gradient is built, as one hand-written
kernel each (``csrc/dh_fk.cu``, ``takes_kernel``).

General (tree-topology, URDF) chains do not admit the prefix/suffix
factoring; ``make_chain_fkine`` sums over each point's static set of
moving ancestors instead (``chain_vjp`` / ``chain_jvp``), with revolute
joints about any axis, prismatic joints and mimic multipliers.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _native
from ..profiling import span
from .soa import (dh_rot_trans, rot_apply, rot_compose, rot_from_axis_angle,
                  stack_points, transform_compose, vec_add)

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


def takes_kernel(q, c, g=None) -> bool:
    """Whether ``_DHFkine`` runs ``q`` [B, J] on its kernels
    (``csrc/dh_fk.cu``): a float32 CUDA tensor whose rows are contiguous
    (a block of columns of a wider one too), of a chain with a by-value
    spec ``c`` (None past ``_native.MAX_J`` joints or ``MAX_P`` points).
    The backward (``g``, the point cotangents, given) only where no graph
    of the gradient is being built (``create_graph=True`` keeps the
    differentiable eager VJP) and ``g`` has storage: a cotangent batched
    by vmap, as ``torch.autograd.functional.jacobian(vectorize=True)``
    passes, has none and keeps the eager VJP, whose ops batch. The CPU,
    float64 and forward mode (``jvp``) stay on the eager ops."""
    return (c is not None and q.device.type == 'cuda'
            and q.dtype == torch.float32 and q.dim() == 2
            and q.stride(1) == 1
            and (g is None or (not torch.is_grad_enabled()
                               and torch._C._has_storage(g))))


def _dh_fk_kernel(q, c, g=None):
    """The FK x [B, 3P] of ``q`` [B, J] (``g`` None) or its VJP dq [B, J]
    with point cotangents ``g`` [B, 3P], on ``csrc/dh_fk.cu``: one launch
    on the current stream (none for an empty batch), counted in
    ``launches.dh_fk`` or ``launches.dh_fk_vjp`` (``_native.launch``)."""
    if q.shape[1] != c.J:
        raise ValueError(f'dh_fk: q has {q.shape[1]} columns, the chain '
                         f'{c.J} joints')
    B = q.shape[0]
    out = q.new_empty((B, 3 * c.P) if g is None else (B, c.J))
    if B == 0:
        return out
    if g is None:
        name, ptrs = 'dh_fk', (q.data_ptr(), q.stride(0), out.data_ptr())
    else:
        name, g = 'dh_fk_vjp', g.contiguous()
        _native.check_cuda_inputs(name, g)
        if g.device != q.device or g.shape != (B, 3 * c.P):
            raise ValueError(f'dh_fk_vjp: g {tuple(g.shape)} on {g.device} '
                             f'for {B} rows of {c.P} points on {q.device}')
        ptrs = (q.data_ptr(), q.stride(0), g.data_ptr(), out.data_ptr())
    _native.launch('dh_fk', name, *ptrs, B, ctypes.byref(c),
                   torch.cuda.current_stream(q.device).cuda_stream)
    return out


class _DHFkine(torch.autograd.Function):
    """q [B, J] -> control points [B, 3P] with analytic VJP and JVP; the
    forward and the VJP on ``csrc/dh_fk.cu`` where ``takes_kernel``."""

    @staticmethod
    def forward(q, st, c):
        with span('diffco.robots.fk'):
            if takes_kernel(q, c):
                return _dh_fk_kernel(q, c)
            _, pts = dh_chain(st, q)
            return stack_points(pts, flat=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, st, c = inputs
        ctx.st, ctx.c = st, c
        ctx.save_for_backward(q)
        ctx.save_for_forward(q)

    @staticmethod
    def backward(ctx, g):
        with span('diffco.robots.fk_vjp'):
            q, = ctx.saved_tensors
            if takes_kernel(q, ctx.c, g):
                return _dh_fk_kernel(q, ctx.c, g), None, None
            axes, pts = dh_chain(ctx.st, q)
            return dh_vjp(ctx.st, axes, pts, g), None, None

    @staticmethod
    def jvp(ctx, dq, _st, _c):
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

    The chain's by-value kernel spec (``_native.dh_spec``, None past the
    kernels' bounds) is built once here and kept as ``fkine_flat.dh_spec``.
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

    c = _native.dh_spec(st)

    def fkine_flat(q):
        return _DHFkine.apply(q, st, c)

    fkine_flat.statics = st
    fkine_flat.dh_spec = c
    return fkine_flat


# ---------------------------------------------------------------------------
# general (tree-topology) chains: the URDF counterpart of the DH chain above

# joint-type codes mirrored from kinematics.py (import cycle avoidance)
_FIXED, _REVOLUTE, _PRISMATIC = 0, 1, 2


class ChainStatics(NamedTuple):
    """Hashable static chain description (nested float tuples): the FK's
    constants, and the key under which the B3 kernel's folded spec is
    cached (ops/fk_score.py)."""
    parent: Tuple          # per link, -1 for the root
    jtype: Tuple           # per link: _FIXED / _REVOLUTE / _PRISMATIC
    axis: Tuple            # per link (x, y, z)
    f_rot: Tuple           # per link, 9 floats row-major
    f_trans: Tuple         # per link, 3 floats
    dof_idx: Tuple         # per link, -1 for fixed links
    m_mult: Tuple          # per link mimic multiplier
    m_off: Tuple           # per link mimic offset
    base_rot: Tuple        # 9 floats
    base_trans: Tuple      # 3 floats
    point_specs: Tuple     # per point (link index, (ox, oy, oz))
    point_chains: Tuple    # per point, its moving ancestors (root first)
    n_dofs: int


def chain_statics(spec, point_specs, base=None) -> ChainStatics:
    """Everything static of a ChainSpec + point specs + optional base
    ``(rot 3x3, trans 3)`` as nested float tuples."""
    point_specs = tuple((int(li), tuple(float(v) for v in off))
                        for li, off in point_specs)
    parent = tuple(int(p) for p in spec.parent)
    jtype = tuple(int(t) for t in spec.jtype)
    if base is not None:
        base_rot = tuple(float(v) for v in np.asarray(base[0]).reshape(-1))
        base_trans = tuple(float(v) for v in np.asarray(base[1]))
    else:
        base_rot, base_trans = _IDENT9, _ZERO3

    # moving ancestors of a link, itself included: its own joint moves
    # every point attached to it
    def _moving_chain(li):
        chain = []
        while li >= 0:
            if jtype[li] != _FIXED:
                chain.append(li)
            li = parent[li]
        return tuple(reversed(chain))

    return ChainStatics(
        parent, jtype,
        tuple(tuple(float(v) for v in a) for a in spec.axis),
        tuple(tuple(float(v) for v in np.asarray(r).reshape(-1))
              for r in spec.fixed_rot),
        tuple(tuple(float(v) for v in t) for t in spec.fixed_trans),
        tuple(int(d) for d in spec.dof_idx),
        tuple(float(m) for m in spec.mimic_mult),
        tuple(float(o) for o in spec.mimic_offset),
        base_rot, base_trans, point_specs,
        tuple(_moving_chain(li) for li, _ in point_specs),
        int(spec.n_dofs))


def eval_chain(cs: ChainStatics, q):
    """SoA chain FK: q [B, D] -> (joints {link: (world axis, world
    origin)} of every moving joint, points [(x, y, z)] of [B] tensors).

    A revolute joint composes ``f_rot @ R(axis, theta)``; its world axis
    is ``R_world @ axis`` and its origin the link's world origin. A
    prismatic joint slides along ``f_rot @ axis``, whose world direction
    is ``R_parent @ f_rot @ axis``. ``theta = q[dof] * mult + off``.
    Points under all-fixed subtrees are constants, broadcast to [B].
    """
    zb = torch.zeros_like(q[:, 0])
    L = len(cs.parent)
    rots, trans = [None] * L, [None] * L
    joints = {}
    for i in range(L):
        jt = cs.jtype[i]
        if jt == _FIXED:
            j_rot, j_trans = cs.f_rot[i], cs.f_trans[i]
        else:
            th = q[:, cs.dof_idx[i]] * cs.m_mult[i] + cs.m_off[i]
            if jt == _REVOLUTE:
                j_rot = rot_compose(cs.f_rot[i],
                                    rot_from_axis_angle(cs.axis[i], th))
                j_trans = cs.f_trans[i]
            else:  # PRISMATIC: slide along the (fixed-rotated) axis
                ax = rot_apply(cs.f_rot[i], cs.axis[i])  # constant floats
                j_rot = cs.f_rot[i]
                j_trans = (cs.f_trans[i][0] + ax[0] * th,
                           cs.f_trans[i][1] + ax[1] * th,
                           cs.f_trans[i][2] + ax[2] * th)
        p = cs.parent[i]
        if p < 0:
            pr, pt = cs.base_rot, cs.base_trans
        else:
            pr, pt = rots[p], trans[p]
        rots[i], trans[i] = transform_compose(pr, pt, j_rot, j_trans)
        if jt == _REVOLUTE:
            # the axis is invariant under its own rotation
            joints[i] = (rot_apply(rots[i], cs.axis[i]), trans[i])
        elif jt == _PRISMATIC:
            joints[i] = (rot_apply(pr, rot_apply(cs.f_rot[i], cs.axis[i])),
                         trans[i])
    pts = []
    for li, off in cs.point_specs:
        p = trans[li] if off == _ZERO3 else vec_add(
            trans[li], rot_apply(rots[li], off))
        pts.append(tuple(zb + c for c in p))
    return joints, pts


def chain_vjp(cs: ChainStatics, joints, pts, g):
    """Moving-ancestor VJP: point cotangents g [B, 3P] -> dq [B, D] with
    ``dq[dof_i] += m_i (z_i x (p_k - o_i)) . g_k`` (revolute i) or
    ``m_i z_i . g_k`` (prismatic i) over each point's moving ancestors."""
    zero = torch.zeros_like(g[:, 0])
    dq = [zero] * cs.n_dofs
    for k, chain in enumerate(cs.point_chains):
        gk = (g[:, 3 * k], g[:, 3 * k + 1], g[:, 3 * k + 2])
        p = pts[k]
        for i in chain:
            z, o = joints[i]
            if cs.jtype[i] == _REVOLUTE:
                c = _cross(z, (p[0] - o[0], p[1] - o[1], p[2] - o[2]))
            else:
                c = z
            val = c[0] * gk[0] + c[1] * gk[1] + c[2] * gk[2]
            d = cs.dof_idx[i]
            dq[d] = dq[d] + cs.m_mult[i] * val
    return torch.stack(dq, dim=-1)


def chain_jvp(cs: ChainStatics, joints, pts, dq):
    """Moving-ancestor JVP: joint tangents dq [B, D] -> point tangents
    [B, 3P], ``dp_k = sum_i dth_i (z_i x (p_k - o_i))`` (revolute) or
    ``dth_i z_i`` (prismatic), ``dth_i = m_i dq[dof_i]``."""
    zero = torch.zeros_like(dq[:, 0])
    cols = []
    for k, chain in enumerate(cs.point_chains):
        p = pts[k]
        d = [zero, zero, zero]
        for i in chain:
            z, o = joints[i]
            dth = dq[:, cs.dof_idx[i]] * cs.m_mult[i]
            if cs.jtype[i] == _REVOLUTE:
                c = _cross(z, (p[0] - o[0], p[1] - o[1], p[2] - o[2]))
            else:
                c = z
            d = [d[0] + dth * c[0], d[1] + dth * c[1], d[2] + dth * c[2]]
        cols.extend(d)
    return torch.stack(cols, dim=-1)


class _ChainFkine(torch.autograd.Function):
    """q [B, D] -> points [B, 3P] of a general chain, with the analytic
    VJP and JVP (both recompute the chain from q with differentiable ops,
    so the FK stays differentiable to higher orders)."""

    @staticmethod
    def forward(q, cs):
        with span('diffco.robots.fk'):
            _, pts = eval_chain(cs, q)
            return stack_points(pts, flat=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, cs = inputs
        ctx.cs = cs
        ctx.save_for_backward(q)
        ctx.save_for_forward(q)

    @staticmethod
    def backward(ctx, g):
        with span('diffco.robots.fk_vjp'):
            q, = ctx.saved_tensors
            joints, pts = eval_chain(ctx.cs, q)
            return chain_vjp(ctx.cs, joints, pts, g), None

    @staticmethod
    def jvp(ctx, dq, _):
        q, = ctx.saved_tensors
        joints, pts = eval_chain(ctx.cs, q)
        return chain_jvp(ctx.cs, joints, pts, dq)


def make_chain_fkine(spec, point_specs: Sequence[Tuple[int, Tuple[float,
                                                                  float,
                                                                  float]]],
                     base: Optional[Tuple] = None):
    """General (tree-topology) chain FK ``q [B, D] -> pts [B, 3 * P]``
    with the analytic geometric-Jacobian VJP and JVP: the URDF
    counterpart of :func:`make_dh_fkine`.

    point_specs: ``(link_idx, (ox, oy, oz))`` offsets in the link frame
    (control points and collision-sphere centers alike). base: optional
    ``(rot 3x3, trans 3)`` applied at the root.
    """
    cs = chain_statics(spec, point_specs, base)

    def fkine_flat(q):
        return _ChainFkine.apply(q, cs)

    fkine_flat.statics = cs
    return fkine_flat
