"""Core math utilities (PyTorch counterpart of ``diffco_tpu/utils.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def wrap2pi(theta):
    """Wrap angles to [-pi, pi)."""
    return torch.remainder(PI + theta, 2 * PI) - PI


def se2_wrap2pi(x):
    """Wrap only the angular (third) component of SE(2) configurations
    [..., 3]."""
    return torch.cat([x[..., :2], wrap2pi(x[..., 2:3])], dim=-1)


def rot_2d(phi):
    """Batched 2-D rotation matrices: phi [...] -> [..., 2, 2]."""
    phi = torch.as_tensor(phi)
    s, c = torch.sin(phi), torch.cos(phi)
    return torch.stack([torch.stack([c, -s], -1),
                        torch.stack([s, c], -1)], -2)


def anglin(q1, q2, num: int = 50, endpoint: bool = True):
    """Wrap-aware linspace between angle vectors q1, q2 [dof] ->
    [num, dof], float32 (``jnp.linspace``'s arithmetic: start + i *
    step, the end exactly with ``endpoint``)."""
    q1 = torch.as_tensor(q1, dtype=torch.float32)
    q2 = torch.as_tensor(q2, dtype=torch.float32, device=q1.device)
    delta = wrap2pi(q2 - q1)
    div = (num - 1) if endpoint else num
    i = torch.arange(num, dtype=torch.float32, device=q1.device)[:, None]
    dq = i * (delta / max(div, 1))
    if endpoint and num > 1:
        dq[-1] = delta
    return wrap2pi(q1 + dq)


def make_continue(q, max_gap=PI):
    """Unwrap a path of joint angles [N, dof] so that adjacent waypoints
    are numerically adjacent (for plotting)."""
    q = torch.as_tensor(q)
    diff = q[1:] - q[:-1]
    sudden = torch.where(diff.abs() > max_gap, torch.sign(diff),
                         torch.zeros_like(diff))
    sudden = torch.cat([torch.zeros_like(q[:1]), sudden], dim=0)
    return q - torch.cumsum(sudden, dim=0) * 2 * PI


def axis_angle_mat(axis, angle):
    """Rodrigues rotation of ``angle`` about the unit ``axis``:
    axis [..., 3], angle [...] -> [..., 3, 3]."""
    axis = torch.as_tensor(axis)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    s, c = torch.sin(angle), torch.cos(angle)
    C = 1.0 - c
    return torch.stack([
        torch.stack([x * x * C + c, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, y * y * C + c, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, z * z * C + c], -1),
    ], -2)


def DH2mat(q, a, d, s_alpha, c_alpha):
    """Batched standard-DH transform matrices.

    q: [..., dof] joint angles (theta); a/d/s_alpha/c_alpha: [dof].
    Returns [..., dof, 4, 4].
    """
    c_t, s_t = torch.cos(q), torch.sin(q)
    zeros = torch.zeros_like(q)
    ones = torch.ones_like(q)
    a, d, s_alpha, c_alpha = (torch.as_tensor(v, dtype=q.dtype,
                                              device=q.device).expand_as(q)
                              for v in (a, d, s_alpha, c_alpha))
    row0 = torch.stack([c_t, -s_t * c_alpha, s_t * s_alpha, a * c_t], -1)
    row1 = torch.stack([s_t, c_t * c_alpha, -c_t * s_alpha, a * s_t], -1)
    row2 = torch.stack([zeros, s_alpha, c_alpha, d], -1)
    row3 = torch.stack([zeros, zeros, zeros, ones], -1)
    return torch.stack([row0, row1, row2, row3], -2)


def dense_path(q, num_sub: int):
    """Fixed-shape path densification.

    Interpolates ``num_sub`` points per segment (each segment's start
    included, the last waypoint appended once): ``[..., N, dof]`` ->
    ``[..., (N - 1) * num_sub + 1, dof]``. Leading dimensions are batch
    (e.g. the restarts of a trajectory optimization).
    """
    n_seg = q.shape[-2] - 1
    fr = torch.arange(num_sub, dtype=q.dtype, device=q.device) / num_sub
    seg_start = q[..., :-1, :]
    delta = q[..., 1:, :] - q[..., :-1, :]
    pts = (seg_start[..., :, None, :]
           + fr[:, None] * delta[..., :, None, :])
    pts = pts.reshape(q.shape[:-2] + (n_seg * num_sub, q.shape[-1]))
    return torch.cat([pts, q[..., -1:, :]], dim=-2)


def rotz(phi):
    """Batched rotation about z: phi [...] -> [..., 3, 3]."""
    phi = torch.as_tensor(phi)
    s, c = torch.sin(phi), torch.cos(phi)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def roty(phi):
    """Batched rotation about y: phi [...] -> [..., 3, 3]."""
    phi = torch.as_tensor(phi)
    s, c = torch.sin(phi), torch.cos(phi)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def rotx(phi):
    """Batched rotation about x: phi [...] -> [..., 3, 3]."""
    phi = torch.as_tensor(phi)
    s, c = torch.sin(phi), torch.cos(phi)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    return torch.stack([torch.stack([o, z, z], -1),
                        torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2)


def matmul_f32(a, b):
    """a [..., n, k] @ b [..., k, m] as explicit products summed over k,
    for the small rotation and transform compositions: full float32 on
    every device, where a CUDA matrix product may round its operands to
    TF32 (the JAX package's ``precision='highest'``)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def euler2mat(phi):
    """Roll-pitch-yaw (x, y, z) Euler angles -> rotation matrices:
    phi [..., 3] -> Rz(yaw) @ Ry(pitch) @ Rx(roll) [..., 3, 3]."""
    return matmul_f32(matmul_f32(rotz(phi[..., 2]), roty(phi[..., 1])),
                      rotx(phi[..., 0]))


def transform_points(rot, trans, points):
    """Rigid transform(s) of points: rot [..., 3, 3] @ p + trans [..., 3],
    points [..., M, 3] -> [..., M, 3]."""
    return (torch.sum(rot[..., None, :, :] * points[..., :, None, :], dim=-1)
            + trans[..., None, :])


def look_mat4(rot, trans):
    """Pack (rot [..., 3, 3], trans [..., 3]) into homogeneous
    transforms [..., 4, 4]."""
    bottom = rot.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        rot.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([rot, trans[..., :, None]], dim=-1), bottom],
                     dim=-2)


def _segment_scores(scores, batch_dims: int, xp):
    """Scores as ``[*batch, M]``: a multi-output ``[*batch, M, C...]``
    collapses with max over its trailing dimensions."""
    s = torch.as_tensor(scores) if xp is torch else xp.asarray(scores)
    if s.ndim > batch_dims + 1:
        s = s.reshape(tuple(s.shape[:batch_dims + 1]) + (-1,))
        s = s.amax(-1) if xp is torch else s.max(-1)
    return s


def segment_violations(scores, n_segments: int, num_sub: int,
                       safety_margin=0.0, xp=torch, batch_dims: int = 0):
    """Per-segment summed collision violations, the trajectory
    optimizers' constraint: each segment owns its start point and its
    ``num_sub - 1`` interior points, the global start (excluded from the
    scores) counts as zero.

    scores: the score on ``dense_path(p, num_sub)[..., 1:-1, :]``, flat
    ``[*batch, n_segments * num_sub - 1]`` or multi-output
    ``[*batch, n_segments * num_sub - 1, C]`` (the most violating class
    governs), with ``batch_dims`` leading batch dimensions (the restarts
    of a trajectory optimization). ``xp`` is ``torch`` or ``numpy`` (the
    host scipy loops). Returns ``[*batch, n_segments]``.
    """
    s = _segment_scores(scores, batch_dims, xp)
    if xp is torch:
        viol = torch.clamp(s - safety_margin, min=0.0)
        viol = torch.cat([viol.new_zeros(viol.shape[:-1] + (1,)), viol], -1)
    else:
        viol = xp.maximum(s - safety_margin, 0.0)
        viol = xp.concatenate([xp.zeros(viol.shape[:-1] + (1,), viol.dtype),
                               viol], -1)
    return viol.reshape(viol.shape[:-1] + (n_segments, num_sub)).sum(-1)


def segment_max_scores(scores, n_segments: int, num_sub: int, xp=torch,
                       batch_dims: int = 0):
    """Per-segment maximum score, with the segment ownership of
    ``segment_violations`` (the excluded global start counts as -inf).
    ``margin - segment_max_scores(...) >= 0`` is the same feasible set as
    ``-segment_violations(...) >= 0`` but keeps a nonzero Jacobian on and
    inside the boundary, where the clamped sum is identically zero.
    Returns ``[*batch, n_segments]``."""
    s = _segment_scores(scores, batch_dims, xp)
    if xp is torch:
        s = torch.cat([s.new_full(s.shape[:-1] + (1,), -math.inf), s], -1)
        return s.reshape(s.shape[:-1] + (n_segments, num_sub)).amax(-1)
    s = xp.concatenate([xp.full(s.shape[:-1] + (1,), -xp.inf, s.dtype), s],
                       -1)
    return s.reshape(s.shape[:-1] + (n_segments, num_sub)).max(-1)


def dense_path_params(q, max_step: float,
                      max_dense_waypoints: int | None = None) -> int:
    """The per-segment subdivision count for ``dense_path`` that keeps
    every sub-step of the path q [N, dof] within ``max_step`` (host side;
    with ``max_dense_waypoints`` the step grows to at least the path's
    length over that many points)."""
    qn = q.detach().cpu().numpy() if torch.is_tensor(q) else np.asarray(q)
    seg_len = np.linalg.norm(qn[1:] - qn[:-1], axis=-1)
    if max_dense_waypoints is not None:
        max_step = max(max_step, float(seg_len.sum()) / max_dense_waypoints)
    num_sub = int(np.ceil(seg_len.max() / max_step)) if len(seg_len) else 1
    return max(num_sub, 1)
