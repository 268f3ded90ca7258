"""Core math utilities (PyTorch counterpart of ``diffco_tpu/utils.py``)."""
from __future__ import annotations

import math

import torch

PI = math.pi


def wrap2pi(theta):
    """Wrap angles to [-pi, pi)."""
    return torch.remainder(PI + theta, 2 * PI) - PI


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
