"""Penalty-method Adam over waypoint paths, the trajectory optimizer's
mathematics: the loss of each restart's path and optax.adam's update.

loss(p) = diff + 10 (collision + max_move + joint_limit), per path p [N,
dof]: diff sums the squared moves of every control point between
waypoints; collision sums max(score - margin, 0) over the path cut into
``dense_sub`` parts a segment, endpoints left out; max_move sums
max(|move|^2 - max_speed^2, 0) over every point's moves; joint_limit sums
how far the waypoints lie past the limits. The endpoints stay fixed.
"""
from __future__ import annotations

import torch

from .fk import dh_points

B1, B2, EPS = 0.9, 0.999, 1e-8


def dense(p, n: int):
    """[..., N, dof] -> [..., (N - 1) n + 1, dof], each segment's start and
    n - 1 points after it, the last waypoint once."""
    fr = torch.arange(n, dtype=p.dtype, device=p.device) / n
    pts = p[..., :-1, None, :] + fr[:, None] * (p[..., 1:, None, :]
                                                - p[..., :-1, None, :])
    pts = pts.reshape(p.shape[:-2] + (-1, p.shape[-1]))
    return torch.cat([pts, p[..., -1:, :]], -2)


def checked(p, dense_sub: int):
    """The configurations whose scores enter the collision term: [T, M,
    dof]."""
    return (dense(p, dense_sub) if dense_sub > 1 else p)[:, 1:-1]


def terms(p, score, robot: dict, limits, margin: float, max_speed: float,
          dense_sub: int):
    """(diff, collision, max_move, joint_limit), each [T]."""
    T, N, dof = p.shape
    pc = checked(p, dense_sub)
    s = score(pc.reshape(-1, dof)).reshape(T, -1)
    collision = (s - margin).clamp(min=0).sum(-1)
    cp = dh_points(p.reshape(T * N, dof), robot).reshape(T, N, -1, 3)
    seg2 = ((cp[:, 1:] - cp[:, :-1]) ** 2).sum(-1)
    max_move = (seg2 - max_speed ** 2).clamp(min=0).sum((1, 2))
    lo, hi = limits[:, 0], limits[:, 1]
    joint_limit = ((lo - p).clamp(min=0) + (p - hi).clamp(min=0)).sum((1, 2))
    return seg2.sum((1, 2)), collision, max_move, joint_limit


def loss(p, score, robot, limits, margin, max_speed, dense_sub):
    diff, col, mm, jl = terms(p, score, robot, limits, margin, max_speed,
                              dense_sub)
    return diff + 10.0 * (col + mm + jl)


def initial_paths(starts, targets, draws, limits):
    """Restart paths [P, T, N, dof]: uniform in the limits from ``draws``
    (uniform [0, 1) numbers), restart 0 the straight line, every path's
    endpoints the problem's."""
    lo, hi = limits[:, 0], limits[:, 1]
    N = draws.shape[2]
    p = draws * (hi - lo) + lo
    i = torch.arange(N, dtype=starts.dtype, device=starts.device)
    line = starts[:, None] + i[None, :, None] * (
        (targets - starts) / (N - 1))[:, None]
    line[:, -1] = targets
    p[:, 0] = line
    p[:, :, 0] = starts[:, None]
    p[:, :, -1] = targets[:, None]
    return p


def steps(p0, score, robot, limits, margin, max_speed, dense_sub, lr,
          n_steps):
    """The paths after each of ``n_steps`` Adam steps from p0 [T, N, dof]:
    a list of n_steps + 1 paths, and the gradient of the first step."""
    mask = torch.ones(p0.shape[1], 1, dtype=p0.dtype, device=p0.device)
    mask[0] = mask[-1] = 0
    mu = torch.zeros_like(p0)
    nu = torch.zeros_like(p0)
    out, g0 = [p0], None
    p = p0
    for c in range(1, n_steps + 1):
        pv = p.detach().requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(
                loss(pv, score, robot, limits, margin, max_speed,
                     dense_sub).sum(), pv)
        g = g * mask
        g0 = g if g0 is None else g0
        mu = (1 - B1) * g + B1 * mu
        nu = (1 - B2) * g ** 2 + B2 * nu
        upd = -lr * (mu / (1 - B1 ** c)) / (torch.sqrt(nu / (1 - B2 ** c))
                                            + EPS)
        p = (p + upd).detach()
        out.append(p)
    return out, g0
