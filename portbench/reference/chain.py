"""A serial chain of revolute joints from a configuration file's joint
table (``robot.chain``: per joint its origin ``xyz`` and ``rpy`` in its
parent's frame, its ``axis`` and its ``type``; ``robot.points``): the
control points of each configuration, the capsule-chain ground truth
along them and the polyharmonic proxy over their features, as
``fk.py``, ``scene.py`` and ``proxy.py`` give them for a DH arm.

Every product runs with TF32 off: the precision the configuration states.
"""
from __future__ import annotations

import torch

from . import proxy
from .scene import shape_sdf

REVOLUTE = ('revolute', 'continuous')


def _rpy(rpy, dtype, device):
    """The URDF origin's rotation Rz(yaw) Ry(pitch) Rx(roll), [3, 3]."""
    r, p, y = (torch.tensor(float(v), dtype=dtype, device=device)
               for v in rpy)
    o, z = torch.ones((), dtype=dtype, device=device), torch.zeros(
        (), dtype=dtype, device=device)
    rx = torch.stack([torch.stack([o, z, z]),
                      torch.stack([z, r.cos(), -r.sin()]),
                      torch.stack([z, r.sin(), r.cos()])])
    ry = torch.stack([torch.stack([p.cos(), z, p.sin()]),
                      torch.stack([z, o, z]),
                      torch.stack([-p.sin(), z, p.cos()])])
    rz = torch.stack([torch.stack([y.cos(), -y.sin(), z]),
                      torch.stack([y.sin(), y.cos(), z]),
                      torch.stack([z, z, o])])
    return rz @ ry @ rx


def _rodrigues(axis, angle):
    """Rotations about the unit ``axis`` [3] by ``angle`` [B]: I + sin(a) K
    + (1 - cos(a)) K^2, K the axis's cross-product matrix. [B, 3, 3]."""
    x, y, z = axis
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y]),
                     torch.stack([z, zero, -x]),
                     torch.stack([-y, x, zero])])
    s, c = angle.sin()[:, None, None], angle.cos()[:, None, None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1 - c) * (K @ K)


def chain_points(q, robot: dict):
    """q [B, dof] -> control points [B, P, 3] in q's dtype and device.

    Joint i (in order, column i of q) ends frame i: R <- R Rrpy_i
    Rot(axis_i, q_i), t <- t + R_parent xyz_i, from the world frame 0. A
    point ``[k, [x, y, z]]`` is the offset placed in frame k (k >= 1)."""
    dt, dev = q.dtype, q.device
    B = q.shape[0]
    R = torch.eye(3, dtype=dt, device=dev).expand(B, 3, 3)
    t = torch.zeros(B, 3, dtype=dt, device=dev)
    frames = []
    with proxy.matmul_precision(False):
        for i, j in enumerate(robot['chain']):
            if j['type'] not in REVOLUTE:
                raise ValueError(f'joint {i + 1}: type {j["type"]!r}; the '
                                 'reference takes revolute joints')
            axis = torch.tensor(j['axis'], dtype=dt, device=dev)
            xyz = torch.tensor(j['xyz'], dtype=dt, device=dev)
            t = t + R @ xyz
            R = R @ _rpy(j['rpy'], dt, dev) @ _rodrigues(
                axis / torch.linalg.vector_norm(axis), q[:, i])
            frames.append((R, t))
        pts = []
        for k, off in robot['points']:
            Rk, tk = frames[k - 1]
            pts.append(tk + Rk @ torch.tensor(off, dtype=dt, device=dev))
    return torch.stack(pts, 1)


def features(q, robot: dict):
    """The proxy's features of q [B, dof]: its control points flattened,
    [B, 3P]."""
    return chain_points(q, robot).reshape(q.shape[0], -1)


def chain_spheres(q, robot: dict, gt: dict):
    """Sphere centres [B, n, 3]: the base origin and the control points,
    each segment cut into ``per_seg`` equal parts, the last point once
    (``scene.chain_spheres`` over this chain's points)."""
    cp = chain_points(q, robot)
    cp = torch.cat([torch.zeros_like(cp[:, :1]), cp], 1)
    n = gt['per_seg']
    fr = torch.arange(n, dtype=q.dtype, device=q.device) / n
    seg = cp[:, 1:] - cp[:, :-1]
    pts = cp[:, :-1, None] + fr[None, None, :, None] * seg[:, :, None]
    return torch.cat([pts.reshape(q.shape[0], -1, 3), cp[:, -1:]], 1)


def signed_dist(q, robot: dict, gt: dict, scene: dict):
    """The deepest penetration of any chain sphere into any shape: [B],
    positive in collision."""
    c = chain_spheres(q, robot, gt)
    sd = torch.stack([gt['link_radius'] - shape_sdf(c, s)
                      for s in scene.values()], -1)
    return sd.amax(dim=(1, 2))


def labels(q, robot: dict, gt: dict, scene: dict):
    """+1 in collision, -1 free, in q's dtype."""
    return (signed_dist(q, robot, gt, scene) > 0).to(q.dtype) * 2 - 1


def score(q, robot: dict, s, w, epsilon: float, tf32: bool = False):
    """The proxy's scores [B] of configurations q [B, dof] over support
    features s [S, 3P] with weights w [S] (differentiable in q)."""
    return proxy.phi(features(q, robot), s, epsilon, tf32) @ w


class Proxy(proxy.Proxy):
    """``proxy.Proxy`` over this chain's features and ground truth: the
    proxy over support configurations ``support_q`` [S, dof], labelled in
    ``scene_shapes``, built in ``dtype``."""

    def __init__(self, support_q, config: dict, scene_shapes: dict,
                 dtype=torch.float64, tf32: bool = False):
        self.config, self.dtype, self.tf32 = config, dtype, tf32
        self.eps = float(config['checker']['epsilon'])
        robot = config['robot']
        q = support_q.to(dtype)
        self.s = features(q, robot)
        self.y = labels(q.double(), robot, config['ground_truth'],
                        scene_shapes).to(dtype)
        self.w = torch.linalg.solve(
            proxy.phi(self.s, self.s, self.eps, tf32), self.y)

    def score(self, q):
        """Scores [B] of configurations q [B, dof] (differentiable in q)."""
        return score(q.to(self.dtype), self.config['robot'], self.s, self.w,
                     self.eps, self.tf32)
