"""Forward kinematics of a standard-DH serial arm: control points of each
configuration, from the DH table and the point list of a configuration
file (``robot.dh``, ``robot.points``)."""
from __future__ import annotations

import torch


def dh_points(q, robot: dict):
    """q [B, dof] -> control points [B, P, 3] in q's dtype and device.

    Joint i's transform is Rz(theta_i + q_i) Tz(d_i) Tx(a_i) Rx(alpha_i);
    frame k is the product of the first k. A point ``[k, [x, y, z]]`` is
    the offset (x, y, z) placed in frame k (k >= 1)."""
    dh = robot['dh']
    dt, dev = q.dtype, q.device
    B = q.shape[0]
    R = torch.eye(3, dtype=dt, device=dev).expand(B, 3, 3)
    t = torch.zeros(B, 3, dtype=dt, device=dev)
    frames = []
    for i in range(q.shape[1]):
        a = torch.tensor(dh['a'][i], dtype=dt, device=dev)
        d = torch.tensor(dh['d'][i], dtype=dt, device=dev)
        al = torch.tensor(dh['alpha'][i], dtype=dt, device=dev)
        th = q[:, i] + dh['theta'][i]
        ct, st = torch.cos(th), torch.sin(th)
        ca, sa = torch.cos(al), torch.sin(al)
        z = torch.zeros_like(ct)
        A = torch.stack([torch.stack([ct, -st * ca, st * sa], -1),
                         torch.stack([st, ct * ca, -ct * sa], -1),
                         torch.stack([z, z + sa, z + ca], -1)], -2)
        tr = torch.stack([a * ct, a * st, z + d], -1)
        t = t + torch.einsum('bij,bj->bi', R, tr)
        R = R @ A
        frames.append((R, t))
    pts = []
    for k, off in robot['points']:
        Rk, tk = frames[k - 1]
        o = torch.tensor(off, dtype=dt, device=dev)
        pts.append(tk + torch.einsum('bij,j->bi', Rk, o))
    return torch.stack(pts, 1)


def features(q, robot: dict):
    """The proxy's features of q [B, dof]: its control points flattened,
    [B, 3P]."""
    return dh_points(q, robot).reshape(q.shape[0], -1)
