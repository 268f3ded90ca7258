"""Ground truth: spheres along the robot's control-point chain against a
scene of boxes, spheres and cylinders, by their signed distance functions
(positive inside a shape)."""
from __future__ import annotations

import torch

from .fk import dh_points


def _local(p, T):
    """World points p [..., 3] into the frame of the 4x4 transform T."""
    R = torch.as_tensor(T, dtype=p.dtype, device=p.device)[:3]
    return (p - R[:, 3]) @ R[:, :3]


def shape_sdf(p, shape: dict):
    """Signed distance of world points p [..., 3] to one shape (negative
    inside), by its type, its parameters and its 4x4 transform."""
    x = _local(p, shape['transform'])
    kind, prm = shape['type'], shape['params']
    if kind == 'Sphere':
        return torch.linalg.vector_norm(x, dim=-1) - prm['radius']
    if kind == 'Box':
        half = torch.as_tensor(prm['extents'], dtype=p.dtype,
                               device=p.device) / 2
        d = x.abs() - half
        out = torch.linalg.vector_norm(d.clamp(min=0), dim=-1)
        return out + d.amax(-1).clamp(max=0)
    if kind == 'Cylinder':
        dr = torch.linalg.vector_norm(x[..., :2], dim=-1) - prm['radius']
        dz = x[..., 2].abs() - prm['height'] / 2
        d = torch.stack([dr, dz], -1)
        out = torch.linalg.vector_norm(d.clamp(min=0), dim=-1)
        return out + d.amax(-1).clamp(max=0)
    raise ValueError(f'no signed distance for shape type {kind}')


def chain_spheres(q, robot: dict, gt: dict):
    """Sphere centres [B, n, 3]: the base origin and the control points,
    each segment cut into ``per_seg`` equal parts, the last point once."""
    cp = dh_points(q, robot)
    base = torch.zeros_like(cp[:, :1])
    cp = torch.cat([base, cp], 1)
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
