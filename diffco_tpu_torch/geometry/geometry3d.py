"""Batched 3D collision geometry: sphere-decomposed robot vs analytic SDFs
(PyTorch counterpart of ``diffco_tpu/geometry/geometry3d.py``).

Sign conventions: ``*_sdf`` functions are classic SDFs (negative inside);
``signed_dist`` outputs are positive for penetration depth and negative
for separation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# point SDFs (local frame; negative inside)


def sphere_sdf(p, radius):
    return torch.sqrt(torch.sum(p ** 2, -1) + 1e-12) - radius


def box_sdf(p, half):
    q = torch.abs(p) - half
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, -1) + 1e-12)
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


def cylinder_sdf(p, radius, half_h):
    dxy = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-12) - radius
    dz = torch.abs(p[..., 2]) - half_h
    outside = torch.sqrt(torch.clamp(dxy, min=0.0) ** 2
                         + torch.clamp(dz, min=0.0) ** 2 + 1e-12)
    inside = torch.clamp(torch.maximum(dxy, dz), max=0.0)
    return outside + inside


def capsule_sdf(p, radius, half_h):
    z = torch.maximum(torch.minimum(p[..., 2], half_h), -half_h)
    d = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2
                   + (p[..., 2] - z) ** 2 + 1e-12)
    return d - radius


def _to_local(p, rot, trans):
    """World points p [..., 3] -> every object's local frame:
    rot [N, 3, 3], trans [N, 3] -> [..., N, 3]."""
    return torch.einsum('nji,...nj->...ni', rot, p[..., None, :] - trans)


# ---------------------------------------------------------------------------
# scene container


@dataclasses.dataclass
class SceneArrays:
    """Per-type obstacle arrays; object order: spheres, boxes, cylinders,
    capsules. (Mesh obstacles, represented by sphere decompositions in the
    JAX package, are not ported yet.)"""
    sph_c: torch.Tensor   # [Ns, 3]
    sph_r: torch.Tensor   # [Ns]
    box_t: torch.Tensor   # [Nb, 3]
    box_R: torch.Tensor   # [Nb, 3, 3]
    box_h: torch.Tensor   # [Nb, 3] half extents
    cyl_t: torch.Tensor
    cyl_R: torch.Tensor
    cyl_r: torch.Tensor
    cyl_h: torch.Tensor   # half heights
    cap_t: torch.Tensor
    cap_R: torch.Tensor
    cap_r: torch.Tensor
    cap_h: torch.Tensor

    @property
    def n_objects(self) -> int:
        return (self.sph_c.shape[0] + self.box_t.shape[0]
                + self.cyl_t.shape[0] + self.cap_t.shape[0])

    def to(self, device) -> 'SceneArrays':
        return SceneArrays(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})

    def point_sdf_per_object(self, p):
        """SDF of world points p [..., 3] to every object:
        [..., n_objects] (negative inside)."""
        outs = []
        if self.sph_c.shape[0]:
            outs.append(sphere_sdf(p[..., None, :] - self.sph_c, self.sph_r))
        if self.box_t.shape[0]:
            outs.append(box_sdf(_to_local(p, self.box_R, self.box_t),
                                self.box_h))
        if self.cyl_t.shape[0]:
            outs.append(cylinder_sdf(_to_local(p, self.cyl_R, self.cyl_t),
                                     self.cyl_r, self.cyl_h))
        if self.cap_t.shape[0]:
            outs.append(capsule_sdf(_to_local(p, self.cap_R, self.cap_t),
                                    self.cap_r, self.cap_h))
        if not outs:
            return torch.zeros(p.shape[:-1] + (0,), dtype=p.dtype,
                               device=p.device)
        return torch.cat(outs, dim=-1)


def scene_from_dict(shapes: Dict[str, dict], dtype=torch.float32
                    ) -> Tuple[SceneArrays, List[str]]:
    """Build CPU SceneArrays from a ShapeEnv-style dict. Returns
    (scene, object_names in object order)."""
    sph, box, cyl, cap = [], [], [], []
    sph_n, box_n, cyl_n, cap_n = [], [], [], []
    for name, spec in shapes.items():
        T = np.asarray(spec.get('transform', np.eye(4)), np.float32)
        R, t = T[:3, :3], T[:3, 3]
        kind = spec['type']
        params = spec['params']
        if kind == 'Sphere':
            sph.append((t, float(params['radius'])))
            sph_n.append(name)
        elif kind == 'Box':
            box.append((t, R, np.asarray(params['extents'], np.float32) / 2))
            box_n.append(name)
        elif kind == 'Cylinder':
            cyl.append((t, R, float(params['radius']),
                        float(params['height']) / 2))
            cyl_n.append(name)
        elif kind == 'Capsule':
            cap.append((t, R, float(params['radius']),
                        float(params['height']) / 2))
            cap_n.append(name)
        elif kind == 'Mesh':
            raise NotImplementedError(
                'Mesh obstacles are not ported yet (ROADMAP A6, mesh '
                'obstacles)')
        else:
            raise ValueError(f'unknown shape type {kind}')

    def arr(x, shape):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(shape),
                               dtype=dtype)

    scene = SceneArrays(
        sph_c=arr([s[0] for s in sph], (-1, 3)),
        sph_r=arr([s[1] for s in sph], (-1,)),
        box_t=arr([b[0] for b in box], (-1, 3)),
        box_R=arr([b[1] for b in box], (-1, 3, 3)),
        box_h=arr([b[2] for b in box], (-1, 3)),
        cyl_t=arr([c[0] for c in cyl], (-1, 3)),
        cyl_R=arr([c[1] for c in cyl], (-1, 3, 3)),
        cyl_r=arr([c[2] for c in cyl], (-1,)),
        cyl_h=arr([c[3] for c in cyl], (-1,)),
        cap_t=arr([c[0] for c in cap], (-1, 3)),
        cap_R=arr([c[1] for c in cap], (-1, 3, 3)),
        cap_r=arr([c[2] for c in cap], (-1,)),
        cap_h=arr([c[3] for c in cap], (-1,)),
    )
    return scene, sph_n + box_n + cyl_n + cap_n


# ---------------------------------------------------------------------------
# robot-sphere queries


def spheres_vs_scene_signed_dist(centers, radii, scene: SceneArrays):
    """Per-object signed distance of robot sphere sets.

    centers [..., P, 3], radii [P] -> [..., n_objects]; >0 = penetration
    (max over robot spheres of radius - sdf)."""
    sdf = scene.point_sdf_per_object(centers)       # [..., P, n_objects]
    signed = radii[:, None] - sdf
    return torch.amax(signed, dim=-2)


def sphere_set_self_distance(centers, radii, pair_i, pair_j):
    """Signed distance of selected sphere pairs (self-collision):
    centers [..., P, 3] -> [..., n_pairs]; >0 = overlap. pair_i/j index
    the sphere arrays."""
    ci, cj = centers[..., pair_i, :], centers[..., pair_j, :]
    rr = radii[pair_i] + radii[pair_j]
    d = torch.sqrt(torch.sum((ci - cj) ** 2, -1) + 1e-12)
    return rr - d
