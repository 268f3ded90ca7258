"""Batched 3D collision geometry: sphere-decomposed robot vs analytic SDFs
(PyTorch counterpart of ``diffco_tpu/geometry/geometry3d.py``).

Sign conventions: ``*_sdf`` functions are classic SDFs (negative inside);
``signed_dist`` outputs are positive for penetration depth and negative
for separation.
"""
from __future__ import annotations

import dataclasses
import math
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
    capsules, meshes. A mesh obstacle is its sphere decomposition: the
    spheres of every mesh in one list, each with its object's index in
    ``msh_obj``, so that per-object distances take the minimum over that
    object's spheres."""
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
    msh_c: torch.Tensor   # [Nm, 3] mesh sphere centers
    msh_r: torch.Tensor   # [Nm]
    msh_obj: torch.Tensor  # [Nm] int64, the mesh object of each sphere
    n_mesh_objects: int

    @property
    def n_objects(self) -> int:
        return (self.sph_c.shape[0] + self.box_t.shape[0]
                + self.cyl_t.shape[0] + self.cap_t.shape[0]
                + self.n_mesh_objects)

    def to(self, device) -> 'SceneArrays':
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != 'n_mesh_objects'})

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
        if self.msh_c.shape[0]:
            per_sphere = sphere_sdf(p[..., None, :] - self.msh_c,
                                    self.msh_r)                  # [..., Nm]
            # each mesh object's minimum over its own spheres
            mine = self.msh_obj[:, None] == torch.arange(
                self.n_mesh_objects, device=self.msh_obj.device)
            outs.append(torch.amin(torch.where(
                mine, per_sphere[..., :, None], math.inf), dim=-2))
        if not outs:
            return torch.zeros(p.shape[:-1] + (0,), dtype=p.dtype,
                               device=p.device)
        return torch.cat(outs, dim=-1)


# local-frame (centers, radii) per mesh source, scale and sphere count: a
# ShapeEnv rebuilds its scene at every update_transform, and moving an
# obstacle should not re-read and re-cluster its mesh
_mesh_sphere_cache = {}


def _mesh_spheres_local(params, mesh_spheres: int):
    """A Mesh shape's sphere decomposition in its own frame, scaled:
    inline ``vertices`` / ``faces``, or a file (``file_obj``, ``file_stl``
    or ``path``)."""
    from .mesh import load_mesh, spheres_from_mesh
    scale = float(params.get('scale', 1.0))
    if 'vertices' in params:
        verts = np.asarray(params['vertices'], np.float32)
        faces = np.asarray(params['faces'], np.int32)
        key = ('inline', verts.tobytes(), faces.tobytes(), scale,
               mesh_spheres)
    else:
        path = params.get('file_obj') or params.get('file_stl') \
            or params.get('path')
        key = (path, scale, mesh_spheres)
    hit = _mesh_sphere_cache.get(key)
    if hit is None:
        if 'vertices' not in params:
            verts, faces = load_mesh(path)
        hit = spheres_from_mesh(verts * scale, faces, n_spheres=mesh_spheres)
        _mesh_sphere_cache[key] = hit
    return hit


def scene_from_dict(shapes: Dict[str, dict], mesh_spheres: int = 16,
                    dtype=torch.float32) -> Tuple[SceneArrays, List[str]]:
    """Build CPU SceneArrays from a ShapeEnv-style dict; a Mesh shape
    becomes ``mesh_spheres`` spheres. Returns (scene, object_names in
    object order)."""
    sph, box, cyl, cap, msh = [], [], [], [], []
    sph_n, box_n, cyl_n, cap_n, msh_n = [], [], [], [], []
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
            centers, radii = _mesh_spheres_local(params, mesh_spheres)
            msh.append((centers @ R.T + t, radii))
            msh_n.append(name)
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
        msh_c=arr([c for m in msh for c in m[0]], (-1, 3)),
        msh_r=arr([r for m in msh for r in m[1]], (-1,)),
        msh_obj=torch.as_tensor([i for i, m in enumerate(msh)
                                 for _ in m[1]], dtype=torch.int64),
        n_mesh_objects=len(msh),
    )
    return scene, sph_n + box_n + cyl_n + cap_n + msh_n


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
