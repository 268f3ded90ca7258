"""Obstacle worlds (PyTorch counterpart of ``diffco_tpu/envs/shape_env.py``):
``ShapeEnv``, a dict of named shapes, and ``PCDEnv``, a point cloud as a
set of spheres."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..geometry.geometry3d import SceneArrays, scene_from_dict


class ShapeEnv:
    """Dict-of-shapes world::

        {
          'box1': {'type': 'Box', 'params': {'extents': [1, 1, 1]},
                   'transform': np.eye(4)},
          'sphere1': {'type': 'Sphere', 'params': {'radius': 1}, ...},
          'cylinder1': {'type': 'Cylinder',
                        'params': {'radius': 1, 'height': 1}, ...},
          'capsule1': {'type': 'Capsule',
                       'params': {'radius': 1, 'height': 1}, ...},
          'mesh1': {'type': 'Mesh',
                    'params': {'file_obj': 'x.stl', 'scale': 1.0}, ...},
        }

    A mesh (a file, or inline ``vertices`` and ``faces``) becomes
    ``mesh_spheres`` spheres. ``scene`` holds CPU tensors; consumers move
    it to their device.
    """

    def __init__(self, shapes: Dict[str, dict], mesh_spheres: int = 16):
        self.name = 'ShapeEnv'
        self.mesh_spheres = mesh_spheres
        self.shapes = {k: dict(v) for k, v in shapes.items()}
        self._rebuild()

    def _rebuild(self):
        self.scene, self.object_names = scene_from_dict(
            self.shapes, mesh_spheres=self.mesh_spheres)

    def add_object(self, name, shape_type, shape_params, transform=None):
        self.shapes[name] = {
            'type': shape_type, 'params': dict(shape_params),
            'transform': np.eye(4) if transform is None else
            np.asarray(transform)}
        self._rebuild()

    def remove_object(self, name):
        del self.shapes[name]
        self._rebuild()

    def update_transform(self, name, transform):
        self.shapes[name]['transform'] = np.asarray(transform)
        self._rebuild()

    @property
    def n_objects(self):
        return self.scene.n_objects


class PCDEnv:
    """Point-cloud world: each point a sphere of ``point_radius``, at most
    ``max_points`` of them (a seeded subsample, the JAX package's
    ``RandomState(0).choice``, so both packages keep the same points)."""

    def __init__(self, point_cloud, point_radius: float = 0.01,
                 max_points: int = 4096):
        self.point_radius = float(point_radius)
        self.max_points = int(max_points)
        pc = np.asarray(point_cloud, np.float32).reshape(-1, 3)
        if len(pc) > max_points:
            idx = np.random.RandomState(0).choice(len(pc), max_points,
                                                  replace=False)
            pc = pc[idx]
        self.point_cloud = pc
        z3, z = torch.zeros((0, 3)), torch.zeros(0)
        self.scene = SceneArrays(
            sph_c=torch.as_tensor(pc),
            sph_r=torch.full((len(pc),), self.point_radius),
            box_t=z3, box_R=torch.zeros((0, 3, 3)), box_h=z3,
            cyl_t=z3, cyl_R=torch.zeros((0, 3, 3)), cyl_r=z, cyl_h=z,
            cap_t=z3, cap_R=torch.zeros((0, 3, 3)), cap_r=z, cap_h=z,
            msh_c=z3, msh_r=z, msh_obj=torch.zeros(0, dtype=torch.int64),
            n_mesh_objects=0)
        self.object_names = [f'point_{i}' for i in range(len(pc))]

    def update_point_cloud(self, point_cloud):
        """A new cloud, with the radius and the cap kept."""
        self.__init__(point_cloud, point_radius=self.point_radius,
                      max_points=self.max_points)
