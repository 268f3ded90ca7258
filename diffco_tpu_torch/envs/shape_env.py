"""Dict-of-shapes obstacle world (PyTorch counterpart of
``diffco_tpu/envs/shape_env.py``)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..geometry.geometry3d import scene_from_dict


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
        }

    ``scene`` holds CPU tensors; consumers move it to their device.
    """

    def __init__(self, shapes: Dict[str, dict]):
        self.name = 'ShapeEnv'
        self.shapes = {k: dict(v) for k, v in shapes.items()}
        self._rebuild()

    def _rebuild(self):
        self.scene, self.object_names = scene_from_dict(self.shapes)

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
