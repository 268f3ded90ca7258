"""Tutorial Panda environments on the ``CollisionEnv`` template (PyTorch
counterpart of ``diffco_tpu/envs/panda_envs.py``): a URDF Franka Panda
and a ``ShapeEnv`` of obstacles, checked by the batched sphere-model
geometry on the robot's device."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .collision_env import CollisionEnv
from .shape_env import ShapeEnv


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


class PandaEnv(CollisionEnv):
    """A Franka Panda (``robot_kwargs`` to ``FrankaPanda``: by default the
    gripper and 24 spheres a link, on CUDA unless ``device='cpu'``) and a
    ShapeEnv of obstacles. ``sample_q`` draws from a CPU generator seeded
    ``seed``."""

    def __init__(self, shapes: Optional[dict] = None, seed: int = 0,
                 **robot_kwargs):
        super().__init__()
        from ..robots.urdf import FrankaPanda
        robot_kwargs.setdefault('load_gripper', True)
        robot_kwargs.setdefault('link_spheres', 24)
        self.robot = FrankaPanda(**robot_kwargs)
        self.env = ShapeEnv(shapes or {})
        self._gen = torch.Generator().manual_seed(int(seed))

    def _env_signed_dist(self, qs):
        qs = torch.atleast_2d(torch.as_tensor(
            qs, dtype=torch.float32, device=self.robot.device))
        env_sd, _ = self.robot.collision_signed_dist(qs, self.env)
        return env_sd

    def is_collision(self, qs):
        """Robot-vs-environment collision per configuration [B] (bools);
        self-collision is ``robot.self_collision``'s."""
        env_sd = self._env_signed_dist(qs)
        if env_sd.shape[-1] == 0:
            return [False] * env_sd.shape[0]
        return torch.any(env_sd > 0, dim=-1).tolist()

    def distance(self, qs):
        """Separation per configuration [B] (floats): positive when free,
        negative when penetrating, robot vs environment only; +inf in a
        world without obstacles."""
        env_sd = self._env_signed_dist(qs)
        if env_sd.shape[-1] == 0:
            return [float('inf')] * env_sd.shape[0]
        return (-torch.amax(env_sd, dim=-1)).tolist()

    def sample_q(self):
        return self.robot.rand_configs(1, self._gen)[0]

    def plot(self, qs):
        raise NotImplementedError('headless environment: no viewer')


class PandaSingleCylinderEnv(PandaEnv):
    def __init__(self, **kwargs):
        super().__init__(shapes={
            'cylinder1': {'type': 'Cylinder',
                          'params': {'radius': 0.05, 'height': 0.8},
                          'transform': _T([0.5, 0.0, 0.4])},
        }, **kwargs)


class PandaThreeCylinderEnv(PandaEnv):
    def __init__(self, **kwargs):
        super().__init__(shapes={
            f'cylinder{i + 1}': {
                'type': 'Cylinder',
                'params': {'radius': 0.05, 'height': 0.8},
                'transform': _T(t)}
            for i, t in enumerate([[0.3, -0.5, 0.4], [0.5, 0.0, 0.4],
                                   [0.3, 0.5, 0.4]])
        }, **kwargs)


class PandaSingleCuboidEnv(PandaEnv):
    def __init__(self, **kwargs):
        super().__init__(shapes={
            'cuboid1': {'type': 'Box',
                        'params': {'extents': [0.2, 0.2, 0.2]},
                        'transform': _T([0.5, 0.0, 0.4])},
        }, **kwargs)
