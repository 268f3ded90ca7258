"""Capsule-chain collision model for analytic (DH) robots (PyTorch
counterpart of ``diffco_tpu/robots/capsule_chain.py``): each consecutive
control-point segment is covered by interpolated spheres, queried against
the scene's SDFs in one batched pass."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.geometry3d import spheres_vs_scene_signed_dist, SceneArrays


def chain_sphere_centers(control_points, per_seg: int,
                         include_base: bool = True, base_origin=None):
    """Interpolate sphere centers along consecutive control points.

    control_points: [B, M, 3] -> centers [B, (M'-1) * per_seg + 1, 3]
    where M' = M + 1 when include_base prepends the robot's base origin
    (``base_origin`` [3], default the world origin).
    """
    cp = control_points
    if include_base:
        if base_origin is None:
            base = torch.zeros_like(cp[:, :1])
        else:
            base = torch.as_tensor(
                np.asarray(base_origin), dtype=cp.dtype,
                device=cp.device).reshape(1, 1, 3).expand_as(cp[:, :1])
        cp = torch.cat([base, cp], dim=1)
    fr = torch.arange(per_seg, dtype=cp.dtype, device=cp.device) / per_seg
    seg = cp[:, 1:] - cp[:, :-1]                             # [B, M-1, 3]
    pts = cp[:, :-1, None, :] + fr[None, None, :, None] * seg[:, :, None, :]
    pts = pts.reshape(cp.shape[0], -1, 3)
    return torch.cat([pts, cp[:, -1:]], dim=1)


class CapsuleChainCollision:
    """Ground-truth collision checker for a control-point-chain robot vs a
    SceneArrays / ShapeEnv scene. Runs on the device of ``q``."""

    def __init__(self, robot, link_radius: float = 0.06, per_seg: int = 4,
                 include_base: bool = True, scene=None):
        self.robot = robot
        self.link_radius = float(link_radius)
        self.per_seg = int(per_seg)
        self.include_base = include_base
        base = getattr(robot, 'base', None)
        self.base_origin = (None if base is None
                            else np.asarray(base)[:3, 3])
        self._scene = scene.scene if hasattr(scene, 'scene') else scene

    def sphere_centers(self, q):
        cp = self.robot.fkine(q)
        return chain_sphere_centers(cp, self.per_seg, self.include_base,
                                    base_origin=self.base_origin)

    def signed_dist(self, q, scene: SceneArrays):
        """Max signed distance over objects per config: [B] (>0 inside)."""
        scene = scene.scene if hasattr(scene, 'scene') else scene
        q = torch.atleast_2d(q)
        centers = self.sphere_centers(q)
        radii = torch.full((centers.shape[1],), self.link_radius,
                           dtype=centers.dtype, device=centers.device)
        sd = spheres_vs_scene_signed_dist(centers, radii,
                                          scene.to(centers.device))
        return torch.amax(sd, dim=-1)

    def collision(self, q, other=None):
        scene = other if other is not None else self._scene
        if scene is None:
            raise ValueError('no scene: pass other= or construct with scene=')
        return self.signed_dist(q, scene) > 0

    def checker_fn(self, scene):
        """Bind a scene: returns gt(q) -> bool [B] for CollisionChecker."""
        scene = scene.scene if hasattr(scene, 'scene') else scene

        def gt(q):
            return self.signed_dist(q, scene) > 0
        return gt
