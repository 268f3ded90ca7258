"""The legacy obstacle-list API (PyTorch counterpart of
``diffco_tpu/legacy.py``): ``Obstacle``, ``FCLObstacle``, ``FCLChecker``,
``Simple1DDynamicObstacle`` and ``Simple1DDynamicChecker``, the names the
reference's experiment scripts still import, on the batched 2-D ground
truth (``geometry/geometry2d.py``) and the dynamic one
(``dynamics.py``). Checkers run on CUDA unless the caller passes
``device='cpu'``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .device import resolve_device
from .dynamics import Dynamic1DChecker, ObstacleMotion
from .geometry.geometry2d import (Obstacles2D, planar_robot_signed_dist,
                                  point_rect_sd)


class Obstacle:
    """A point robot's obstacle: ``kind`` 'circle' or 'rect';
    ``is_collision`` tests containment. A circle's ``size`` is its
    DIAMETER (the reference's point test, norm < size / 2)."""

    def __init__(self, kind, position, size, cost=np.inf):
        if kind not in ('circle', 'rect'):
            raise NotImplementedError(f'obstacle kind {kind}')
        self.kind = kind
        self.position = torch.as_tensor(np.asarray(position, np.float32))
        self.size = (float(size) if np.isscalar(size)
                     else torch.as_tensor(np.asarray(size, np.float32)))
        self.cost = cost

    def is_collision(self, point):
        """point [..., 2] (a tensor, or anything ``torch.as_tensor``
        takes) -> bool [B] on the point's device."""
        point = torch.atleast_2d(torch.as_tensor(point, dtype=torch.float32))
        pos = self.position.to(point.device)
        if self.kind == 'circle':
            d = torch.sqrt(torch.sum((point - pos) ** 2, dim=-1))
            return d < self.size / 2
        half = torch.as_tensor(self.size).reshape(-1).to(point.device) / 2
        return point_rect_sd(point, pos, half, point.new_zeros(())) < 0

    def get_cost(self):
        return self.cost


class FCLObstacle(Obstacle):
    """The reference's FCL-backed obstacle by name, with a class label
    (the geometric ground truth needs no FCL shapes)."""

    def __init__(self, kind, position, size=None, category=0, **kwargs):
        super().__init__(kind, position, size)
        self.category = category


class FCLChecker:
    """Ground truth over an obstacle list for a planar robot: labels in
    {-1, +1} and signed distances (> 0 in collision), per configuration
    ('binary'), per obstacle ('instance') or per obstacle class
    ('class'), on ``device`` (default CUDA)."""

    def __init__(self, obstacles: Sequence, robot=None,
                 label_type='binary', num_class=None, device=None):
        self.device = resolve_device(device)
        tuples = []
        for obs in obstacles:
            if isinstance(obs, Obstacle):
                size = (float(obs.size) if obs.kind == 'circle'
                        else tuple(np.asarray(obs.size)))
                tuples.append((obs.kind, tuple(np.asarray(obs.position)),
                               size, getattr(obs, 'category', 0)))
            else:
                tuples.append(tuple(obs))
        self.obstacles = Obstacles2D.from_obstacle_list(tuples)
        self.robot = robot
        self.label_type = label_type
        self.num_class = num_class or max(1, self.obstacles.num_class)

    def predict(self, X, distance=True):
        """labels [N, C] in {-1, +1}; with ``distance`` also the signed
        distances [N, C]."""
        X = torch.atleast_2d(torch.as_tensor(X, dtype=torch.float32,
                                             device=self.device))
        sd = planar_robot_signed_dist(self.robot, self.obstacles, X)
        if self.label_type == 'binary':
            d = torch.amax(sd, dim=-1, keepdim=True)
        elif self.label_type == 'instance':
            d = sd
        else:  # class
            classes = torch.as_tensor(self.obstacles.obstacle_classes,
                                      device=sd.device)
            d = torch.stack([
                torch.amax(torch.where(classes == c, sd, -torch.inf),
                           dim=-1)
                for c in range(self.num_class)], dim=-1)
        labels = (d > 0).long() * 2 - 1
        if distance:
            return labels, d
        return labels

    def score(self, X):
        return self.predict(X, distance=True)[1]


class Simple1DDynamicObstacle:
    """A moving interval obstacle of width ``size`` centred at
    ``position_func(t)``."""

    def __init__(self, size, position_func: ObstacleMotion):
        self.size = float(size)
        self.position_func = position_func

    def is_collision(self, xt):
        xt = torch.atleast_2d(torch.as_tensor(xt, dtype=torch.float32))
        center = self.position_func(xt[:, 1])
        return torch.abs(xt[:, 0] - center) <= self.size / 2


class Simple1DDynamicChecker(Dynamic1DChecker):
    """The reference's ``(obstacles, robot)`` checker on
    ``dynamics.Dynamic1DChecker``. Its ``predict`` unnormalizes X through
    the robot's limits first (scripts feed [0, 1]-normalized (x, t));
    ``robot=None`` keeps raw coordinates."""

    def __init__(self, obstacles: Sequence[Simple1DDynamicObstacle],
                 robot=None, device=None):
        super().__init__([(o.position_func, o.size / 2) for o in obstacles],
                         device=device)
        self.obstacle_objs = list(obstacles)
        self.robot = robot

    def predict(self, X, distance=True):
        X = self._xt(X)
        if self.robot is not None:
            X = self.robot.unnormalize(X)
        d = torch.amax(self.signed_dist(X), dim=-1, keepdim=True)
        labels = (d > 0).long() * 2 - 1
        return (labels, d) if distance else labels
