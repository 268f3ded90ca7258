"""Temporal / dynamic-obstacle support (PyTorch counterpart of
``diffco_tpu/dynamics.py``).

Obstacle motions are functions of time with the reference constructor
signatures (``LinearMotion(A, B)`` -> A t + B, ``SineMotion(A, alpha,
beta, bias)`` -> A sin(alpha t + beta) + bias). ``Dynamic1DChecker`` is
the ground truth of a 1-DOF point robot among moving intervals: for
scalar motions every obstacle is one row (lin_A, lin_B, sin_A, alpha,
beta) of a parameter tensor, and a batch of (x, t) pairs is labelled in
one batched expression; custom or vector-valued motions go through a loop
over the obstacles. Entry points run on CUDA unless the caller passes
``device='cpu'``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32)) \
        if not torch.is_tensor(x) else x.to(torch.float32)


class ObstacleMotion:
    """Base motion: ``predict(t)`` -> position (``position`` and calling
    the motion are aliases)."""

    def predict(self, t):
        raise NotImplementedError

    def position(self, t):
        return self.predict(t)

    def __call__(self, *args, **kwargs):
        return self.predict(*args, **kwargs)


class LinearMotion(ObstacleMotion):
    """x(t) = A t + B (A the velocity, B the start); A and B may be
    vectors."""

    def __init__(self, A, B):
        self.A = _f32(A)
        self.B = _f32(B)

    def predict(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        A, B = self.A.to(t.device), self.B.to(t.device)
        if B.dim():                        # vector-valued motion
            return A * t[..., None] + B
        return A * t + B

    def _unified_params(self):
        """(lin_A, lin_B, sin_A, alpha, beta) for the batched checker, or
        None for a vector-valued motion."""
        if self.A.dim() or self.B.dim():
            return None
        return (float(self.A), float(self.B), 0.0, 0.0, 0.0)


class SineMotion(ObstacleMotion):
    """x(t) = A sin(alpha t + beta) + bias; bias may be a vector."""

    def __init__(self, A, alpha, beta, bias):
        self.A = float(A)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.bias = _f32(bias)

    def predict(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        s = self.A * torch.sin(self.alpha * t + self.beta)
        bias = self.bias.to(t.device)
        if bias.dim():
            return s[..., None] + bias
        return s + bias

    def _unified_params(self):
        if self.bias.dim():
            return None
        return (0.0, float(self.bias), self.A, self.alpha, self.beta)


def _dynamic_sd(params, halfs, xt):
    """Signed distances of scalar motions in the unified form: params
    [n_obs, 5] rows (lin_A, lin_B, sin_A, alpha, beta), so that
    center_i(t) = lin_A t + lin_B + sin_A sin(alpha t + beta); halfs
    [n_obs] interval half-widths; xt [B, 2] -> [B, n_obs] (> 0 inside)."""
    x, tb = xt[:, 0], xt[:, 1:2]
    centers = (params[:, 0] * tb + params[:, 1]
               + params[:, 2] * torch.sin(params[:, 3] * tb + params[:, 4]))
    return halfs - torch.abs(x[:, None] - centers)


class Dynamic1DChecker:
    """Ground truth for a 1-DOF point robot among moving interval
    obstacles: ``obstacles`` [(motion, half_width)], configurations (x, t)
    in unnormalized coordinates, evaluated on ``device`` (default
    CUDA)."""

    def __init__(self, obstacles: Sequence[Tuple[ObstacleMotion, float]],
                 device=None):
        self.device = resolve_device(device)
        self.obstacles = list(obstacles)
        unified = [getattr(m, '_unified_params', lambda: None)()
                   for m, _ in self.obstacles]
        if self.obstacles and all(u is not None for u in unified):
            self._params = torch.tensor(unified, dtype=torch.float32,
                                        device=self.device)
            self._halfs = torch.tensor([h for _, h in self.obstacles],
                                       dtype=torch.float32,
                                       device=self.device)
        else:
            # a custom ObstacleMotion or a vector-valued motion: the loop
            # over the obstacles
            self._params = self._halfs = None

    def _xt(self, xt):
        return torch.atleast_2d(torch.as_tensor(xt, dtype=torch.float32,
                                                device=self.device))

    def signed_dist(self, xt):
        """xt [B, 2] (position, time) -> [B, n_obs]; > 0 inside."""
        xt = self._xt(xt)
        if self._params is not None:
            return _dynamic_sd(self._params, self._halfs, xt)
        x, t = xt[:, 0], xt[:, 1]
        return torch.stack([half - torch.abs(x - motion.predict(t))
                            for motion, half in self.obstacles], dim=-1)

    def predict(self, xt):
        """Labels in {-1, +1}, as ``FCLChecker.predict``."""
        return self.collision(xt).long() * 2 - 1

    def collision(self, xt):
        return torch.amax(self.signed_dist(xt), dim=-1) > 0


def temporal_dataset(checker: Dynamic1DChecker, limits, num_samples: int,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """(x, t) uniform in ``limits`` [[x_lo, x_hi], [t_lo, t_hi]], drawn
    from ``generator`` (CPU unless it lies elsewhere) and labelled by the
    dynamic ground truth: (xt [N, 2], labels in {-1., +1.} [N], the
    largest signed distance [N]), on ``device`` (default: the
    checker's)."""
    dev = checker.device if device is None else resolve_device(device)
    gdev = generator.device if generator is not None else 'cpu'
    lims = torch.as_tensor(np.asarray(limits, np.float32))
    u = torch.rand((num_samples, 2), generator=generator, device=gdev)
    xt = (u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]).to(dev)
    d = torch.amax(checker.signed_dist(xt), dim=-1).to(dev)
    return xt, (d > 0).to(torch.float32) * 2.0 - 1.0, d
