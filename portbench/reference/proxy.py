"""The smooth proxy DiffCo fits over its supports: a polyharmonic spline
of order 1 over the control-point features, interpolating each support's
label, and its score and gradient at any configuration.

    phi(x, s) = sqrt(|x - s|^2 + 1e-12) / epsilon
    w = Phi(S, S)^-1 y,   score(q) = sum_j w_j phi(f(q), s_j)

(the 1e-12 is the kernel's own guard of the square root, which the
configuration's kernel states). With ``tf32`` the squared distances'
products run on TF32 tensor cores (the control's precision).
"""
from __future__ import annotations

import contextlib

import torch

from . import fk, scene


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def phi(x, s, epsilon: float, tf32: bool = False):
    """[B, F] x [S, F] -> [B, S]."""
    with matmul_precision(tf32):
        xs = x @ s.T
    d2 = (x * x).sum(1, keepdim=True) + (s * s).sum(1)[None] - 2 * xs
    return torch.sqrt(d2.clamp(min=0) + 1e-12) / epsilon


class Proxy:
    """The proxy over support configurations ``support_q`` [S, dof],
    labelled by the ground truth in ``scene_shapes``, built in ``dtype``."""

    def __init__(self, support_q, config: dict, scene_shapes: dict,
                 dtype=torch.float64, tf32: bool = False):
        self.config, self.dtype, self.tf32 = config, dtype, tf32
        self.eps = float(config['checker']['epsilon'])
        q = support_q.to(dtype)
        self.s = fk.features(q, config['robot'])
        self.y = scene.labels(q.double(), config['robot'],
                              config['ground_truth'], scene_shapes).to(dtype)
        self.w = torch.linalg.solve(phi(self.s, self.s, self.eps, tf32),
                                    self.y)

    def score(self, q):
        """Scores [B] of configurations q [B, dof] (differentiable in q)."""
        x = fk.features(q.to(self.dtype), self.config['robot'])
        return phi(x, self.s, self.eps, self.tf32) @ self.w

    def score_grad(self, q, block: int = 8192):
        """(scores [B], d score / d q [B, dof]), in blocks of rows."""
        ss, gs = [], []
        for i in range(0, q.shape[0], block):
            qb = q[i:i + block].detach().to(self.dtype).requires_grad_(True)
            with torch.enable_grad():
                sb = self.score(qb)
                g, = torch.autograd.grad(sb.sum(), qb)
            ss.append(sb.detach())
            gs.append(g)
        return torch.cat(ss), torch.cat(gs)

    def scores(self, q, block: int = 8192):
        with torch.no_grad():
            return torch.cat([self.score(q[i:i + block])
                              for i in range(0, q.shape[0], block)])
