"""Kernel functions between (transformed) configurations (PyTorch
counterpart of ``diffco_tpu/kernels.py``: ``pairwise_sqdist``,
``pairwise_dist``, ``RQKernel``, ``Polyharmonic``).

Every kernel reduces to a pairwise squared distance from one matrix
product via the ``|x|^2 + |y|^2 - 2 x.y`` expansion, clamped at zero.
"""
from __future__ import annotations

import torch


def _flatten2(x):
    """[N, ...] -> [N, F] (1-D inputs become [1, F])."""
    if x.dim() == 1:
        x = x[None, :]
    return x.reshape(x.shape[0], -1)


def pairwise_sqdist(x, y):
    """Squared euclidean distances between rows: [N, F] x [M, F] -> [N, M]."""
    x = _flatten2(x)
    y = _flatten2(y)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)          # [N, 1]
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T        # [1, M]
    xy = x @ y.T
    return torch.clamp(x2 + y2 - 2.0 * xy, min=0.0)


def pairwise_dist(x, y, eps: float = 1e-12):
    """Euclidean distances with a grad-safe sqrt (finite gradient at 0)."""
    return torch.sqrt(pairwise_sqdist(x, y) + eps)


class KernelFunc:
    def __call__(self, xs, x_primes):
        raise NotImplementedError


class RQKernel(KernelFunc):
    """Rational-quadratic kernel: 1 / (1 + gamma/p * ||x-x'||^2)^p."""

    def __init__(self, gamma: float, p: int = 2):
        self.gamma = float(gamma)
        self.p = p

    def __call__(self, xs, x_primes):
        d2 = pairwise_sqdist(xs, x_primes)
        return (1.0 + (self.gamma / self.p) * d2) ** (-self.p)


class Polyharmonic(KernelFunc):
    """Polyharmonic spline kernel.

    k odd: r^k / eps; k even: r^k * log(r) / eps (0 at r=0).
    """

    def __init__(self, k: int, epsilon: float):
        self.k = int(k)
        self.epsilon = float(epsilon)

    def __call__(self, xs, x_primes):
        if self.k % 2 == 0:
            # exact broadcast-subtract distance: the expansion's
            # cancellation noise would be amplified by log(r) near 0
            a, b = _flatten2(xs), _flatten2(x_primes)
            d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
            r = torch.sqrt(torch.clamp(d2, min=1e-20))
            val = r ** self.k * torch.log(r)
            val = torch.where(d2 <= 1e-20, torch.zeros_like(val), val)
        else:
            r = pairwise_dist(xs, x_primes)
            val = r if self.k == 1 else r ** self.k
        return val / self.epsilon
