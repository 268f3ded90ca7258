"""Kernel functions between (transformed) configurations (PyTorch
counterpart of ``diffco_tpu/kernels.py``).

Every kernel reduces to a pairwise squared distance from one matrix
product via the ``|x|^2 + |y|^2 - 2 x.y`` expansion, clamped at zero (or,
for ``TangentKernel``, to the inner product itself). The products run in
full float32 (``device.fp32_matmul``), as the JAX package's
``precision='highest'``.
"""
from __future__ import annotations

import torch

from .device import fp32_matmul


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
    with fp32_matmul():
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


class CauchyKernel(KernelFunc):
    """c / (||x-x'||^2 + c)."""

    def __init__(self, c: float):
        self.c = float(c)

    def __call__(self, xs, x_primes):
        return self.c / (pairwise_sqdist(xs, x_primes) + self.c)


class MultiQuadratic(KernelFunc):
    """sqrt(||x-x'||^2 / eps^2 + 1): ``MultiDiffCo.fit_poly``'s default."""

    def __init__(self, epsilon: float):
        self.epsilon = float(epsilon)

    def __call__(self, xs, x_primes):
        d2 = pairwise_sqdist(xs, x_primes)
        return torch.sqrt(d2 / self.epsilon ** 2 + 1.0)


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


class WeightedKernel(KernelFunc):
    """RQ kernel over per-feature weighted inputs."""

    def __init__(self, gamma: float, w, p: int = 2):
        self.gamma = float(gamma)
        self.p = p
        self.w = torch.as_tensor(w, dtype=torch.float32).reshape(1, -1)

    def __call__(self, xs, x_primes):
        w = self.w.to(device=xs.device, dtype=xs.dtype)
        d2 = pairwise_sqdist(_flatten2(xs) * w, _flatten2(x_primes) * w)
        return (1.0 + (self.gamma / self.p) * d2) ** (-self.p)


class TangentKernel(KernelFunc):
    """tanh(a * <x, x'> + c)."""

    def __init__(self, a: float, c: float):
        self.a = float(a)
        self.c = float(c)

    def __call__(self, xs, x_primes):
        with fp32_matmul():
            prod = _flatten2(xs) @ _flatten2(x_primes).T
        return torch.tanh(self.a * prod + self.c)


class FKKernel(KernelFunc):
    """A base kernel over forward-kinematics control points (the older
    form of a perceptron's ``transform``)."""

    def __init__(self, fkine, base_kernel: KernelFunc):
        self.fkine = fkine
        self.base_kernel = base_kernel

    def __call__(self, xs, x_primes=None, x_primes_controls=None):
        xs = torch.atleast_2d(xs)
        xs_controls = self.fkine(xs).reshape(xs.shape[0], -1)
        if x_primes_controls is None:
            x_primes = torch.atleast_2d(x_primes)
            x_primes_controls = self.fkine(x_primes).reshape(
                x_primes.shape[0], -1)
        return self.base_kernel(xs_controls, x_primes_controls)


class TemporalFKKernel(KernelFunc):
    """Space-time product kernel for dynamic environments:
    k((x1, t1), (x2, t2)) = k_fk(x1, x2) * k_t(t1, t2)^alpha, with t the
    last feature of each extended configuration."""

    def __init__(self, fkine, rqkernel: KernelFunc, t_rqkernel: KernelFunc,
                 alpha: float = 0.5):
        self.fkine = fkine
        self.rqkernel = rqkernel
        self.t_rqkernel = t_rqkernel
        self.alpha = float(alpha)

    def __call__(self, xs, x_primes):
        xs = torch.atleast_2d(xs)
        x_primes = torch.atleast_2d(x_primes)
        xs, ts = xs[:, :-1], xs[:, -1:]
        x_primes, t_primes = x_primes[:, :-1], x_primes[:, -1:]
        xs_controls = self.fkine(xs).reshape(xs.shape[0], -1)
        xp_controls = self.fkine(x_primes).reshape(x_primes.shape[0], -1)
        return (self.rqkernel(xs_controls, xp_controls)
                * self.t_rqkernel(ts, t_primes) ** self.alpha)


def _segment_dof(xs, x_primes) -> int:
    """Half the width of stacked-endpoint segment features; an odd or
    mismatched width would split endpoints across the wrong boundary."""
    if xs.shape[1] % 2 != 0 or x_primes.shape[1] != xs.shape[1]:
        raise ValueError(
            f'segment features must stack two equal-width endpoint '
            f'configs, got widths {xs.shape[1]} / {x_primes.shape[1]}')
    return xs.shape[1] // 2


class LineKernel(KernelFunc):
    """Kernel between motion segments (stacked endpoint configurations):
    the mean of the point kernel on the two endpoints."""

    def __init__(self, point_kernel: KernelFunc):
        self.point_kernel = point_kernel

    def __call__(self, xs, x_primes):
        xs = torch.atleast_2d(xs)
        x_primes = torch.atleast_2d(x_primes)
        dof = _segment_dof(xs, x_primes)
        return 0.5 * (self.point_kernel(xs[:, :dof], x_primes[:, :dof])
                      + self.point_kernel(xs[:, dof:], x_primes[:, dof:]))


class LineFKKernel(KernelFunc):
    """FK kernel over motion segments: the base kernel on the control
    points of both endpoints."""

    def __init__(self, fkine, base_kernel: KernelFunc):
        self.fkine = fkine
        self.base_kernel = base_kernel

    def __call__(self, xs, x_primes):
        xs = torch.atleast_2d(xs)
        x_primes = torch.atleast_2d(x_primes)
        dof = _segment_dof(xs, x_primes)
        xs_controls = self.fkine(xs.reshape(-1, dof)).reshape(xs.shape[0], -1)
        xp_controls = self.fkine(
            x_primes.reshape(-1, dof)).reshape(x_primes.shape[0], -1)
        return self.base_kernel(xs_controls, xp_controls)


class MultiDimRQKernel(KernelFunc):
    """Per-control-point rational-quadratic kernel, vector-valued:
    k(x, x')[m] = RQ(x_m, x'_m). Inputs [N, M, d] and [N', M, d] (a 2-D
    input is one row); output [N, N', M]."""

    def __init__(self, gamma: float, p: int = 2):
        self.gamma = float(gamma)
        self.p = p

    def __call__(self, xs, x_primes):
        if xs.dim() == 2:
            xs = xs[None]
        if x_primes.dim() == 2:
            x_primes = x_primes[None]
        d2 = torch.sum((xs[:, None] - x_primes[None]) ** 2, dim=-1)
        return (1.0 + (self.gamma / self.p) * d2) ** (-self.p)
