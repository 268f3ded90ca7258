"""Samplers (counterpart of ``diffco_tpu/sampler.py``): the escape
sampler ``OptimSampler`` (descend the proxy score from colliding
configurations, or resample uniformly), the FK-manifold sampler
(``manifold_jac_det``, ``uniform_sample_on_transformed_manifold``:
configurations uniform on a transform's image rather than in joint
space) and the path bands of path-targeted active learning
(``path_band_samples``, numpy)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd import forward_ad

from .device import fp32_matmul, resolve_device
from .optim import _adam_update


class OptimSampler:
    """Escape a batch of colliding configurations by descending the proxy
    score ``dist_est`` (q [B, dof] -> [B] or [B, 1]) with Adam (optax's
    update, ``lr``) until each configuration's score is at most
    ``-stop_bias``, for ``max_steps`` steps, within the robot's limits."""

    def __init__(self, robot, dist_est: Callable, lr: float = 0.05,
                 max_steps: int = 50, stop_bias: float = 0.0):
        self.robot = robot
        self.dist_est = dist_est
        self.lr = lr
        self.max_steps = max_steps
        self.stop_bias = stop_bias

    def optim_escape(self, q0):
        """q0 [B, dof] colliding configurations -> escaped ones [B, dof]
        on q0's device (some may stay in collision if ``max_steps`` is too
        few). One ``dist_est`` call per step gives the loss, its gradient
        and the freeze mask; a configuration whose score has reached
        ``-stop_bias`` is frozen: its gradient and its UPDATE are masked,
        since Adam's momentum would move it on after its gradient went to
        zero."""
        q = torch.atleast_2d(torch.as_tensor(q0)).detach().clone()
        lim = torch.as_tensor(self.robot.limits, dtype=q.dtype).to(q.device)
        mu, nu = torch.zeros_like(q), torch.zeros_like(q)
        count = torch.zeros((), dtype=torch.int32, device=q.device)
        for _ in range(self.max_steps):
            qv = q.requires_grad_(True)
            with torch.enable_grad():
                s = self.dist_est(qv).reshape(-1) + self.stop_bias
                g, = torch.autograd.grad(torch.clamp(s, min=0.0).sum(), qv)
            active = 1.0 - (s.detach() <= 0).to(q.dtype)[:, None]
            upd, mu, nu, count = _adam_update(g * active, mu, nu, count,
                                              self.lr)
            q = torch.clamp(q.detach() + upd * active, lim[:, 0], lim[:, 1])
        return q

    def resample_escape(self, q0, generator: Optional[
            torch.Generator] = None, max_tries: int = 20):
        """Baseline: replace each colliding configuration by uniform draws
        (from ``generator``) until one is free, at most ``max_tries``
        rounds of B draws. Returns (samples [B, dof], score checks)."""
        out = torch.atleast_2d(torch.as_tensor(q0)).detach().clone()
        B = out.shape[0]
        with torch.no_grad():
            free = self.dist_est(out).reshape(-1) + self.stop_bias <= 0
            checks = B
            for _ in range(max_tries):
                if bool(free.all()):
                    break
                cand = self.robot.rand_configs(B, generator, out.device)
                cand_free = (self.dist_est(cand).reshape(-1)
                             + self.stop_bias <= 0)
                take = ~free & cand_free
                out = torch.where(take[:, None], cand, out)
                free = free | cand_free
                checks += B
        return out, checks


def manifold_jac_det(transform: Callable, q):
    """sqrt(det(J^T J + 1e-4 I)) of the transform's Jacobian J at each
    configuration (J^T J over the smaller side of J): the density of the
    transform's image measure, q [B, dof] -> [B]. The Jacobian comes from
    one forward-mode pass per joint with tangent e_k on every row (the
    rows are independent), through the FK Functions' ``jvp``."""
    q = torch.atleast_2d(torch.as_tensor(q)).detach()
    cols = []
    with forward_ad.dual_level():
        for k in range(q.shape[1]):
            t = torch.zeros_like(q)
            t[:, k] = 1.0
            out = transform(forward_ad.make_dual(q, t))
            tan = forward_ad.unpack_dual(out).tangent
            cols.append(torch.zeros_like(out).reshape(q.shape[0], -1)
                        if tan is None else tan.reshape(q.shape[0], -1))
    jac = torch.stack(cols, dim=-1)                      # [B, out, dof]
    if jac.shape[-2] < jac.shape[-1]:
        jac = jac.transpose(-1, -2)
    with fp32_matmul():
        jtj = jac.transpose(-1, -2) @ jac
    jtj = jtj + 1e-4 * torch.eye(jtj.shape[-1], dtype=jtj.dtype,
                                 device=jtj.device)
    return torch.sqrt(torch.clamp(torch.linalg.det(jtj), min=0.0))


def uniform_sample_on_transformed_manifold(robot, transform: Callable,
                                           num_samples: int,
                                           generator: Optional[
                                               torch.Generator] = None,
                                           device=None,
                                           max_rounds: int = 50):
    """Rejection-sample configurations uniformly on the transform's image:
    accept a uniform draw q with probability ``manifold_jac_det(q) /
    max_det`` (max_det 1.1 times the largest seen so far), in rounds of
    ``num_samples`` draws from ``generator``, on ``device`` (CUDA unless
    the caller asks for the CPU). Always returns [num_samples, dof]: what
    ``max_rounds`` rounds (or a transform singular everywhere) leave
    unfilled is topped up with plain uniform draws."""
    dev = resolve_device(device)
    gdev = generator.device if generator is not None else 'cpu'
    q = robot.rand_configs(num_samples, generator, dev)
    det = manifold_jac_det(transform, q)
    max_det = 1.1 * float(det.max())
    accepted, count = [], 0
    if max_det > 0.0:
        for _ in range(max_rounds):
            u = torch.rand(q.shape[0], generator=generator, device=gdev,
                           dtype=det.dtype).to(dev)
            acc = q[det > u * max_det]
            accepted.append(acc)
            count += acc.shape[0]
            if count >= num_samples:
                break
            q = robot.rand_configs(num_samples, generator, dev)
            det = manifold_jac_det(transform, q)
            max_det = max(max_det, 1.1 * float(det.max()))
    if count < num_samples:
        accepted.append(robot.rand_configs(num_samples - count, generator,
                                           dev))
    return torch.cat(accepted)[:num_samples]


def path_band_samples(paths, limits, rng, n_total=2048, num_sub=8,
                      scales=(0.05, 0.15, 0.35)):
    """Jittered bands around densified path(s): the corridor exploit set
    for path-targeted active learning (``RBFDiffCo.update(exploit_paths=)``,
    ``checkers.corridor_update``).

    Each path is densified to ``num_sub`` points per segment; 90 % of
    ``n_total`` are drawn from those points in equal shares per noise scale
    (the tightest band labels the corridor's interior, the wider ones
    straddle its walls) and the rest uniformly within the limits, so the
    total is exactly ``n_total``.

    paths: iterable of [N_i, dof] waypoint arrays (paths with fewer than 2
    waypoints are skipped; ValueError if none is left). limits: [dof, 2]
    joint limits. rng: a numpy ``RandomState`` (``randint``) or
    ``Generator`` (``integers``). Returns [n_total, dof] float32, clipped
    to the limits."""
    limits = np.asarray(limits, np.float64)
    bands = []
    for path in paths:
        p = np.asarray(path, np.float32)
        if p.ndim != 2 or p.shape[0] < 2:
            continue
        fr = (np.arange(num_sub, dtype=np.float32) / num_sub)[None, :, None]
        dense = (p[:-1][:, None, :]
                 + fr * (p[1:] - p[:-1])[:, None, :]).reshape(-1, p.shape[1])
        bands.append(dense)
    if not bands:
        raise ValueError('path_band_samples needs at least one path with '
                         '>= 2 waypoints')
    dense = np.concatenate(bands, axis=0)
    n_band = int(n_total * 0.9)
    per_scale = n_band // len(scales)
    out = []
    for s in scales:
        idx = rng.randint(0, dense.shape[0], per_scale) \
            if hasattr(rng, 'randint') \
            else rng.integers(0, dense.shape[0], per_scale)
        out.append(dense[idx] + rng.normal(size=(per_scale,
                                                 dense.shape[1])) * s)
    n_uniform = n_total - per_scale * len(scales)
    out.append(rng.uniform(limits[:, 0], limits[:, 1],
                           (n_uniform, dense.shape[1])))
    return np.clip(np.concatenate(out, axis=0),
                   limits[:, 0], limits[:, 1]).astype(np.float32)
