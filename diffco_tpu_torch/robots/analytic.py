"""Analytic (closed-form) robot models, batched and differentiable
(PyTorch counterpart of ``diffco_tpu/robots/analytic.py``: ``Model``,
the planar ``RevolutePlanarRobot`` and ``RigidPlanarBody``, the SE(3)
free flyer ``RigidBody``,
``DHParameters``, ``DHChainRobot``, ``PandaFK``, ``DualPandaFK``, the
Baxter arms ``BaxterLeftArmFK``, ``BaxterRightArmFK``, ``BaxterFK`` and
``BaxterDualArmFK``, and the space-time ``PointRobot1D``).

Robots are device-agnostic: their constants are Python floats or CPU
tensors copied next to ``q`` once per device, so ``fkine`` runs wherever
``q`` lies. ``limits`` is a CPU tensor that callers move next to their
data.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils import euler2mat, rot_2d, rotz, wrap2pi
from .soa import (vec_add, transform_compose, dh_rot_trans, rot_from_static,
                  stack_points)
from .fk_jvp import make_dh_fkine

PI = math.pi


def uniform_configs(limits, num_cfgs: int, generator: Optional[
        torch.Generator] = None, device=None) -> torch.Tensor:
    """Uniform configurations within ``limits`` [dof, 2] on ``device``
    (default CUDA). The draw happens on the generator's device (CPU when
    none is given), so a seeded CPU generator yields the same
    configurations whatever device they end up on."""
    dev = resolve_device(device)
    gdev = generator.device if generator is not None else 'cpu'
    u = torch.rand((num_cfgs, limits.shape[0]), generator=generator,
                   device=gdev, dtype=limits.dtype)
    lims = limits.to(gdev)
    lo, hi = lims[:, 0], lims[:, 1]
    return (u * (hi - lo) + lo).to(dev)


class Model:
    """Base robot model."""
    dof: int
    limits: torch.Tensor  # [dof, 2], CPU

    def fkine(self, q):
        raise NotImplementedError

    def wrap(self, q):
        raise NotImplementedError

    def rand_configs(self, num_cfgs: int, generator: Optional[
            torch.Generator] = None, device=None) -> torch.Tensor:
        """Uniform configurations within the joint limits on ``device``
        (default CUDA), drawn by ``uniform_configs``."""
        return uniform_configs(self.limits, num_cfgs, generator, device)

    @property
    def joint_limits(self):
        return self.limits


def _on(cache: dict, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The CPU tensor t on like's device and dtype, copied once per
    (device, dtype) into cache."""
    key = (like.device, like.dtype)
    if key not in cache:
        cache[key] = t.to(device=like.device, dtype=like.dtype)
    return cache[key]


class RevolutePlanarRobot(Model):
    """Planar serial arm with revolute joints, each link along its local
    +x. ``fkine`` returns the joint positions [B, dof, 2] (the base joint
    at the origin left out); each link's collision shape is a capsule of
    width ``link_width`` between consecutive joints (``link_segments``).
    ``link_length`` is one length per link, or a scalar with ``dof``."""

    def __init__(self, link_length, link_width: float,
                 dof: Optional[int] = None, limits=None):
        if limits is None:
            limits = [-PI, PI]
        if isinstance(link_length, (int, float)):
            if dof is None:
                raise ValueError(
                    'dof is required when link_length is a scalar')
            link_length = [link_length] * dof
        elif dof is None:
            dof = len(link_length)
        if len(limits) == 2 and isinstance(limits[0], (int, float)):
            limits = [limits] * dof
        if len(limits) != dof or len(link_length) != dof:
            raise ValueError(f'{len(link_length)} link lengths and '
                             f'{len(limits)} limits for dof = {dof}')
        self.dof = dof
        self.link_width = float(link_width)
        self.link_length = torch.as_tensor(np.asarray(link_length),
                                           dtype=torch.float32)
        self.limits = torch.as_tensor(np.asarray(limits),
                                      dtype=torch.float32)
        self._lengths = {}

    def fkine(self, q):
        q = torch.reshape(q, (-1, self.dof))
        length = _on(self._lengths, self.link_length, q)
        ang = torch.cumsum(q, dim=1)
        x = torch.cumsum(length * torch.cos(ang), dim=1)
        y = torch.cumsum(length * torch.sin(ang), dim=1)
        return torch.stack([x, y], dim=2)

    def link_segments(self, q):
        """Per-link segment endpoints [B, dof, 2 (start, end), 2], the
        base joint included."""
        joints = self.fkine(q)
        pts = torch.cat([torch.zeros_like(joints[:, :1]), joints], dim=1)
        return torch.stack([pts[:, :-1], pts[:, 1:]], dim=2)

    def wrap(self, q):
        return wrap2pi(q)


class RigidPlanarBody(Model):
    """SE(2) rigid body, configuration (x, y, theta), with keypoints.
    ``parts``: [(type, (x, y) keypoint, (w, h) dims)]; the keypoints drive
    ``fkine`` [B, M, 2], the dims the collision boxes."""

    def __init__(self, parts, limits=None):
        self.parts = parts
        self.dof = 3
        self.limits = torch.as_tensor(np.asarray(
            limits if limits is not None else
            [[-10, 10], [-10, 10], [-PI, PI]]), dtype=torch.float32)
        self.keypoints = torch.as_tensor(
            np.asarray([p[1] for p in parts]), dtype=torch.float32)  # [M, 2]
        self._keypoints = {}

    def fkine(self, q):
        q = torch.reshape(q, (-1, 3))
        kp = _on(self._keypoints, self.keypoints, q)
        R = rot_2d(q[:, 2])                                   # [B, 2, 2]
        # R @ keypoints as explicit sums: no TF32 product on the card
        pts = torch.sum(R[:, None, :, :] * kp[None, :, None, :], dim=-1)
        return pts + q[:, None, :2]

    def wrap(self, q):
        return torch.cat([q[..., :2], wrap2pi(q[..., 2:])], dim=-1)


class RigidBody(Model):
    """SE(3) free-flying rigid body, configuration (x, y, z, roll, pitch,
    yaw), with keypoints [3, M] (given as [M, 3] or [3, M]; a 3 x 3 array
    reads as [M, 3]). ``fkine`` returns the keypoints in the world,
    [B, M, 3]."""

    def __init__(self, keypoints, limits=None):
        self.dof = 6
        self.limits = torch.as_tensor(np.asarray(
            limits if limits is not None else
            [[-10, 10]] * 3 + [[-PI, PI]] * 3), dtype=torch.float32)
        kp = torch.as_tensor(np.asarray(keypoints), dtype=torch.float32)
        self.keypoints = kp.T if kp.shape[-1] == 3 else kp    # [3, M]
        self._keypoints = {}

    @classmethod
    def from_vertices(cls, vertices: np.ndarray, limits=None, center=True):
        """Keypoints = the mesh's bounding-box corners, scaled so that the
        farthest lies at distance 1 (from the vertices' mean with
        ``center``)."""
        v = np.asarray(vertices, np.float32)
        if center:
            v = v - v.mean(0)
        lo, hi = v.min(0), v.max(0)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                           np.float32)
        corners = corners / np.linalg.norm(corners, axis=1).max()
        return cls(corners, limits=limits)

    def fkine(self, q):
        q = torch.reshape(q, (-1, 6))
        kp = _on(self._keypoints, self.keypoints, q)           # [3, M]
        R = euler2mat(q[:, 3:])                                # [B, 3, 3]
        # R @ keypoints as explicit sums: no TF32 product on the card
        pts = torch.sum(R[:, None, :, :] * kp.T[None, :, None, :], dim=-1)
        return pts + q[:, None, :3]

    def wrap(self, q):
        return torch.cat([q[..., :3], wrap2pi(q[..., 3:])], dim=-1)


class DHParameters:
    """Standard DH parameter pack (float32 CPU tensors)."""

    def __init__(self, a=0, alpha=0, d=0, theta=0):
        self.a = torch.as_tensor(a, dtype=torch.float32)
        self.alpha = torch.as_tensor(alpha, dtype=torch.float32)
        self.d = torch.as_tensor(d, dtype=torch.float32)
        self.theta = torch.as_tensor(theta, dtype=torch.float32)
        self.s_alpha = torch.sin(self.alpha)
        self.c_alpha = torch.cos(self.alpha)


def _dh_consts_and_specs(dhparams, fk_mask):
    """Per-joint DH constants + masked point specs (one source of truth for
    the spec format)."""
    consts = [(float(a), float(d), float(sa), float(ca), float(th))
              for a, d, sa, ca, th in zip(
                  dhparams.a.tolist(), dhparams.d.tolist(),
                  dhparams.s_alpha.tolist(), dhparams.c_alpha.tolist(),
                  dhparams.theta.tolist())]
    specs = tuple((i + 1, (0.0, 0.0, 0.0))
                  for i, masked in enumerate(fk_mask) if masked)
    return consts, specs


class DHChainRobot(Model):
    """Serial arm from standard DH parameters with an fk_mask selecting
    which cumulative frames become control points."""

    def __init__(self, dhparams: DHParameters, limits,
                 fk_mask: Sequence[bool], base: Optional[np.ndarray] = None):
        self.dhparams = dhparams
        self.limits = torch.as_tensor(np.asarray(limits), dtype=torch.float32)
        self.dof = self.limits.shape[0]
        self.fk_mask = list(fk_mask)
        self.base = None if base is None else np.asarray(base)  # [4, 4]
        self._dh_const, self._point_specs = _dh_consts_and_specs(
            dhparams, self.fk_mask)
        self._fkine_flat = make_dh_fkine(
            self._dh_const, self._point_specs, base=self._base_soa())

    def _base_soa(self):
        if self.base is None:
            return None
        return (rot_from_static(self.base[:3, :3]),
                tuple(float(v) for v in self.base[:3, 3]))

    def _fk_frames_soa(self, q):
        """Cumulative frames as SoA (rot 9-tuple, trans 3-tuple of [B])."""
        q = torch.reshape(q, (-1, self.dof))
        frames = []
        r_acc = t_acc = None
        if self.base is not None:
            zb = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
            r_acc = tuple(zb + v for v in rot_from_static(self.base[:3, :3]))
            t_acc = tuple(zb + float(v) for v in self.base[:3, 3])
        for i, (a, d, sa, ca, th) in enumerate(self._dh_const):
            r_j, t_j = dh_rot_trans(q[:, i] + th, a, d, sa, ca)
            if r_acc is None:
                r_acc, t_acc = r_j, t_j
            else:
                r_acc, t_acc = transform_compose(r_acc, t_acc, r_j, t_j)
            frames.append((r_acc, t_acc))
        return frames

    def fkine(self, q, flat: bool = False):
        q = torch.reshape(q, (-1, self.dof))
        out = self._fkine_flat(q)
        if flat:
            return out
        return out.reshape(q.shape[0], -1, 3)

    def _fkine_soa_autodiff(self, q, flat: bool = False):
        """Plain-autograd SoA FK (no analytic derivatives): the oracle for
        ``make_dh_fkine``."""
        frames = self._fk_frames_soa(q)
        pts = [t for i, (r, t) in enumerate(frames) if self.fk_mask[i]]
        return stack_points(pts, flat=flat)

    def wrap(self, q):
        return wrap2pi(q)


# Baxter's arm, copied from the JAX package's robots/analytic.py
# (_BAXTER_LIMITS, _BAXTER_L, _baxter_dh)
_BAXTER_LIMITS = [[-1.70167993878, 1.70167993878],
                  [-2.147, 1.047],
                  [-3.05417993878, 3.05417993878],
                  [-0.05, 2.618],
                  [-3.059, 3.059],
                  [-1.57079632679, 2.094],
                  [-3.059, 3.059]]
_BAXTER_L = np.array([270.35, 69, 364.35, 69, 374.29, 10, 387.35]) / 1000


def _baxter_dh():
    L = _BAXTER_L
    return DHParameters(
        a=[L[1], 0, L[3], 0, L[5], 0, 0],
        alpha=[-PI / 2, PI / 2, -PI / 2, PI / 2, -PI / 2, PI / 2, 0],
        d=[L[0], 0, L[2], 0, L[4], 0, L[6]],
        theta=[0, PI / 2, 0, 0, 0, 0, 0])


_BAXTER_MASK = (True, False, True, False, True, False, True)


def baxter_arm(fk_mask: Sequence[bool] = _BAXTER_MASK) -> DHChainRobot:
    """Baxter's 7-DOF arm as a DHChainRobot. The default mask is
    BaxterLeftArmFK's (4 control points, F = 12); a mask with fewer points
    gives the smaller component counts the DH kernels are built for."""
    return DHChainRobot(_baxter_dh(), _BAXTER_LIMITS, fk_mask=list(fk_mask))


class BaxterLeftArmFK(DHChainRobot):
    """7-DOF Baxter left arm: 4 control points (F = 12)."""

    def __init__(self):
        super().__init__(_baxter_dh(), _BAXTER_LIMITS,
                         fk_mask=list(_BAXTER_MASK))


class BaxterRightArmFK(DHChainRobot):
    """7-DOF Baxter right arm (the left arm's DH, as in the reference)."""

    def __init__(self):
        super().__init__(_baxter_dh(), _BAXTER_LIMITS,
                         fk_mask=list(_BAXTER_MASK))


BaxterFK = BaxterLeftArmFK


def _arm_base(yaw: float, trans) -> np.ndarray:
    """A torso-mounted arm base: rotation about z by ``yaw`` (in float32,
    as the JAX package computes it) and a translation."""
    base = np.zeros((4, 4), np.float32)
    base[:3, :3] = rotz(torch.tensor(yaw, dtype=torch.float32)).numpy()
    base[:, 3] = list(trans) + [1]
    return base


class BaxterDualArmFK(Model):
    """14-DOF dual-arm Baxter with torso-mounted arm bases: q is (left 7,
    right 7); fkine returns [B, 8, 3], the arms' control points
    interleaved as (left_i, right_i) pairs."""

    def __init__(self):
        self.limits = torch.as_tensor(_BAXTER_LIMITS * 2,
                                      dtype=torch.float32)
        self.dof = 14
        self.fk_mask = list(_BAXTER_MASK)
        self.dh = _baxter_dh()
        L, h, H = np.array([278, 64, 1104]) / 1000
        self.arm_bases = np.stack([_arm_base(-PI / 4, (L, -h, H)),
                                   _arm_base(-3 * PI / 4, (-L, -h, H))])
        consts, specs = _dh_consts_and_specs(self.dh, self.fk_mask)
        self._arm_fkine = [
            make_dh_fkine(consts, specs,
                          base=(rot_from_static(b[:3, :3]),
                                tuple(float(v) for v in b[:3, 3])))
            for b in self.arm_bases]

    def fkine(self, q, flat: bool = False):
        q = torch.reshape(q, (-1, self.dof))
        B, half = q.shape[0], self.dof // 2
        left = self._arm_fkine[0](q[:, :half]).reshape(B, -1, 3)
        right = self._arm_fkine[1](q[:, half:]).reshape(B, -1, 3)
        inter = torch.stack([left, right], dim=2).reshape(B, -1, 3)
        return inter.reshape(B, -1) if flat else inter

    def wrap(self, q):
        return wrap2pi(q)


_PANDA_LIMITS = [[-2.8973, 2.8973],
                 [-1.7628, 1.7628],
                 [-2.8973, 2.8973],
                 [-3.0718, -0.0698],
                 [-2.8973, 2.8973],
                 [-0.0175, 3.7525],
                 [-2.8973, 2.8973]]


def panda_with_points(P: int) -> DHChainRobot:
    """PandaFK's chain with P control points (7 to 16): its own 7, then
    P - 7 more at fixed offsets in frames 2-7, ordered by frame. No robot
    of the catalogue has more than 7 DH points; this one reaches the DH
    kernels' instances for 3P padded to 32, 40 and 48 components."""
    robot = PandaFK()
    n = len(robot._dh_const)
    extra = tuple((2 + k % (n - 1), (0.04 * (1 + k % 3), 0.03 * (k % 2),
                                     0.02 * (1 + k % 4)))
                  for k in range(P - 7))
    robot._point_specs = tuple(sorted(robot._point_specs + extra,
                                      key=lambda s: s[0]))
    robot._fkine_flat = make_dh_fkine(
        robot._dh_const, robot._point_specs, base=robot._base_soa())
    return robot


class PandaFK(DHChainRobot):
    """7-DOF Franka Panda with two extra gripper-finger control points:
    5 masked frames plus 2 finger points on frame 7 (F = 21)."""

    def __init__(self):
        L = np.array([0.3330, 0.3160, 0.0825, 0.3840, 0.0880, 0.1070 * 2])
        dh = DHParameters(
            a=[0, 0, L[2], -L[2], 0, L[4], 0],
            alpha=[-PI / 2, PI / 2, PI / 2, -PI / 2, PI / 2, PI / 2, 0],
            d=[L[0], 0, L[1], 0, L[3], 0, L[5]],
            theta=[0, 0, 0, 0, 0, 0, 0])
        super().__init__(dh, _PANDA_LIMITS,
                         fk_mask=[True, False, True, True, True, False, True])
        # two finger control points offset +-d[-1]/2 along ee-frame y
        fy = 0.5 * float(dh.d[-1])
        n = len(self._dh_const)
        self._point_specs = self._point_specs + (
            (n, (0.0, fy, 0.0)), (n, (0.0, -fy, 0.0)))
        self._fkine_flat = make_dh_fkine(
            self._dh_const, self._point_specs, base=self._base_soa())

    def _fkine_soa_autodiff(self, q, flat: bool = False):
        frames = self._fk_frames_soa(q)
        pts = [t for i, (r, t) in enumerate(frames) if self.fk_mask[i]]
        r_ee, t_ee = frames[-1]
        fy = 0.5 * float(self.dhparams.d[-1])
        y_col = (r_ee[1], r_ee[4], r_ee[7])  # ee-frame y axis in world
        left = vec_add(t_ee, tuple(c * fy for c in y_col))
        right = vec_add(t_ee, tuple(c * (-fy) for c in y_col))
        return stack_points(pts + [left, right], flat=flat)


class DualPandaFK(Model):
    """14-DOF dual Panda: q interleaves (right, left) per joint; fkine
    returns [B, 14, 3], the left arm's 7 points (base at y = 0.84) then
    the right arm's."""

    def __init__(self):
        self.left_panda = PandaFK()
        self.right_panda = PandaFK()
        self.limits = torch.as_tensor(
            [row for row in _PANDA_LIMITS for _ in range(2)],
            dtype=torch.float32)
        self.dof = 14
        self.bases = torch.tensor([[0.0, 0.84, 0.0], [0.0, 0.0, 0.0]])

    def fkine(self, q):
        q = torch.reshape(q, (-1, 14))
        bases = self.bases.to(q)
        left = self.left_panda.fkine(q[:, 1::2]) + bases[0]
        right = self.right_panda.fkine(q[:, 0::2]) + bases[1]
        return torch.cat([left, right], dim=1)

    def wrap(self, q):
        return wrap2pi(q)


class PointRobot1D(Model):
    """1-DOF point robot with time as an extra dimension: configurations
    are (x, t) pairs in normalized [0, 1] coordinates, ``limits`` [dof + 1,
    2] the raw ranges of x and t."""

    def __init__(self, limits):
        self.limits = torch.as_tensor(np.asarray(limits),
                                      dtype=torch.float32)
        self.dof = 1

    def rand_configs(self, num_cfgs: int, generator: Optional[
            torch.Generator] = None, device=None) -> torch.Tensor:
        """Normalized space-time samples [num_cfgs, dof + 1], uniform in
        [0, 1], on ``device`` (default CUDA); the inherited sampler would
        broadcast a [N, 1] draw against the raw [2, 2] limits."""
        dev = resolve_device(device)
        gdev = generator.device if generator is not None else 'cpu'
        return torch.rand((num_cfgs, self.limits.shape[0]),
                          generator=generator, device=gdev).to(dev)

    def fkine(self, q):
        """The spatial coordinate unnormalized: q [..., dof] -> [B, dof]."""
        q = torch.reshape(q, (-1, self.dof))
        lims = self.limits.to(q.device, q.dtype)
        lo, hi = lims[:-1, 0], lims[:-1, 1]
        return q * (hi - lo) + lo

    def normalize(self, q):
        lims = self.limits.to(q.device, q.dtype)
        return (q - lims[:, 0]) / (lims[:, 1] - lims[:, 0])

    def unnormalize(self, q):
        lims = self.limits.to(q.device, q.dtype)
        return q * (lims[:, 1] - lims[:, 0]) + lims[:, 0]

    def wrap(self, q):
        return q
