"""High-level collision-checker API (PyTorch counterpart of
``diffco_tpu/checkers.py``: ``CollisionChecker``, ``RBFDiffCo``,
``ForwardKinematicsDiffCo``).

A checker wires a robot, an environment, a ground-truth check function and
a kernel perceptron together: dataset generation, fit/verify with the
safety-bias rule, and the score functions the trajectory optimizers call.
Everything runs on the checker's ``device`` (CUDA unless the caller asks
for the CPU). Configurations are drawn from a seeded CPU
``torch.Generator`` and host-side splits from a seeded numpy stream, so a
seed gives the same datasets on every device.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Dict

import numpy as np
import torch

from . import kernels as kernel
from .device import fp32_matmul, resolve_device
from .envs.shape_env import ShapeEnv
from .perceptron import DiffCo
from .robots.urdf import URDFRobot


class CollisionChecker:
    """Base: resolves robot/environment arguments, the device and the
    ground-truth check function."""

    def __init__(self, robot=None, robot_base_transform=None,
                 environment=None, robot_topic=None,
                 planning_scene_topic=None, gt_check_func=None,
                 device=None, seed: int = 0, mesh=None):
        del planning_scene_topic
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                'mesh= is not ported yet (ROADMAP A15, torch.distributed)')
        if isinstance(robot, str):
            if not os.path.isfile(robot):
                raise ValueError('Invalid robot URDF file path')
            name = os.path.basename(robot).split('.')[0]
            robot = URDFRobot(robot, name=name,
                              base_transform=robot_base_transform,
                              device=self.device)
        if robot_topic is not None:
            raise NotImplementedError(
                'ROS robots are not ported yet (ROADMAP A15)')
        self.robot = robot
        if environment is not None and isinstance(environment, Dict):
            environment = ShapeEnv(environment)
        self.environment = environment
        if gt_check_func is None:
            if environment is not None:
                self.gt_check_func = partial(self.robot.collision,
                                             other=self.environment)
            else:
                self.gt_check_func = self.robot.collision
        else:
            self.gt_check_func = gt_check_func
        self._gen = torch.Generator().manual_seed(int(seed))
        self._seeds = np.random.SeedSequence(int(seed))

    def _next_rng(self) -> np.random.Generator:
        """A fresh host-side numpy stream derived from the checker's seed."""
        return np.random.default_rng(self._seeds.spawn(1)[0])

    def _rand_configs(self, n: int):
        return self.robot.rand_configs(n, self._gen, self.device)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _gt_labels(self, q):
        return self.gt_check_func(q)

    def collision(self, q):
        return self._gt_labels(q)

    def fkine(self, q, return_collision=False, **kwargs):
        return self.robot.compute_forward_kinematics_all_links(
            q, return_collision=return_collision, **kwargs)

    def normalizer(self, unnormalized_q):
        raise NotImplementedError

    def unnormalizer(self, normalized_q):
        raise NotImplementedError

    def _generate_dataset(self, q, labels, dists, num_samples,
                          fix_joints=None, fix_joint_values=None,
                          sample_transform=None, verbose=False):
        """Random configurations + ground-truth labels."""
        if q is None:
            if sample_transform is not None:
                raise NotImplementedError(
                    'manifold sampling is not ported yet (ROADMAP A13)')
            q = self._rand_configs(num_samples)
        q = self._tensor(q)
        if fix_joints is not None:
            q = q.clone()
            q[:, list(fix_joints)] = self._tensor(fix_joint_values)
        num_samples = q.shape[0]
        if labels is None:
            labels = self._tensor(self._gt_labels(q))
        else:
            labels = (self._tensor(labels) > 0).to(q.dtype)
        if dists is None:
            dists = torch.zeros(num_samples, dtype=q.dtype, device=q.device)
        else:
            dists = self._tensor(dists)
        return q, labels, dists


class RBFDiffCo(CollisionChecker):
    """Vanilla DiffCo over raw configurations (no FK transform)."""

    def __init__(self, robot=None, robot_base_transform=None,
                 environment=None, robot_topic=None,
                 planning_scene_topic=None, gt_check_func=None, device=None,
                 kernel_func=None, perceptron_class=DiffCo, seed: int = 0,
                 mesh=None, **perceptron_kwargs):
        super().__init__(robot=robot,
                         robot_base_transform=robot_base_transform,
                         environment=environment, robot_topic=robot_topic,
                         gt_check_func=gt_check_func, device=device,
                         seed=seed, mesh=mesh)
        if kernel_func is None:
            self.kernel_func = kernel.RQKernel(
                perceptron_kwargs.pop('gamma', 10))
        else:
            self.kernel_func = kernel_func
        self.perceptron = perceptron_class(kernel_func=self.kernel_func,
                                           **perceptron_kwargs)
        self._init_state()

    def _init_state(self):
        self.q_verify = None
        self.labels_verify = None
        self.safety_bias = 0.0
        self.perceptron_trained = False

    # -- fitting ------------------------------------------------------------

    def fit(self, q=None, labels=None, dists=None, update=False,
            exist_mask=None, num_samples=5000, verify_ratio=0.1,
            verbose=False, **get_dataset_kwargs):
        """Train the proxy from scratch and verify on a held-out split.
        Returns the biased (acc, tpr, tnr), or Nones without a split."""
        del exist_mask
        if update:
            raise NotImplementedError(
                'warm-start updates are not ported yet '
                '(ROADMAP A7, warm-start update)')
        get_dataset_kwargs.setdefault('verbose', not self.perceptron_trained)
        q, labels, dists = self._generate_dataset(
            q, labels, dists, num_samples, **get_dataset_kwargs)
        num_samples = q.shape[0]
        labels = 2 * labels - 1

        if 0 < verify_ratio < 1:
            rng = self._next_rng()
            num_verify = max(1, int(verify_ratio * num_samples))
            verify_idx = rng.permutation(num_samples)[:num_verify]
            verify_mask = np.zeros(num_samples, bool)
            verify_mask[verify_idx] = True
            vm = torch.as_tensor(verify_mask, device=q.device)
            q_train, q_verify = q[~vm], q[vm]
            labels_train, labels_verify = labels[~vm], labels[vm]
            dists_train = dists[~vm]
        elif verify_ratio:
            raise ValueError(
                f'verify_ratio should be in (0, 1), got {verify_ratio}')
        else:
            q_train, labels_train, dists_train = q, labels, dists
            q_verify = self._rand_configs(100)
            labels_verify = None

        # 3N iterations: the greedy loop often needs ~2N to converge
        self.perceptron.train(
            q_train, labels_train, max_iteration=3 * q_train.shape[0],
            distance=dists_train, verbose=verbose)
        self.perceptron.fit_poly(
            kernel_func=kernel.Polyharmonic(k=1, epsilon=1), target='label')
        self.safety_bias = self._calculate_safety_bias(q_verify)
        if verify_ratio:
            verify_acc, verify_tpr, verify_tnr = self.verify(
                q_verify, labels_verify, verbose=verbose)
            self.q_verify = q_verify
        else:
            verify_acc = verify_tpr = verify_tnr = None
        self.perceptron_trained = True
        return verify_acc, verify_tpr, verify_tnr

    def update(self, *args, **kwargs):
        raise NotImplementedError(
            'active-learning updates are not ported yet '
            '(ROADMAP A7, warm-start update)')

    # -- verification ---------------------------------------------------------

    def verify(self, q_verify=None, labels_verify=None, num_samples=None,
               verbose=False):
        """ACC/TPR/TNR with the safety bias. Returns the *biased* metrics."""
        if q_verify is None:
            if num_samples is not None:
                q_verify = self._rand_configs(num_samples)
                self.q_verify = q_verify
            elif self.q_verify is not None:
                q_verify = self.q_verify
            else:
                raise ValueError('q_verify or num_samples required')
        q_verify = self._tensor(q_verify)
        with torch.no_grad():
            scores = self._sweep_scores(q_verify)
        preds = 2 * (scores > 0).long() - 1
        biased_preds = 2 * (scores + self.safety_bias > 0).long() - 1
        if labels_verify is None:
            labels_verify = (2 * self._tensor(self._gt_labels(q_verify))
                             - 1)
        labels_verify = self._tensor(labels_verify).reshape(-1)

        def metrics(p):
            n_pos = torch.sum(labels_verify == 1)
            n_neg = torch.sum(labels_verify == -1)
            acc = torch.mean((p == labels_verify).float())
            tpr = torch.sum((p == 1) & (labels_verify == 1)) / torch.clamp(
                n_pos, min=1)
            tnr = torch.sum((p == -1) & (labels_verify == -1)) / torch.clamp(
                n_neg, min=1)
            return acc, tpr, tnr

        acc, tpr, tnr = metrics(preds)
        if verbose:
            print(f'Test acc: {acc:.4f}, TPR {tpr:.4f}, TNR {tnr:.4f}')
        bacc, btpr, btnr = metrics(biased_preds)
        if verbose:
            print(f'Biased Test acc: {bacc:.4f}, TPR {btpr:.4f}, '
                  f'TNR {btnr:.4f}')
        return (float(bacc), float(btpr), float(btnr))

    # -- inference ------------------------------------------------------------

    def collision(self, q):
        return self.collision_score(q).reshape(-1) > 0

    def collision_score(self, q, bias=None):
        """Biased smooth score, any leading batch shape."""
        bias = self.safety_bias if bias is None else bias
        q = self._tensor(q) if not torch.is_tensor(q) else q
        shape_q = q.shape
        raw = self._sweep_raw(q.reshape(-1, shape_q[-1]))   # [B, C]
        raw = raw.reshape(shape_q[:-1] + raw.shape[1:])
        return raw + bias

    def score_fn(self, bias=None):
        """A score function q [B, dof] -> [B] for the trajectory
        optimizers: a plain kernel matvec over the current support state
        (it reaches neither hand-written kernel). It runs on the device
        and in the dtype of q: the state is converted once per (device,
        dtype) and support set, and the copy kept (the scipy paths call it
        on CPU float64 tensors)."""
        bias = self.safety_bias if bias is None else bias
        perceptron = self.perceptron
        rbf_kernel = perceptron.rbf_kernel
        transform = perceptron._apply_transform
        copies = {}

        def state(like):
            now = (perceptron.support_transformed, perceptron.valid_mask,
                   perceptron.rbf_nodes)
            key = (like.device, like.dtype)
            if key not in copies or any(
                    a is not b for a, b in zip(copies[key][0], now)):
                copies[key] = (now, tuple(
                    t.to(device=like.device, dtype=like.dtype) for t in now))
            return copies[key][1]

        def fn(q):
            pt = transform(q)
            sup, mask, nodes = state(pt)
            with fp32_matmul():
                out = ((rbf_kernel(pt, sup) * mask[None, :])
                       @ nodes.reshape(-1, 1))
            return out.reshape(-1) + bias
        fn.follows_input = True
        return fn

    def _sweep_raw(self, q):
        """Proxy-score sweep over a [B, dof] batch -> [B, C]."""
        s = self.perceptron.poly_score(q)
        return s.reshape(s.shape[0], -1)

    def _sweep_scores(self, q):
        """Flat [B * C] view of ``_sweep_raw`` (what verify/bias use)."""
        return self._sweep_raw(q).reshape(-1)

    @torch.no_grad()
    def _calculate_safety_bias(self, q_verify):
        """min(|min score|, |max score|) / 3."""
        if q_verify.shape[0] == 0:
            q_verify = self._rand_configs(100)
        scores = self._sweep_scores(q_verify)
        min_polar = torch.minimum(torch.abs(scores.min()),
                                  torch.abs(scores.max()))
        return float(min_polar / 3)

    def normalizer(self, unnormalized_q):
        lims = self.robot.joint_limits.to(unnormalized_q.device)
        return (unnormalized_q - lims[:, 0]) / (lims[:, 1] - lims[:, 0])

    def unnormalizer(self, normalized_q):
        lims = self.robot.joint_limits.to(normalized_q.device)
        return normalized_q * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


class ForwardKinematicsDiffCo(RBFDiffCo):
    """DiffCo with the FK transform into workspace control points."""

    def __init__(self, robot=None, robot_base_transform=None,
                 environment=None, robot_topic=None,
                 planning_scene_topic=None, gt_check_func=None, device=None,
                 perceptron_class=DiffCo, seed: int = 0, mesh=None,
                 **perceptron_kwargs):
        CollisionChecker.__init__(
            self, robot=robot, robot_base_transform=robot_base_transform,
            environment=environment, robot_topic=robot_topic,
            gt_check_func=gt_check_func, device=device, seed=seed,
            mesh=mesh)
        self.tensorized_fkine = self.robot.fkine
        if hasattr(self.robot, 'unique_position_link_names'):
            self.unique_position_link_names = \
                self.robot.unique_position_link_names
        self.kernel_func = kernel.RQKernel(
            perceptron_kwargs.pop('gamma', 10))
        self.kernel_transform = self.tensorized_fkine
        self.perceptron = perceptron_class(
            kernel_func=self.kernel_func, transform=self.kernel_transform,
            **perceptron_kwargs)
        self._init_state()

    def collision_score(self, q=None, bias=None, q_link_pos=None):
        """Score from configurations or directly from link positions
        q_link_pos [..., P, 3]."""
        if q is not None:
            return super().collision_score(q, bias=bias)
        bias = self.safety_bias if bias is None else bias
        if q_link_pos is None:
            raise ValueError('q or q_link_pos required')
        p = (self._tensor(q_link_pos) if not torch.is_tensor(q_link_pos)
             else q_link_pos)
        raw = self.perceptron.poly_score(
            transformed_point=p.reshape((-1,) + p.shape[-2:]))
        raw = raw.reshape(p.shape[:-2] + raw.shape[1:])
        return raw + bias
