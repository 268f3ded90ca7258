"""High-level collision-checker API (PyTorch counterpart of
``diffco_tpu/checkers.py``: ``CollisionChecker``, ``RBFDiffCo``,
``ForwardKinematicsDiffCo``, ``HybridForwardKinematicsDiffCo``,
``OptimisticChecker`` and ``corridor_update``).

A checker wires a robot, an environment, a ground-truth check function and
a kernel perceptron together: dataset generation, fit/verify with the
safety-bias rule, active-learning updates (a warm-started retrain on
samples around the supports or around given paths), and the score
functions the trajectory optimizers call.
Everything runs on the checker's ``device`` (CUDA unless the caller asks
for the CPU). Configurations are drawn from a seeded CPU
``torch.Generator`` and host-side splits from a seeded numpy stream, so a
seed gives the same datasets on every device, and on every rank of a mesh.

With ``mesh=`` (``parallel.make_mesh``) a checker scales out SPMD over the
mesh's first axis: every rank makes the same calls, ground-truth labels
and score sweeps run on each rank's block of the rows and are gathered,
and training runs sharded (``perceptron.Perceptron``). Each rank scores
its local rows with ``poly_score``, so the kernel routers' batch gates
apply to the local size.
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
from .parallel import sharding
from .perceptron import DiffCo
from .profiling import span, spanned
from .robots.urdf import URDFRobot
from .sampler import (path_band_samples,
                      uniform_sample_on_transformed_manifold)


def _safety_bias(scores):
    """The safety bias of a sweep's scores, min(|min|, |max|) / 3, as a
    0-d tensor."""
    return torch.minimum(torch.abs(scores.min()), torch.abs(scores.max())) / 3


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class CollisionChecker:
    """Base: resolves robot/environment arguments, the device and the
    ground-truth check function. ``robot_topic`` takes the robot and its
    ground truth from ROS (``ros_interface.ROSRobotEnv``, MoveIt's
    StateValidity service); ``mesh`` shards the checker's batches (module
    docstring)."""

    def __init__(self, robot=None, robot_base_transform=None,
                 environment=None, robot_topic=None,
                 planning_scene_topic=None, gt_check_func=None,
                 device=None, seed: int = 0, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if isinstance(robot, str):
            if not os.path.isfile(robot):
                raise ValueError('Invalid robot URDF file path')
            name = os.path.basename(robot).split('.')[0]
            robot = URDFRobot(robot, name=name,
                              base_transform=robot_base_transform,
                              device=self.device)
        if robot_topic is not None:
            from .ros_interface import ROSRobotEnv
            robot = ROSRobotEnv(robot_topic=robot_topic,
                                planning_scene_topic=planning_scene_topic)
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

    def _meshed(self):
        return self.mesh is not None and not sharding.is_rank_local()

    def _gt_labels(self, q):
        """Ground-truth labels; with a mesh each rank labels its block of
        the rows and the blocks are gathered."""
        if not self._meshed():
            return self.gt_check_func(q)
        q = q if torch.is_tensor(q) else self._tensor(q)
        shard = sharding.row_shard(self.mesh, q.shape[0])
        labels = torch.as_tensor(self.gt_check_func(
            sharding.row_block(q, shard)), device=q.device)
        return shard.gather(labels)[:q.shape[0]]

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
        """Random configurations + ground-truth labels. With
        ``sample_transform`` the configurations are uniform on that
        transform's image (``uniform_sample_on_transformed_manifold``)
        instead of in joint space."""
        if q is None:
            if sample_transform is not None:
                q = uniform_sample_on_transformed_manifold(
                    self.robot, sample_transform, num_samples, self._gen,
                    self.device)
            else:
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
                         planning_scene_topic=planning_scene_topic,
                         gt_check_func=gt_check_func, device=device,
                         seed=seed, mesh=mesh)
        if kernel_func is None:
            self.kernel_func = kernel.RQKernel(
                perceptron_kwargs.pop('gamma', 10))
        else:
            self.kernel_func = kernel_func
        self.perceptron = perceptron_class(kernel_func=self.kernel_func,
                                           mesh=mesh, **perceptron_kwargs)
        self._init_state()

    def _init_state(self):
        self.q_verify = None
        self.labels_verify = None
        self.safety_bias = 0.0
        self.perceptron_trained = False

    # -- fitting ------------------------------------------------------------

    @spanned('diffco.checker.fit', keep=True)
    def fit(self, q=None, labels=None, dists=None, update=False,
            exist_mask=None, num_samples=5000, verify_ratio=0.1,
            verbose=False, **get_dataset_kwargs):
        """Train the proxy (from scratch, or warm-started with ``update``
        from the current supports, whose rows of q ``exist_mask`` marks)
        and verify on a held-out split. Returns the biased (acc, tpr,
        tnr), or Nones without a split."""
        get_dataset_kwargs.setdefault('verbose', not self.perceptron_trained)
        with span('diffco.checker.labels'):
            q, labels, dists = self._generate_dataset(
                q, labels, dists, num_samples, **get_dataset_kwargs)
        num_samples = q.shape[0]
        labels = 2 * labels - 1

        warm = update and exist_mask is not None
        if warm:
            exist_mask = _numpy(exist_mask).astype(bool)
        if 0 < verify_ratio < 1:
            rng = self._next_rng()
            num_verify = max(1, int(verify_ratio * num_samples))
            if warm:
                # the previous supports stay in the training split (the
                # warm start seeds their gains by position): the verify
                # rows come from the other rows, an exact count of them
                non_exist = np.where(~exist_mask)[0]
                num_verify = min(num_verify, len(non_exist))
                verify_idx = non_exist[
                    rng.permutation(len(non_exist))[:num_verify]]
            else:
                verify_idx = rng.permutation(num_samples)[:num_verify]
            verify_mask = np.zeros(num_samples, bool)
            verify_mask[verify_idx] = True
            vm = torch.as_tensor(verify_mask, device=q.device)
            q_train, q_verify = q[~vm], q[vm]
            labels_train, labels_verify = labels[~vm], labels[vm]
            dists_train = dists[~vm]
            if warm:
                exist_mask = exist_mask[~verify_mask]
        elif verify_ratio:
            raise ValueError(
                f'verify_ratio should be in (0, 1), got {verify_ratio}')
        else:
            q_train, labels_train, dists_train = q, labels, dists
            q_verify = self._rand_configs(100)
            labels_verify = None

        # 3N iterations: the greedy loop often needs ~2N to converge
        with span('diffco.perceptron.train'):
            self.perceptron.train(
                q_train, labels_train, update=update, exist_mask=exist_mask,
                max_iteration=3 * q_train.shape[0], distance=dists_train,
                verbose=verbose)
        with span('diffco.perceptron.fit_poly'):
            self.perceptron.fit_poly(
                kernel_func=kernel.Polyharmonic(k=1, epsilon=1),
                target='label')
        with span('diffco.checker.verify'):
            # one sweep gives the safety bias and the metrics, one host
            # read brings them back; an empty split (a warm update with no
            # new rows) takes the bias from 100 fresh configurations, as
            # _calculate_safety_bias does
            with torch.no_grad():
                rows = (q_verify if q_verify.shape[0]
                        else self._rand_configs(100))
                scores = self._sweep_scores(rows)
            bias = _safety_bias(scores)
            verify_acc = verify_tpr = verify_tnr = None
            if verify_ratio:
                metrics = self._verify_metrics(
                    scores if rows is q_verify else scores[:0], bias,
                    labels_verify, verbose)
                (self.safety_bias, verify_acc, verify_tpr,
                 verify_tnr) = torch.stack([bias, *metrics]).tolist()
                self.q_verify = q_verify
            else:
                self.safety_bias = float(bias)
        self.perceptron_trained = True
        return verify_acc, verify_tpr, verify_tnr

    @spanned('diffco.checker.update', keep=True)
    def update(self, q=None, labels=None, dists=None, exploit_std=0.3,
               num_samples=100, num_exploit_samples=None,
               num_explore_samples=None, verify=False, verbose=False,
               exploit_paths=None, path_band_scales=(0.05, 0.15, 0.35),
               path_num_sub=8):
        """Active-learning update: a warm-started ``fit`` on exploit
        samples, uniform explore samples and the current supports.

        The exploit samples jitter the supports (``exploit_std``, tiled
        when more are asked for than there are supports, clipped to the
        joint limits) or, with ``exploit_paths`` (a list of [N_i, dof]
        waypoint paths), come from bands around those paths
        (``sampler.path_band_samples``): feed it a failed trajectory or a
        planner's path through the region the proxy mislabels, then
        re-run the optimizer. Explore samples pad the total to a multiple
        of 256 over the padded support size. The dataset is exploit,
        explore, then the supports in the support buffer's order, which
        ``exist_mask`` marks. ``verify=True`` holds out 0.1 of the rows, a
        float that ratio. Raises RuntimeError before the first fit. With
        ``q`` given, that is the dataset (no exist_mask).

        The ground truth is ``gt_check_func``. A closure bound to a scene
        (``CapsuleChainCollision.checker_fn(env)``) keeps the scene it was
        bound to: after moving an obstacle (``ShapeEnv.update_transform``
        replaces ``env.scene``) rebind it, for example
        ``checker.gt_check_func = cap.checker_fn(env)``, as the JAX
        package's callers must too."""
        n_exploit = (num_samples if num_exploit_samples is None
                     else num_exploit_samples)
        n_explore = (num_samples if num_explore_samples is None
                     else num_explore_samples)
        verify_ratio = 0.1 if verify is True else float(verify)
        exist_mask = None
        if q is None:
            rng = self._next_rng()
            nv = self.perceptron.num_valid
            if nv == 0:
                raise RuntimeError(
                    'update() needs a trained checker (no supports yet) - '
                    'call fit() first')
            supports = _numpy(self.perceptron.support_points[:nv])
            dof = supports.shape[-1]
            lims = _numpy(self.robot.joint_limits)
            if exploit_paths is not None:
                exploit = path_band_samples(
                    [_numpy(p) for p in exploit_paths], lims, rng,
                    n_total=n_exploit, num_sub=path_num_sub,
                    scales=path_band_scales)
            else:
                if n_exploit > nv:
                    reps = -(-n_exploit // nv)
                    centers = np.tile(supports, (reps, 1))[:n_exploit]
                else:
                    centers = supports[rng.permutation(nv)[:n_exploit]]
                exploit = np.clip(
                    centers + rng.normal(size=centers.shape) * exploit_std,
                    lims[:, 0], lims[:, 1])
            # the total bucketed to a multiple of 256 on the padded support
            # size (stable across updates), the rest drawn as explore
            base_total = exploit.shape[0] + n_explore + nv
            s_pad = self.perceptron.support_points.shape[0]
            bucket = -(-(exploit.shape[0] + n_explore + s_pad) // 256) * 256
            n_explore_padded = n_explore + (bucket - base_total)
            explore = rng.uniform(lims[:, 0], lims[:, 1],
                                  (n_explore_padded, dof))
            q = self._tensor(np.concatenate([exploit, explore, supports],
                                            axis=0).astype(np.float32))
            exist_mask = np.zeros(q.shape[0], bool)
            exist_mask[-nv:] = True
        return self.fit(q, labels, dists, update=True,
                        exist_mask=exist_mask, verify_ratio=verify_ratio,
                        verbose=verbose)

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
        if labels_verify is None:
            labels_verify = (2 * self._tensor(self._gt_labels(q_verify))
                             - 1)
        return tuple(torch.stack(self._verify_metrics(
            scores, self.safety_bias, labels_verify, verbose)).tolist())

    def _verify_metrics(self, scores, bias, labels_verify, verbose=False):
        """The biased (acc, tpr, tnr) of sweep scores against labels in
        +-1, as 0-d tensors on the scores' device; ``verbose`` prints the
        unbiased and the biased ones."""
        preds = 2 * (scores > 0).long() - 1
        biased_preds = 2 * (scores + bias > 0).long() - 1
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
        return bacc, btpr, btnr

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
            with span('diffco.checker.score'):
                pt = transform(q)
                sup, mask, nodes = state(pt)
                with fp32_matmul():
                    out = ((rbf_kernel(pt, sup) * mask[None, :])
                           @ nodes.reshape(-1, 1))
                return out.reshape(-1) + bias
        fn.follows_input = True
        return fn

    def _sweep_raw(self, q):
        """Proxy-score sweep over a [B, dof] batch -> [B, C]. With a mesh
        each rank scores its block of the rows (padded to a multiple of
        the first axis) and the blocks are gathered, the padding dropped;
        the gradient in q flows back whole to every rank."""
        if not self._meshed():
            s = self.perceptron.poly_score(q)
            return s.reshape(s.shape[0], -1)
        shard = sharding.row_shard(self.mesh, q.shape[0])
        s = self.perceptron.poly_score(sharding.row_block(q, shard))
        return sharding.gather_rows(s.reshape(s.shape[0], -1),
                                    shard)[:q.shape[0]]

    def _sweep_scores(self, q):
        """Flat [B * C] view of ``_sweep_raw`` (what verify/bias use)."""
        return self._sweep_raw(q).reshape(-1)

    @torch.no_grad()
    def _calculate_safety_bias(self, q_verify):
        """min(|min score|, |max score|) / 3."""
        if q_verify.shape[0] == 0:
            q_verify = self._rand_configs(100)
        return float(_safety_bias(self._sweep_scores(q_verify)))

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
            planning_scene_topic=planning_scene_topic,
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
            mesh=mesh, **perceptron_kwargs)
        self._init_state()

    def _uniform_sample_on_transformed_manifold(self, transform,
                                                num_samples):
        """Configurations uniform on the image of ``transform`` (e.g. the
        FK control points), from the checker's generator."""
        return uniform_sample_on_transformed_manifold(
            self.robot, transform, num_samples, self._gen, self.device)

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


def corridor_update(base_dataset, paths, limits, gt_dist_fn, retrain, rng,
                    n_total=2048, num_sub=8, scales=(0.05, 0.15, 0.35),
                    device=None):
    """Path-targeted active learning for a bare perceptron and its
    dataset, the functional twin of ``RBFDiffCo.update(exploit_paths=)``:
    draw bands around ``paths`` (``sampler.path_band_samples``), label
    them with the ground truth's signed distance ``gt_dist_fn`` (a tensor
    of configurations on ``device``, CUDA unless the caller asks for the
    CPU, -> [n], positive in collision), append them to the dataset and
    rebuild the proxy with the caller's ``retrain(cfgs, labels, dists)``
    (a full retrain: a bare perceptron keeps no warm-start bookkeeping).

    base_dataset: (cfgs, labels, dists) numpy arrays. Returns
    (retrain's result, samples, signed distances), numpy."""
    cfgs, labels, dists = base_dataset
    samples = path_band_samples(paths, limits, rng, n_total=n_total,
                                num_sub=num_sub, scales=scales)
    sd = _numpy(gt_dist_fn(torch.as_tensor(samples,
                                           device=resolve_device(device))))
    new_cfgs = np.concatenate([cfgs, samples], axis=0)
    new_labels = np.concatenate([labels, (sd > 0) * 2.0 - 1.0], axis=0)
    new_dists = np.concatenate([dists, sd], axis=0)
    return retrain(new_cfgs, new_labels, new_dists), samples, sd


class HybridForwardKinematicsDiffCo(ForwardKinematicsDiffCo):
    """Proxy labels re-checked with the ground truth where the proxy is
    unsure: rows whose unbiased score lies within the safety bias of 0
    take the ground truth's label (computed for the whole batch in one
    sweep, as in the JAX package); with ``lazy_line_check`` only the row
    of the highest score is checked exactly."""

    def __init__(self, *args, lazy_line_check=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.lazy_line_check = lazy_line_check

    def collision(self, q):
        q = torch.atleast_2d(q if torch.is_tensor(q) else self._tensor(q))
        with torch.no_grad():
            unbias = self.collision_score(q, bias=0).reshape(-1)
        labels = unbias + self.safety_bias > 0
        if self.lazy_line_check:
            max_i = torch.argmax(unbias)
            gt = torch.as_tensor(self.gt_check_func(q[max_i][None]),
                                 device=labels.device).reshape(())
            labels = labels.clone()
            labels[max_i] = gt.to(torch.bool)
        else:
            uncertain = ((unbias + self.safety_bias > 0)
                         & (unbias - self.safety_bias < 0))
            gt = torch.as_tensor(self._gt_labels(q),
                                 device=labels.device).reshape(-1)
            labels = torch.where(uncertain, gt.to(torch.bool), labels)
        return labels


class OptimisticChecker(HybridForwardKinematicsDiffCo):
    """``in_collision`` of a set of states: any state in collision by the
    hybrid check, or, optimistic, only a score above the safety bias
    counts as a collision."""

    def in_collision(self, states, optimistic=False):
        states = torch.atleast_2d(states if torch.is_tensor(states)
                                  else self._tensor(states))
        if optimistic:
            with torch.no_grad():
                scores = self.collision_score(states, bias=0).reshape(-1)
            return bool(scores.max() - self.safety_bias > 0)
        return bool(torch.any(self.collision(states)))
