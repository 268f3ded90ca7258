"""Sampling-based motion planners whose collision checks are batched
(PyTorch counterpart of ``diffco_tpu/planning.py``): ``MotionPlanner``
(RRT-Connect with densified output) and ``RRTStar`` (with edge costs
weighted by a proxy score).

The trees grow on the host in numpy, with ``np.random.RandomState(seed)``
drawn in the JAX package's order, so that both packages build the same
tree from the same collision answers. Each round hands every candidate
motion (densified) to ``collision_fn`` in one call, as float32 rows on
``device``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from .device import resolve_device


def _limits(robot) -> np.ndarray:
    lim = robot.limits
    return lim.detach().cpu().numpy() if torch.is_tensor(lim) \
        else np.asarray(lim)


class _Checks:
    """Runs a user's collision or score function on host rows: float32
    rows on ``device`` in, a flat numpy array out; ``cnt_check`` counts
    the rows checked for collision."""

    def _setup(self, robot, collision_fn, seed, device):
        self.robot = robot
        self.collision_fn = collision_fn
        self.rng = np.random.RandomState(seed)
        self.limits = _limits(robot)
        self.device = resolve_device(device)
        self.cnt_check = 0

    def _call(self, fn, rows: np.ndarray) -> np.ndarray:
        out = fn(torch.as_tensor(rows, dtype=torch.float32,
                                 device=self.device))
        out = out.detach().cpu().numpy() if torch.is_tensor(out) \
            else np.asarray(out)
        return out.reshape(-1)

    def _motions_valid(self, starts: np.ndarray, ends: np.ndarray,
                       n_check: int) -> np.ndarray:
        """Validity of the K straight motions starts[k] -> ends[k], each
        checked at ``n_check`` evenly spaced points, in one call."""
        ts = np.linspace(0.0, 1.0, n_check)
        pts = starts[:, None, :] + ts[None, :, None] * (
            ends - starts)[:, None, :]
        flat = pts.reshape(-1, starts.shape[1])
        self.cnt_check += len(flat)
        hits = self._call(self.collision_fn, flat).astype(bool)
        return ~hits.reshape(len(starts), -1).any(axis=1)


class MotionPlanner(_Checks):
    """RRT-Connect over the configuration space.

    robot: gives the joint limits. collision_fn: q [B, dof] (float32 on
    ``device``, CUDA unless the caller asks for the CPU) -> bool [B], True
    in collision: the proxy checker for speed, or the geometric ground
    truth for exactness."""

    def __init__(self, robot, collision_fn: Callable, step_size: float = 0.3,
                 check_resolution: int = 8, seed: int = 0, device=None):
        self._setup(robot, collision_fn, seed, device)
        self.step_size = step_size
        self.check_resolution = check_resolution

    def _sample(self) -> np.ndarray:
        u = self.rng.rand(self.limits.shape[0])
        return self.limits[:, 0] + u * (self.limits[:, 1] - self.limits[:, 0])

    def plan(self, start, goal, max_iters: int = 2000,
             dense_output: bool = True, batch: int = 32
             ) -> Optional[np.ndarray]:
        """A path [N, dof] (numpy) from start to goal, or None.

        Grows the two trees ``batch`` samples at a time, swapping them each
        round: K random targets are steered from their nearest nodes, the
        K candidate motions are checked in one call, and the K cross-tree
        connections of the nodes added in another (densified in proportion
        to their length). With ``dense_output`` each segment is cut into
        steps of at most half ``step_size``."""
        start = np.asarray(start, np.float64)
        goal = np.asarray(goal, np.float64)
        self.cnt_check = 0
        trees = [{'nodes': [start], 'parent': [-1]},
                 {'nodes': [goal], 'parent': [-1]}]
        a, b = 0, 1
        for _ in range(max(1, max_iters // batch)):
            targets = np.stack([self._sample() for _ in range(batch)])
            nodes_a = np.asarray(trees[a]['nodes'])
            d2 = ((nodes_a[None, :, :] - targets[:, None, :]) ** 2).sum(-1)
            ni = d2.argmin(axis=1)
            anchors = nodes_a[ni]
            delta = targets - anchors
            dist = np.linalg.norm(delta, axis=1, keepdims=True)
            scale = np.minimum(1.0, self.step_size / np.maximum(dist, 1e-12))
            q_new = anchors + delta * scale
            valid = self._motions_valid(anchors, q_new,
                                        self.check_resolution)
            added_idx = []
            for k in np.where(valid)[0]:
                trees[a]['nodes'].append(q_new[k])
                trees[a]['parent'].append(int(ni[k]))
                added_idx.append(len(trees[a]['nodes']) - 1)
            if not added_idx:
                a, b = b, a
                continue

            new_nodes = np.asarray([trees[a]['nodes'][i] for i in added_idx])
            nodes_b = np.asarray(trees[b]['nodes'])
            d2b = ((nodes_b[None, :, :] - new_nodes[:, None, :]) ** 2).sum(-1)
            bi = d2b.argmin(axis=1)
            max_len = float(np.sqrt(d2b[np.arange(len(bi)), bi]).max())
            n_check = max(self.check_resolution,
                          int(np.ceil(max_len / self.step_size))
                          * self.check_resolution)
            connected = self._motions_valid(new_nodes, nodes_b[bi], n_check)
            if connected.any():
                k = int(np.where(connected)[0][0])
                path_a = self._trace(trees[a], added_idx[k])
                path_b = self._trace(trees[b], int(bi[k]))
                path = np.asarray(path_a[::-1] + path_b if a == 0
                                  else path_b[::-1] + path_a)
                return self._densify(path) if dense_output else path
            a, b = b, a
        return None

    @staticmethod
    def _trace(tree, idx) -> List[np.ndarray]:
        out = []
        while idx >= 0:
            out.append(tree['nodes'][idx])
            idx = tree['parent'][idx]
        return out

    def _densify(self, path: np.ndarray) -> np.ndarray:
        out = [path[0]]
        for i in range(len(path) - 1):
            seg = np.linalg.norm(path[i + 1] - path[i])
            n = max(1, int(math.ceil(seg / (self.step_size / 2))))
            for k in range(1, n + 1):
                out.append(path[i] + (path[i + 1] - path[i]) * k / n)
        return np.asarray(out)


class RRTStar(_Checks):
    """RRT* whose edge cost is length * (1 + score_weight * max(0,
    score)) with the score of ``score_fn`` (q [B, dof] -> [B], on
    ``device``) at the edge's midpoint, or the plain length without
    one."""

    def __init__(self, robot, collision_fn: Callable,
                 score_fn: Optional[Callable] = None,
                 step_size: float = 0.3, radius: float = 0.6,
                 score_weight: float = 1.0, check_resolution: int = 8,
                 seed: int = 0, device=None):
        self._setup(robot, collision_fn, seed, device)
        self.score_fn = score_fn
        self.step_size = step_size
        self.radius = radius
        self.score_weight = score_weight
        self.check_resolution = check_resolution

    def _edge_costs(self, anchors: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Costs of the edges anchors[k] -> b, the scores in one call."""
        lengths = np.linalg.norm(anchors - b[None], axis=1)
        if self.score_fn is None:
            return lengths
        sc = self._call(self.score_fn, (anchors + b[None]) / 2)
        return lengths * (1.0 + self.score_weight * np.maximum(0.0, sc))

    def _valid_to(self, anchors: np.ndarray, b: np.ndarray) -> np.ndarray:
        return self._motions_valid(
            anchors, np.broadcast_to(b, anchors.shape),
            self.check_resolution)

    def plan(self, start, goal, max_iters: int = 1000,
             goal_tol: float = 0.3):
        """A path [N, dof] (numpy) from start to goal, or None: each
        iteration steers towards a random target (the goal one time in
        ten), picks the cheapest valid parent within ``radius``, rewires
        the neighbours through the new node and records an edge to the
        goal when the node is within ``goal_tol``; the cheapest goal edge
        is chosen at the end."""
        start = np.asarray(start, np.float64)
        goal = np.asarray(goal, np.float64)
        self.cnt_check = 0
        nodes, parent, cost = [start], [-1], [0.0]
        goal_edges = {}
        for _ in range(max_iters):
            q_rand = goal if self.rng.rand() < 0.1 else (
                self.limits[:, 0] + self.rng.rand(len(self.limits))
                * (self.limits[:, 1] - self.limits[:, 0]))
            arr = np.asarray(nodes)
            ni = int(np.argmin(((arr - q_rand) ** 2).sum(1)))
            d = np.linalg.norm(q_rand - arr[ni])
            q_new = q_rand if d <= self.step_size else (
                arr[ni] + (q_rand - arr[ni]) * self.step_size / d)
            if not self._valid_to(arr[ni][None], q_new)[0]:
                continue
            near = np.where(np.linalg.norm(arr - q_new, axis=1)
                            < self.radius)[0]
            if len(near) == 0:
                near = np.asarray([ni])
            edge_c = self._edge_costs(arr[near], q_new)
            valid = self._valid_to(arr[near], q_new)
            cand_c = np.where(valid, np.asarray([cost[j] for j in near])
                              + edge_c, np.inf)
            if not np.isfinite(cand_c).any():
                continue
            k = int(np.argmin(cand_c))
            best_c = float(cand_c[k])
            nodes.append(q_new)
            parent.append(int(near[k]))
            cost.append(best_c)
            idx_new = len(nodes) - 1
            # rewire; edge costs are >= 0, so no ancestor of idx_new can
            # get cheaper through it (no cycles)
            for kk, j in enumerate(near):
                c_through = best_c + edge_c[kk]
                if valid[kk] and c_through < cost[j]:
                    parent[j] = idx_new
                    delta = cost[j] - c_through
                    cost[j] = c_through
                    stack = [int(j)]          # j's subtree gets cheaper too
                    while stack:
                        p = stack.pop()
                        for ch in range(len(parent)):
                            if parent[ch] == p and ch != p:
                                cost[ch] -= delta
                                stack.append(ch)
            if np.linalg.norm(q_new - goal) < goal_tol and \
                    self._valid_to(q_new[None], goal)[0]:
                goal_edges[idx_new] = float(
                    self._edge_costs(q_new[None], goal)[0])
        if not goal_edges:
            return None
        idx = min(goal_edges, key=lambda j: cost[j] + goal_edges[j])
        path = [goal]
        while idx >= 0:
            path.append(nodes[idx])
            idx = parent[idx]
        return np.asarray(path[::-1])
