"""The system under test, built from a configuration file through the
entry points a user calls: the robot, its scene, the ground truth, the
checker, and its fit on samples the benchmark draws from the seed."""
from __future__ import annotations

import numpy as np
import torch


class System:
    def __init__(self, config: dict, seeds: dict, device):
        import diffco_tpu_torch as dc
        self.config, self.device = config, torch.device(device)
        rc, gt = config['robot'], config['ground_truth']
        self.robot = getattr(dc, rc['class'])()
        self.env = dc.ShapeEnv({k: dict(v, transform=np.asarray(
            v['transform'])) for k, v in config['scene'].items()})
        self.cap = dc.CapsuleChainCollision(
            self.robot, link_radius=gt['link_radius'],
            per_seg=gt['per_seg'])
        ck = config['checker']
        self.checker = getattr(dc, ck['class'])(
            robot=self.robot,
            environment=self.env if ck['environment'] else None,
            gt_check_func=self.cap.checker_fn(self.env),
            seed=seeds['checker'], device=self.device, gamma=ck['gamma'],
            beta=ck['beta'], max_num_supports=ck['max_num_supports'])
        self.limits = torch.tensor(rc['limits'], dtype=torch.float32,
                                   device=self.device)
        fit = config['fit']
        self.fit_q = self.uniform(fit['num_samples'], seeds['fit'])
        self.checker.fit(q=self.fit_q, verify_ratio=fit['verify_ratio'])

    def uniform(self, n: int, seed: int):
        """n configurations uniform in the joint limits, drawn on the
        device from ``seed``."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        u = torch.rand((n, self.limits.shape[0]), generator=g,
                       device=self.device)
        lo, hi = self.limits[:, 0], self.limits[:, 1]
        return lo + u * (hi - lo)

    def supports(self):
        """The fitted proxy's valid support configurations [S, dof]."""
        p = self.checker.perceptron
        return p.support_points[:p.num_valid]

    def foreign_supports(self) -> int:
        """Supports that are none of the benchmark's fit samples: the
        greedy trainer picks supports among its training rows."""
        s = self.supports()
        hit = torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
        for i in range(0, self.fit_q.shape[0], 1024):
            blk = self.fit_q[i:i + 1024]
            hit |= (s[:, None] == blk[None]).all(-1).any(-1)
        return int((~hit).sum())
