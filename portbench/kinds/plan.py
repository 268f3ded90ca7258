"""Trajectory plans: each request is one problem through
``optim.adam_traj_optimize`` or, with ``problems_per_request`` > 1, that
many in one ``optim.adam_traj_optimize_batch`` call, against the proxy's
``score_fn(bias=0.0)`` with the safety bias as the margin.

Problems: (start, target) pairs of ground-truth-free configurations from
a pool drawn from the seed (``pool_configs`` uniform draws, the free ones
paired first with last, as the repo's Baxter benchmarks pick them), in a
seeded order. A request fails when it raises, reports a non-finite cost,
or reports no restart that met the constraints.

The check (after the window): the reference rebuilds the proxy from the
program's support configurations, then for every request
- ``score_gap``: the program's scores at the configurations it checked in
  its first ``check_steps`` + 1 steps, against the reference's at the same
  configurations (absolute);
- ``change_gap``: the reference follows the first ``check_steps`` Adam
  steps from the same inputs; per leaf (one joint of one restart's path)
  the gap between the program's and the reference's norm of the change,
  over the reference's norm of that leaf or the median leaf's, whichever
  is larger (the median over the problem's leaves); the mean over each
  problem's leaves (a worst leaf swings with the sign of Adam's first
  steps where a gradient component is near zero: PERF.md), the largest
  such mean over the problems, so that a fault in one problem of a batch
  is not diluted by the others; leaves whose first gradient in the
  reference is under a thousandth of the problem's median leaf's are left
  out (they move by round-off);
- ``cost_gap``: each plan's reported cost against the reference's
  objective of the returned path (relative);
and ``foreign_supports``, the fit's supports that are none of its samples.
Read but not compared: the gap between the program's first paths and the
reference's (``init_gap``, float32 rounding of the same draws; no control
or fault moves it) and the worst leaf's change gap
(``change_gap_worst_leaf``), both in ``read_only`` after the check.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import adam, proxy, scene
from portbench.reference.fk import dh_points

LR = 0.5              # adam_traj_optimize's default learning rate
READINGS_REQUESTS = 8     # the plans (or batches) a run checks


class Recorder:
    """``dist_est`` passed through, keeping the first ``keep`` inputs and
    outputs of each request (detached: no launch, no graph)."""

    def __init__(self, fn, keep: int):
        self.fn, self.keep, self.calls = fn, keep, []

    def __call__(self, q):
        out = self.fn(q)
        if len(self.calls) < self.keep:
            self.calls.append((q.detach(), out.detach()))
        return out


class Kind:
    def __init__(self, system, mix, seeds):
        import diffco_tpu_torch as dc
        self.optim = dc.optim
        self.sys, self.mix, self.seeds = system, mix, seeds
        self.device = system.device
        cfg = system.config
        q = system.uniform(mix['pool_configs'], seeds['pool'])
        sd = scene.signed_dist(q.double(), cfg['robot'], cfg['ground_truth'],
                               cfg['scene'])
        free = q[sd <= 0]
        P = mix['pool_problems']
        if free.shape[0] < 2 * P:
            raise RuntimeError(f'{free.shape[0]} free configurations for '
                               f'{P} problems')
        self.starts = free[0:2 * P:2]
        self.targets = free.flip(0)[0:2 * P:2]
        rng = np.random.default_rng(seeds['sample'])
        self.order = rng.permutation(P)
        self.k = self.answers = mix['problems_per_request']
        self.checker = system.checker
        self.opts = dict(mix['options'],
                         safety_margin=-self.checker.safety_bias)
        self.score = self.checker.score_fn(bias=0.0)
        self.foreign = system.foreign_supports()
        self.requests = []
        self.counts = {'plans': 0, 'adam_steps': 0}
        # warm-up: the request's shapes, a few steps
        self._plan(0, Recorder(self.score, 0),
                   dict(self.opts, MAXITER=mix['warmup_iterations']))

    def _problems(self, i):
        P = len(self.order)
        return [int(self.order[(i * self.k + j) % P]) for j in range(self.k)]

    def _plan(self, i, rec, opts):
        idx = self._problems(i)
        seed = self.seeds['restarts'] + i * self.k
        opts = dict(opts, seed=seed)
        if self.k == 1:
            out = [self.optim.adam_traj_optimize(
                self.sys.robot, rec, self.starts[idx[0]],
                self.targets[idx[0]], opts)]
        else:
            out = self.optim.adam_traj_optimize_batch(
                self.sys.robot, rec, self.starts[idx], self.targets[idx],
                opts)
        return idx, seed, out

    def before(self, i):
        pass

    def request(self, i):
        rec = Recorder(self.score, self.mix['check_steps'] + 1)
        idx, seed, out = self._plan(i, rec, self.opts)
        self.requests.append((idx, seed, out, rec.calls))
        failed = sum(1 for r in out if not (r['success']
                                            and math.isfinite(r['cost'])))
        self.counts['plans'] += self.k
        self.counts['adam_steps'] += self.opts['MAXITER']
        return {'attempted': self.k, 'failed': failed}

    def after(self, i):
        pass

    def window_closed(self):
        pass

    # -- the check ----------------------------------------------------------

    def reference(self, dtype=torch.float64, tf32=False):
        return proxy.Proxy(self.sys.supports(), self.sys.config,
                           self.sys.config['scene'], dtype, tf32)

    def first_paths(self, idx, seed, dtype):
        """The restarts' first paths [k T, N, dof] of one request, from its
        problems and its restart seeds."""
        o = self.opts
        T, N = o['NUM_RE_TRIALS'], o['N_WAYPOINTS']
        dof = self.starts.shape[1]
        draws = torch.stack([torch.rand(
            (T, N, dof), generator=torch.Generator().manual_seed(seed + j))
            for j in range(len(idx))]).to(self.device, dtype)
        lim = self.sys.limits.to(dtype)
        p = adam.initial_paths(self.starts[idx].to(dtype),
                               self.targets[idx].to(dtype), draws, lim)
        return p.reshape(-1, N, dof)

    def follow(self, ref, idx, seed, dtype=torch.float64):
        """The reference's first ``check_steps`` steps of one request:
        (paths after each step, the first gradient)."""
        o = self.opts
        return adam.steps(self.first_paths(idx, seed, dtype), ref.score,
                          self.sys.config['robot'],
                          self.sys.limits.to(dtype), o['safety_margin'],
                          o['max_speed'], o['dense_sub'], LR,
                          self.mix['check_steps'])

    def program_paths(self, idx, calls):
        """The program's paths at each recorded step, rebuilt from the
        configurations it checked: waypoint j sits at j dense_sub - 1 of
        the densified interior."""
        o = self.opts
        N, d = o['N_WAYPOINTS'], o['dense_sub']
        st, tg = self.starts[idx].double(), self.targets[idx].double()
        T = o['NUM_RE_TRIALS']
        out = []
        for q, _ in calls:
            q = q.double().reshape(len(idx) * T, -1, q.shape[-1])
            mid = q[:, [j * d - 1 for j in range(1, N - 1)]]
            p = torch.cat([st.repeat_interleave(T, 0)[:, None], mid,
                           tg.repeat_interleave(T, 0)[:, None]], 1)
            out.append(p)
        return out

    @staticmethod
    def change_gaps(prog, ref, g0, problems=1):
        """Per counted leaf, the gap of the norms of the change over the
        scale (see above), problem by problem (the paths are ``problems``
        equal blocks of restarts): (the largest problem's mean, the worst
        leaf's)."""
        n_ref = (ref[-1] - ref[0]).norm(dim=1)        # [paths, dof]
        n_prog = (prog[-1] - prog[0]).norm(dim=1)
        gn = g0.norm(dim=1)
        worst_mean = worst_leaf = 0.0
        for r, p, g in zip(n_ref.chunk(problems), n_prog.chunk(problems),
                           gn.chunk(problems)):
            keep = g >= 1e-3 * g.median()
            if not bool(keep.any()):
                continue
            scale = torch.clamp(r[keep], min=float(r[keep].median()))
            leaf = (p[keep] - r[keep]).abs() / scale
            worst_mean = max(worst_mean, float(leaf.mean()))
            worst_leaf = max(worst_leaf, float(leaf.max()))
        return worst_mean, worst_leaf

    def cost_gaps(self, out):
        """Each returned plan's reported cost against the reference's
        objective of its path (relative)."""
        gaps = []
        for r in out:
            sol = torch.tensor(r['solution'], dtype=torch.float64,
                               device=self.device)
            cp = dh_points(sol, self.sys.config['robot'])
            c = float(((cp[1:] - cp[:-1]) ** 2).sum())
            gaps.append(abs(r['cost'] - c) / max(c, 1e-9))
        return gaps

    def check(self):
        ref = self.reference()
        score_gap = cost = change = 0.0
        worst_leaf = init_gap = 0.0
        for idx, seed, out, calls in self.requests:
            for q, s in calls:
                score_gap = max(score_gap, float(
                    (s.double() - ref.scores(q)).abs().max()))
            ref_paths, g0 = self.follow(ref, idx, seed)
            prog = self.program_paths(idx, calls)
            init_gap = max(init_gap, float(
                (prog[0] - ref_paths[0]).abs().max()))
            if len(prog) == len(ref_paths):
                mean, worst = self.change_gaps(prog, ref_paths, g0,
                                               len(idx))
            else:
                mean = worst = math.inf
            change = max(change, mean)
            worst_leaf = max(worst_leaf, worst)
            cost = max([cost] + self.cost_gaps(out))
        self.read_only = {'change_gap_worst_leaf': worst_leaf,
                          'init_gap': init_gap}
        return {'score_gap': score_gap, 'change_gap': change,
                'cost_gap': cost,
                'foreign_supports': float(self.foreign)}

    def control(self):
        """The control's numbers: the reference in float32 with TF32
        products in the program's place, followed from the same inputs."""
        ref = self.reference()
        ctl = self.reference(dtype=torch.float32, tf32=True)
        sg, ch = 0.0, [0.0, 0.0]
        for idx, seed, _, _ in self.requests:
            ref_paths, g0 = self.follow(ref, idx, seed)
            ctl_paths, _ = self.follow(ctl, idx, seed, torch.float32)
            for p in ctl_paths:
                q = adam.checked(p, self.opts['dense_sub'])
                q = q.reshape(-1, q.shape[-1])
                sg = max(sg, float((ctl.scores(q).double()
                                    - ref.scores(q)).abs().max()))
            gaps = self.change_gaps([p.double() for p in ctl_paths],
                                    ref_paths, g0, len(idx))
            ch = [max(a, b) for a, b in zip(ch, gaps)]
        return {'score_gap': sg, 'change_gap': ch[0],
                'change_gap_worst_leaf': ch[1]}


# faults planted in the program under the timed path, each by
# ``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``)

def _unchanged(patch):
    """An Adam step that returns the paths unchanged."""
    from diffco_tpu_torch import optim
    real = optim._adam_update

    def frozen(g, mu, nu, count, lr):
        upd, mu, nu, count = real(g, mu, nu, count, lr)
        return torch.zeros_like(upd), mu, nu, count
    patch(optim, '_adam_update', frozen)


def _half(patch):
    """An Adam step that moves half of the paths and leaves the rest."""
    from diffco_tpu_torch import optim
    real = optim._adam_update

    def half(g, mu, nu, count, lr):
        upd, mu, nu, count = real(g, mu, nu, count, lr)
        keep = torch.ones_like(upd)
        keep[upd.shape[0] // 2:] = 0
        return upd * keep, mu, nu, count
    patch(optim, '_adam_update', half)


def _altered(patch):
    """The first plan's path altered where it is produced."""
    from diffco_tpu_torch import optim
    real = optim._adam_batch_core

    def altered(*a, **k):
        sol, cost, ok, step, hist = real(*a, **k)
        sol = sol.clone()
        sol[0, 1] += 0.1
        return sol, cost, ok, step, hist
    patch(optim, '_adam_batch_core', altered)


# the faults a plan cell can have (no cell spans chips)
FAULTS = {'unchanged': _unchanged, 'half': _half, 'altered': _altered}
