"""Batched score and gradient queries: each request is
``checker.collision_score(q)`` over ``batch`` configurations and the
gradient of its sum in q (``torch.autograd.grad``), ending when the host
has read one reduction of the result: the count scored in collision
(with the count of non-finite scores and gradients, for ``failed``).

The configurations: ``pools`` batches drawn at set-up from the seed,
used in turn (more than the card's L2 cache holds, so no call finds its
input there).

The check (after the window): the reference rebuilds the proxy from the
program's support configurations and scores ``check_rows`` rows drawn
from the seed in the first and the last request, with their gradients:
- ``score_gap``: the largest gap between the program's unbiased score
  and the reference's (absolute);
- ``grad_gap``: the largest gap of a gradient component, over the largest
  component of the reference's gradients in the sample;
and ``foreign_supports``, the fit's supports that are none of its
samples.
"""
from __future__ import annotations

import torch

from portbench.reference import proxy

READINGS_REQUESTS = 2       # the calls a run checks: the first, the last


class Kind:
    def __init__(self, system, mix, seeds):
        self.sys, self.mix, self.seeds = system, mix, seeds
        self.device = system.device
        self.checker = system.checker
        self.pools = [system.uniform(mix['batch'], seeds['pool'] + j)
                      .requires_grad_(True) for j in range(mix['pools'])]
        self.kept = {}
        self.foreign = system.foreign_supports()
        p = self.checker.perceptron
        P = len(system.config['robot']['points'])
        dof = system.config['robot']['dof']
        self.work = {'B': mix['batch'], 'S': p.num_valid, 'F': 3 * P,
                     'J': dof, 'P': P, 'D': dof}
        self.counts = {'configs': 0, 'calls': 0}
        self._call(0)                      # warm-up, the request's shape

    def _call(self, i):
        q = self.pools[i % len(self.pools)]
        s = self.checker.collision_score(q)
        g, = torch.autograd.grad(s.sum(), q)
        stats = torch.stack([
            (s > 0).sum(),
            (~torch.isfinite(s)).sum() + (~torch.isfinite(g)).sum()]).tolist()
        return q, s, g, stats

    def before(self, i):
        pass

    def request(self, i):
        q, s, g, (hits, bad) = self._call(i)
        if i == 0:
            self.kept['first'] = (i, s.detach(), g)
        self.kept['last'] = (i, s.detach(), g)
        self.counts['configs'] += q.shape[0]
        self.counts['calls'] += 1
        return {'attempted': 1, 'failed': int(bad > 0)}

    def after(self, i):
        pass

    def window_closed(self):
        pass

    def reference(self, dtype=torch.float64, tf32=False):
        return proxy.Proxy(self.sys.supports(), self.sys.config,
                           self.sys.config['scene'], dtype, tf32)

    def sample(self):
        """[(configurations, program scores unbiased, program gradients)]
        of the checked rows."""
        g = torch.Generator().manual_seed(self.seeds['sample'])
        bias = self.checker.safety_bias
        out = []
        for i, s, grad in self.kept.values():
            n = s.shape[0]
            rows = torch.randperm(n, generator=g)[:self.mix['check_rows']]
            rows = rows.to(s.device)
            q = self.pools[i % len(self.pools)].detach()[rows]
            out.append((q, s.reshape(-1)[rows].double() - bias,
                        grad[rows].double()))
        return out

    @staticmethod
    def gaps(ref, rows):
        sg = gg = gmax = 0.0
        for q, s, grad in rows:
            rs, rg = ref.score_grad(q)
            sg = max(sg, float((s - rs.double()).abs().max()))
            gg = max(gg, float((grad - rg.double()).abs().max()))
            gmax = max(gmax, float(rg.abs().max()))
        return sg, gg / gmax

    def check(self):
        sg, gg = self.gaps(self.reference(), self.sample())
        return {'score_gap': sg, 'grad_gap': gg,
                'foreign_supports': float(self.foreign)}

    def control(self):
        """The control's numbers: the reference in float32 with TF32
        products in the program's place."""
        ctl = self.reference(dtype=torch.float32, tf32=True)
        rows = []
        for q, _, _ in self.sample():
            s, g = ctl.score_grad(q)
            rows.append((q, s.double(), g.double()))
        sg, gg = self.gaps(self.reference(), rows)
        return {'score_gap': sg, 'grad_gap': gg}


# faults planted in the program under the timed path, each by
# ``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``)

def _half(patch):
    """Half of the batch scored, the rest given the mean of that half."""
    from diffco_tpu_torch.perceptron import DiffCo
    real = DiffCo.poly_score

    def half(self, point=None, transformed_point=None):
        s = real(self, point, transformed_point)
        n = s.shape[0] // 2
        return torch.cat([s[:n], s[:n].mean(0, keepdim=True)
                          .expand(s.shape[0] - n, *s.shape[1:])])
    patch(DiffCo, 'poly_score', half)


def _altered(patch):
    """One score altered where it is produced."""
    from diffco_tpu_torch.perceptron import DiffCo
    real = DiffCo.poly_score

    def altered(self, point=None, transformed_point=None):
        s = real(self, point, transformed_point)
        bump = torch.zeros_like(s)
        bump[s.shape[0] // 3] = 0.1
        return s + bump
    patch(DiffCo, 'poly_score', altered)


# the faults a sweep cell can have (it keeps no state between calls; no
# cell spans chips)
FAULTS = {'half': _half, 'altered': _altered}
