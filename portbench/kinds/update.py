"""The proxy follows a moving obstacle: each request moves ``obstacle`` to
the next of ``positions`` places from ``x[0]`` to ``x[1]`` at (``y``,
``z``), rebinds the ground truth to the moved scene
(``cap.checker_fn(env)``) and runs ``checker.update(num_samples,
verify)``, timed from the move to a synchronise after it returns. Every
sweep of the positions (forward, then back) starts from the fitted state
the set-up saved, restored outside the timed request. After each update,
outside the timed request, the program scores a probe: ``probe``
configurations drawn from the seed and the update's own supports
(``collision_score(bias=0)``), and the greedy trainer's own kernel score
(``perceptron.score_original``, its supports and gains) at the rows the
update trained on: those the ground truth labelled in the update (the
ground truth is passed through a recorder that keeps a reference to its
input), less the rows the update held out to verify.

The check (after the window), on up to ``check_updates`` updates drawn
from the seed: the reference labels the update's support configurations
in that update's scene, rebuilds the proxy from them and scores the
probe:
- ``score_gap``: the largest gap between the program's probe scores and
  the reference's (absolute);
- ``train_disagree``: the share of the rows the update trained on where
  the sign of the trainer's kernel score disagrees with the reference's
  label in the moved scene (a converged greedy perceptron separates its
  own training rows, so this judges the trainer's choice of supports and
  gains, which ``score_gap`` follows; the smooth proxy refitted over the
  supports is ``score_gap``'s, and does not separate every training row:
  PERF.md); the largest over the checked updates;
and ``foreign_supports``, the set-up fit's supports that are none of its
samples.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import proxy, scene

READINGS_REQUESTS = 20      # the updates a run checks
CHECKER_STATE = ('safety_bias', 'q_verify', 'labels_verify',
                 'perceptron_trained')


class Kind:
    def __init__(self, system, mix, seeds):
        self.sys, self.mix, self.seeds = system, mix, seeds
        self.device = system.device
        self.checker = system.checker
        self.probe = system.uniform(mix['probe'], seeds['probe'])
        n = mix['positions']
        self.places = [(float(x), mix['y'], mix['z'])
                       for x in np.linspace(mix['x'][0], mix['x'][1], n)]
        self.foreign = system.foreign_supports()
        self.saved = self._state()
        self.snapshots = []
        self.labelled = Labelled(None)
        self.supports_seen = []
        self.counts = {'updates': 0}
        self._update(0)                    # warm-up: an update and the
        self._probe(0)                     # probe (B1's build, if any)
        self._restore()

    def _state(self):
        c = self.checker
        return (dict(c.perceptron.__dict__),
                {k: getattr(c, k) for k in CHECKER_STATE})

    def _restore(self):
        p, c = self.saved
        self.checker.perceptron.__dict__.update(p)
        for k, v in c.items():
            setattr(self.checker, k, v)

    def place(self, i):
        n = len(self.places)
        k = i % n
        return self.places[k if (i // n) % 2 == 0 else n - 1 - k]

    def _update(self, i):
        pose = np.eye(4)
        pose[:3, 3] = self.place(i)
        env = self.sys.env
        env.update_transform(self.mix['obstacle'], pose)
        self.labelled = Labelled(self.sys.cap.checker_fn(env))
        self.checker.gt_check_func = self.labelled
        acc = self.checker.update(num_samples=self.mix['num_samples'],
                                  verify=self.mix['verify'])
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        return acc

    def before(self, i):
        if i > 0 and i % len(self.places) == 0:
            self._restore()

    def request(self, i):
        acc = self._update(i)
        ok = (all(a is not None and math.isfinite(a) for a in acc)
              and math.isfinite(self.checker.safety_bias))
        self.counts['updates'] += 1
        return {'attempted': 1, 'failed': int(not ok)}

    def trained_rows(self):
        """The rows the last update trained on: those it labelled, less
        those it held out to verify."""
        dof = self.probe.shape[1]
        rows = torch.cat([self.probe.new_zeros((0, dof))] + [
            torch.as_tensor(r, device=self.device).reshape(-1, dof).float()
            for r in self.labelled.rows])
        qv = getattr(self.checker, 'q_verify', None)
        if qv is None or rows.shape[0] == 0:
            return rows
        qv = torch.as_tensor(qv, device=self.device).float()
        held = torch.zeros(rows.shape[0], dtype=torch.bool,
                           device=self.device)
        for i in range(0, qv.shape[0], 256):
            held |= (rows[:, None] == qv[None, i:i + 256]).all(-1).any(-1)
        return rows[~held]

    def _probe(self, i):
        sup = self.sys.supports().clone()
        rows = self.trained_rows()
        with torch.no_grad():
            s = self.checker.collision_score(torch.cat([self.probe, sup]),
                                             bias=0.0).reshape(-1)
            h = (self.checker.perceptron.score_original(rows).reshape(-1)
                 if rows.shape[0] else rows.new_zeros(0))
        return self.place(i), sup, s, rows, h

    def after(self, i):
        snap = self._probe(i)
        self.snapshots.append(snap)
        self.supports_seen.append(snap[1].shape[0])
        if self.device.type == 'cuda':   # the probe's work stays out of
            torch.cuda.synchronize()     # the next request's time

    def window_closed(self):
        seen = self.supports_seen
        if seen:
            print(f'supports after the first update {seen[0]}, after the '
                  f'last {seen[-1]}, at most {max(seen)} '
                  f'(set-up fit {self.saved[0]["num_valid"]})',
                  file=__import__('sys').stderr)

    def scene_at(self, place):
        shapes = {k: dict(v) for k, v in self.sys.config['scene'].items()}
        T = np.eye(4)
        T[:3, 3] = place
        shapes[self.mix['obstacle']]['transform'] = T.tolist()
        return shapes

    def chosen(self):
        rng = np.random.default_rng(self.seeds['sample'])
        n = len(self.snapshots)
        return sorted(rng.permutation(n)[:self.mix['check_updates']])

    def gap(self, j, control=False):
        """The probe gap of update j; with ``control`` the reference in
        float32 with TF32 products stands in the program's place."""
        place, sup, s = self.snapshots[j][:3]
        shapes = self.scene_at(place)
        q = torch.cat([self.probe, sup])
        ref = proxy.Proxy(sup, self.sys.config, shapes)
        if control:
            s = proxy.Proxy(sup, self.sys.config, shapes, torch.float32,
                            tf32=True).scores(q)
        return float((s.double() - ref.scores(q)).abs().max())

    def disagree(self, j):
        """The share of update j's training rows where the trainer's sign
        disagrees with the reference's label in that update's scene."""
        place, _, _, rows, h = self.snapshots[j]
        if rows.shape[0] == 0:
            return math.inf
        cfg = self.sys.config
        y = scene.labels(rows.double(), cfg['robot'], cfg['ground_truth'],
                         self.scene_at(place))
        return float(((h > 0) != (y > 0)).double().mean())

    def check(self):
        js = self.chosen()
        return {'score_gap': max([self.gap(j) for j in js],
                                 default=math.inf),
                'train_disagree': max([self.disagree(j) for j in js],
                                      default=math.inf),
                'foreign_supports': float(self.foreign)}

    def control(self):
        """The control's numbers: the reference in float32 with TF32
        products in the program's place."""
        return {'score_gap': max(self.gap(j, control=True)
                                 for j in self.chosen())}


class Labelled:
    """The ground truth passed through, keeping a reference to each input
    it labels (no copy, no launch)."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, q):
        self.rows.append(q)
        return self.fn(q)


# faults planted in the program under the timed path, each by
# ``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``)

def _unchanged(patch):
    """An update that returns without changing the proxy."""
    from diffco_tpu_torch.checkers import RBFDiffCo
    patch(RBFDiffCo, 'update', lambda self, *a, **k: (1.0, 1.0, 1.0))


def _half(patch):
    """The trainer takes half of its rows (every other one besides the
    previous supports) and leaves the rest out."""
    from diffco_tpu_torch.perceptron import DiffCo
    real = DiffCo.train

    def half(self, X, y, update=False, exist_mask=None, distance=None,
             **k):
        keep = torch.arange(X.shape[0], device=X.device) % 2 == 0
        if exist_mask is not None:
            em = np.asarray(exist_mask, bool)
            keep |= torch.as_tensor(em, device=X.device)
            exist_mask = em[keep.cpu().numpy()]
        if distance is not None:
            distance = distance[keep]
        return real(self, X[keep], y[keep], update=update,
                    exist_mask=exist_mask, distance=distance, **k)
    patch(DiffCo, 'train', half)


def _altered(patch):
    """One weight of the fitted proxy altered where it is produced."""
    from diffco_tpu_torch.perceptron import DiffCo
    real = DiffCo.fit_poly

    def altered(self, *a, **k):
        real(self, *a, **k)
        self.rbf_nodes = self.rbf_nodes.clone()
        self.rbf_nodes[0] += 0.1 * self.rbf_nodes.abs().max()
    patch(DiffCo, 'fit_poly', altered)


# the faults an update cell can have (no cell spans chips)
FAULTS = {'unchanged': _unchanged, 'half': _half, 'altered': _altered}
