"""Batched score and gradient queries on a serial chain given by its joint
table (``robot.chain``): the ``sweep`` kind's requests, counts, check,
control and faults, with the chain reference (``reference/chain.py``) in
place of the DH one.

Besides, each request reads the program's counter of wide-instance
launches (``ops.wide_launches``, through ``profiling.counter``) before
and after it, into ``counts['wide_launches']``; a program without the
counter leaves that count out. ``work`` gives the call's shapes and the
chain's FK work a configuration (``harness/chain_work.py``), and
``read_only`` the fit's support count, which ``tools/readings.py``
prints beside the checked numbers (the support buffer is set from it).
"""
from __future__ import annotations

import torch

from portbench.harness import chain_work
from portbench.kinds import sweep
from portbench.reference import chain

READINGS_REQUESTS = sweep.READINGS_REQUESTS
FAULTS = sweep.FAULTS


class Kind(sweep.Kind):
    def __init__(self, system, mix, seeds):
        from diffco_tpu_torch import profiling
        self._counter = getattr(profiling, 'counter', None)
        super().__init__(system, mix, seeds)
        if self._counter is not None:
            self.counts['wide_launches'] = 0
        robot = system.config['robot']
        self.work = {'B': mix['batch'], 'S': self.work['S'],
                     'F': 3 * len(robot['points']), 'D': robot['dof'],
                     'fk_ops': chain_work.chain_ops(robot)}
        self.read_only = {'supports': float(self.work['S'])}

    def request(self, i):
        if self._counter is None:
            return super().request(i)
        before = self._counter('ops.wide_launches')
        rec = super().request(i)
        self.counts['wide_launches'] += (self._counter('ops.wide_launches')
                                         - before)
        return rec

    def reference(self, dtype=torch.float64, tf32=False):
        return chain.Proxy(self.sys.supports(), self.sys.config,
                           self.sys.config['scene'], dtype, tf32)
