"""The check sees a broken timed path: each cell runs on the CPU at tiny
sizes (past the harness's look for a card) with one fault planted in the
program underneath, and ``correct`` comes out false. The faults a cell
can have: a step that returns its state unchanged, half of the batch left
out (the mean taken over the rest), an answer altered where it is
produced (``FAULTS`` in each ``kinds/<kind>.py``). No cell spans chips,
so none has an exchange to leave out. The sweep keeps no state between
calls, so no step of it can return its state unchanged."""
import pytest

from portbench.harness import cell, manifest as mf
from portbench.tests import tiny


def _kind(name):
    return mf.kind(mf.mix(mf.workload(mf.load(), name)['traffic'])['kind'])


FAULTS = [(name, fault) for name in tiny.MIXES
          for fault in _kind(name).FAULTS]


@pytest.mark.parametrize('name,fault', FAULTS,
                         ids=[f'{n}-{f}' for n, f in FAULTS])
def test_a_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    _kind(name).FAULTS[fault](monkeypatch.setattr)
    out = tiny.run(cell, name, requests=3)
    assert out['correct'] is False, out['checks']


@pytest.mark.parametrize('name', list(tiny.MIXES))
def test_the_same_run_without_a_fault_is_correct(name):
    out = tiny.run(cell, name, requests=3)
    assert out['correct'] is True, out['checks']
