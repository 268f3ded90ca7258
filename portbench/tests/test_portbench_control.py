"""The control, on the card: the plain reference put in the program's
place and computed one precision below the configuration's (float32 with
TF32 products where the configuration states float32 with TF32 off) must
fail the cell's check. At sizes a test run holds; the readings at the
cells' own sizes come from ``portbench/tools/readings.py`` (PERF.md).

    python -m pytest -m cuda portbench/tests
"""
import pytest
import torch

from portbench.harness import cell, manifest as mf

SMALL = {
    'baxter_dh.plan': {'options': {'N_WAYPOINTS': 20, 'NUM_RE_TRIALS': 8,
                                   'MAXITER': 4, 'max_speed': 2.0,
                                   'dense_sub': 3}},
    'baxter_dh.plan_batch': {'problems_per_request': 8,
                             'options': {'N_WAYPOINTS': 20,
                                         'NUM_RE_TRIALS': 8, 'MAXITER': 4,
                                         'max_speed': 2.0, 'dense_sub': 3}},
    'panda_dh.sweep': {'batch': 65536, 'pools': 2},
    'panda_dh.update': {'check_updates': 3},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(SMALL))
def test_the_control_fails_the_check(card, name):
    _, mix, _, kind = cell.build(name, 20260, card, mix_overrides=SMALL[name])
    requests = 3 if mix['kind'] == 'update' else 1
    cell.Window(kind, requests=requests)
    kind.window_closed()
    limits = mf.limits(name)
    sound, _ = cell.verdict(kind.check(), limits)
    assert sound
    numbers = kind.control()
    assert any(v > limits[k] for k, v in numbers.items()), numbers
