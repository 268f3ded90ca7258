"""Port parity: kernel B6 (``dh_dual_score_grad``, whose plain twin is
B1's) against the JAX package's ``scripts/ab_dual_tile.py`` kernel (its
Pallas body run by the Pallas interpreter, both orders of the two halves)
and against its B1 kernel with fp32 inputs. Also the A/B entry point's
control flow on the CPU at a tiny size."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from diffco_tpu.ops import fk_score as jfk
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.robots import PandaFK as TPanda
from diffco_tpu_torch.scripts import ab_dual_tile as ab
from test_torch_roofline import B, TOL_TPU, inputs, load_reference_script

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def ref():
    return load_reference_script('ab_dual_tile')


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv('DIFFCO_PALLAS_INTERPRET', '1')


def _twin(q, sup, w):
    return [t.numpy() for t in ab.dh_dual_score_grad(
        *map(torch.from_numpy, (q, sup, w)), tfk.robot_spec(TPanda()))]


# the TPU kernel's dq sums bf16(s w) bf16(1/r) products (2^-8 rounding
# each): against fp32 math it came to 0.56-1.07e-2 of max |dq| over five
# input seeds, so dq is held at twice the score's 1e-2
TOL_TPU_DQ = 2 * TOL_TPU


@pytest.mark.parametrize('pipelined', [False, True])
def test_dual_twin_matches_tpu_kernel(interpret, ref, pipelined):
    """(a) The interpreted TPU kernel (tb = 256: one tile of two 128-lane
    halves) takes bf16 matrix-unit inputs: max-abs error <= 1e-2 x max
    |ref| for the score, 2e-2 x max |ref| for dq."""
    q, sup, w = inputs()
    score, dq = _twin(q, sup, w)
    r_score, r_dq = ref.dual_score_grad(
        jnp.asarray(q), jnp.asarray(sup), jnp.asarray(w),
        jfk.robot_spec(JPanda()), tb=256, pipelined=pipelined)
    assert score.shape == (B,) and dq.shape == (B, 7)
    for out, want, tol in ((score, np.asarray(r_score), TOL_TPU),
                           (dq, np.asarray(r_dq), TOL_TPU_DQ)):
        assert np.abs(out - want).max() <= tol * np.abs(want).max()


def test_dual_twin_matches_fp32_kernel(interpret):
    """(b) B1's Pallas kernel with fp32 inputs: rtol 1e-4 for the score,
    1e-3 for dq (the ROADMAP's tolerances)."""
    q, sup, w = inputs()
    score, dq = _twin(q, sup, w)
    r_score, r_dq = jfk._dh_score_grad_pallas(
        jnp.asarray(q), jnp.asarray(sup), jnp.asarray(w),
        jfk.robot_spec(JPanda()), use_bf16=False)
    np.testing.assert_allclose(score, np.asarray(r_score), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dq, np.asarray(r_dq), rtol=1e-3, atol=1e-3)


def test_wrapper_runs_plain_twin_on_cpu_without_counting():
    q, sup, w = map(torch.from_numpy, inputs(seed=2))
    spec = tfk.robot_spec(TPanda())
    want = tfk._dh_score_grad_plain(q, sup, w, spec)
    def launches():
        return sum(profiling.counter(f'launches.dh_dual_score_grad:{v}')
                   for v in ab.VARIANTS)
    before = launches()
    for variant in ab.VARIANTS:
        score, dq = ab.dh_dual_score_grad(q, sup, w, spec, variant)
        assert torch.equal(score, want[0]) and torch.equal(dq, want[1])
    assert launches() == before
    with pytest.raises(ValueError, match='variant'):
        ab.dh_dual_score_grad(q, sup, w, spec, variant='dual_pipe_128')


def test_dual_tile_entry_point_on_cpu(tmp_path, monkeypatch):
    from diffco_tpu_torch.scripts import roofline_fk_score as rf
    monkeypatch.setattr(rf, 'N_SHORT', 1)
    monkeypatch.setattr(rf, 'N_LONG', 2)
    monkeypatch.setattr(rf, 'REPS', 1)
    res = ab.run('cpu', batch=64, supports=16)
    assert set(res['variants']) == set(ab.VARIANTS)
    for v in res['variants'].values():
        assert v['max_abs_score_err_vs_prod'] == 0.0
        assert v['raw_ms']['long_ms'] > 0
    ab.main(['--device', 'cpu', '--batch', '32', '--supports', '8',
             '--out', str(tmp_path / 'd.json')])
    assert (tmp_path / 'd.json').exists()
