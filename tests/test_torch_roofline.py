"""Port parity: the ablation modes of kernel B7 (``dh_ablation``'s plain
twin) against the JAX package's ``scripts/roofline_fk_score.py`` kernels
(their Pallas bodies run by the Pallas interpreter), and against fp32 math:
float64 numpy on the JAX package's PandaFK points, and its B1 kernel with
fp32 inputs for the full modes. Also the roofline entry point's control
flow on the CPU at a tiny size."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from diffco_tpu.ops import fk_score as jfk
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops import bounds
from diffco_tpu_torch.ops import fk_score as tfk
from diffco_tpu_torch.robots import PandaFK as TPanda
from diffco_tpu_torch.scripts import roofline_fk_score as rf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, TB = 256, 64, 256
# (a) the interpreted TPU kernels take bf16 matrix-unit inputs: max-abs
# error <= 1e-2 x max |ref| (at MIN_DIST from the supports, see inputs).
# (b) fp32 math: rtol 1e-4 for a score-like sum, 1e-3 once dq is in it
# (the ROADMAP's tolerances), atol the same share of max |ref| (a sum
# over S terms can be near zero); mv_bf16_full
# rounds its operands to bf16 by definition, so 1e-2 x max there too.
TOL_TPU = 1e-2
MIN_DIST = 0.25
TOL_FP32 = {'fk_only': 1e-4, 'mxu': 1e-4, 'mxu_rsqrt': 1e-4, 'fwd': 1e-4,
            'mv_f32_full': 1e-3, 'mv_bf16_full': 1e-2}


def load_reference_script(name):
    """A JAX script of ``scripts/`` (no package) as a module."""
    spec = importlib.util.spec_from_file_location(
        f'_reference_{name}', ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(seed=0):
    """q [B, 7] within PandaFK's limits, supports = FK points of random
    configurations [S, 21], weights N(0, 0.05^2), from numpy. The
    configurations keep MIN_DIST from every support: the TPU kernels'
    bf16 distance dot loses ~4e-3 of d2, which near a support moves r and
    1/r by percents."""
    robot = TPanda()
    lims = robot.limits.numpy()
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(S + 4 * B, 7)).astype(np.float32)
    qs = u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
    pts = robot.fkine(torch.from_numpy(qs), flat=True).double()
    near = torch.cdist(pts[S:], pts[:S]).min(1).values.numpy()
    q = qs[S:][near >= MIN_DIST][:B]
    assert q.shape == (B, 7)
    w = (rng.normal(size=(S,)) * 0.05).astype(np.float32)
    return q, pts[:S].float().numpy(), w


@pytest.fixture(scope='module')
def ref():
    return load_reference_script('roofline_fk_score')


@pytest.fixture
def interpret(monkeypatch, ref):
    """Run the scripts' Pallas bodies in the interpreter, padded to this
    test's S (``_ablation_call`` pads with the module's global S)."""
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(ref, 'S', S)
    monkeypatch.setenv('DIFFCO_PALLAS_INTERPRET', '1')


def _jax_points(q):
    """The JAX package's FK points of q, [B, 21] in float64."""
    return np.asarray(JPanda().fkine(jnp.asarray(q)), np.float64).reshape(
        q.shape[0], -1)


def _tpu_kernel(ref, mode, q, sup, w):
    """The interpreted TPU kernel's output (its ``mxu`` is sum_j s_j . x,
    as the port's)."""
    robot = JPanda()
    if mode.startswith('mv_'):
        kern, n_joints, f_pad = ref.make_mv_full(robot, mode == 'mv_f32_full')
    else:
        kernels, n_joints, f_pad = ref.make_ablations(robot)
        kern = kernels[mode]
    out = ref._ablation_call(kern, n_joints, f_pad, TB, jnp.asarray(q),
                             jnp.asarray(sup), jnp.asarray(w))
    return np.asarray(out, np.float64)[0, :B]


def _fp32_math(mode, q, sup, w):
    """The mode's function in float64 on the JAX package's FK points; the
    full modes from its B1 kernel with fp32 inputs (interpreted)."""
    if mode.startswith('mv_'):
        score, dq = jfk._dh_score_grad_pallas(
            jnp.asarray(q), jnp.asarray(sup), jnp.asarray(w),
            jfk.robot_spec(JPanda()), use_bf16=False)
        return np.asarray(score, np.float64) + np.asarray(dq, np.float64)[
            :, ::-1].sum(1)
    x = _jax_points(q)
    s = sup.astype(np.float64)
    if mode == 'fk_only':
        return x.sum(1)
    if mode == 'mxu':
        return x @ s.sum(0)
    d2 = ((x[:, None, :] - s[None]) ** 2).sum(-1) + 1e-12
    r = np.sqrt(d2)
    return (r + 1 / r).sum(1) if mode == 'mxu_rsqrt' else r @ w


def _assert_close(out, want, tol, what):
    scale = np.abs(want).max()
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize('mode', list(rf.MODES))
def test_ablation_twin_matches_tpu_kernel_and_fp32_math(interpret, ref, mode):
    q, sup, w = inputs()
    spec = tfk.robot_spec(TPanda())
    out = rf._dh_ablation_plain(*map(torch.from_numpy, (q, sup, w)), spec,
                                mode).numpy()
    assert out.shape == (B,) and np.isfinite(out).all()
    tpu = _tpu_kernel(ref, mode, q, sup, w)
    err = np.abs(out - tpu).max()
    assert err <= TOL_TPU * np.abs(tpu).max(), (mode, err)
    _assert_close(out, _fp32_math(mode, q, sup, w), TOL_FP32[mode], mode)


def test_wrapper_runs_plain_twin_on_cpu_without_counting():
    q, sup, w = map(torch.from_numpy, inputs(seed=1))
    spec = tfk.robot_spec(TPanda())
    def launches():
        return sum(profiling.counter(f'launches.dh_ablation:{mode}')
                   for mode in rf.MODES)
    before = launches()
    for mode in rf.MODES:
        assert torch.equal(rf.dh_ablation(q, sup, w, spec, mode),
                           rf._dh_ablation_plain(q, sup, w, spec, mode))
    score, dq = rf.dh_score_grad_threads(q, sup, w, spec, 256)
    ref_score, ref_dq = tfk._dh_score_grad_plain(q, sup, w, spec)
    assert torch.equal(score, ref_score) and torch.equal(dq, ref_dq)
    assert launches() == before
    with pytest.raises(ValueError, match='mode'):
        rf.dh_ablation(q, sup, w, spec, 'bwd')


def test_ablation_bounds_extend_b1():
    """The full modes are B1's work plus J adds; the ladder's operation
    counts grow rung by rung."""
    B_, S_, F, J, P = 65536, 512, 21, 7, 7
    b1_ops = bounds.score_ops(B_, S_, F) + B_ * bounds.dh_ops(J, P)
    for mode in ('mv_f32_full', 'mv_bf16_full'):
        nbytes, ops = bounds.ablation_work(mode, B_, S_, F, J, P)
        assert ops == b1_ops + B_ * J
        assert nbytes == 4 * (B_ * J + S_ * F + S_ + B_)
    ops = [bounds.ablation_work(m, B_, S_, F, J, P)[1] for m in rf.LADDER]
    assert ops == sorted(ops)


def test_tc_bounds_of_b6_and_b7():
    """B6 runs B1's function on B1's block: its tensor-core bound is B1's.
    Each B7 rung's tensor-core bound is no greater than its fp32 one, the
    rungs past fk_only are set by their products, and the full f32 rung's
    by the same products as B1."""
    rows = bounds.table()
    assert rows['B6']['bound_tc_ms'] == rows['B1']['bound_tc_ms']
    assert rows['B6']['bound_ms'] == rows['B1']['bound_ms']
    B_, S_, F, J, P = 65536, 512, 21, 7, 7
    for mode in rf.MODES:
        row = rows[f'B7 {mode}']
        assert row['bound_tc_ms'] <= row['bound_ms'], mode
        assert (row['bound_tc_ms'], row['bound_tc_by']) == \
            bounds.ablation_tc_bound(mode, B_, S_, F, J, P)
        if mode != 'fk_only':
            assert row['bound_tc_ms'] == row['bound_tc_times_ms']['tensor']
    assert rows['B7 mv_f32_full']['bound_tc_ms'] == rows['B1']['bound_tc_ms']
    assert rows['B7 mxu']['bound_tc_ms'] < rows['B7 mv_bf16_full'][
        'bound_tc_ms'] < rows['B7 mv_f32_full']['bound_tc_ms']


def test_tc_bound_of_b1():
    """B1's tensor-core bound: the two products in 3xTF32 over the TF32
    peak set it at PandaFK's shape, below the fp32 bound that assumes no
    tensor cores, and it is reported as 'operations'."""
    B_, S_, F, J, P = 65536, 512, 21, 7, 7
    assert bounds.tc_product_ops(B_, S_, F) == 3 * B_ * S_ * (4 * F + 2)
    times = bounds.dh_tc_times(B_, S_, F, J, P)
    ms, by = bounds.dh_tc_bound(B_, S_, F, J, P)
    assert ms == times['tensor'] > times['fp32'] > times['bytes']
    assert by == 'operations'
    fp32_ms, _ = bounds.bound(bounds.fk_score_bytes(B_, S_, F, J),
                              bounds.score_ops(B_, S_, F)
                              + B_ * bounds.dh_ops(J, P))
    assert ms < fp32_ms


@pytest.mark.parametrize('kernel,ms', [('B2', 0.0175), ('B3', 0.0199)])
def test_tc_bounds_of_b2_and_b3(kernel, ms):
    """B2's and B3's tensor-core bounds (``bounds.tc_bound``, which B1's
    shares): at the main paths' shapes (PandaFK's points, F = 21;
    FrankaPanda's chain, F = 24; B = 65536, S = 512) the two products in
    3xTF32 over the TF32 peak set them, below their fp32 bounds, and
    ``bounds.table()`` gives both."""
    row = bounds.table()[kernel]
    B_, S_, F = row['shape']['B'], row['shape']['S'], row['shape']['F']
    times = row['bound_tc_times_ms']
    assert row['bound_tc_ms'] == times['tensor'] > times['fp32'] > \
        times['bytes']
    assert times['tensor'] == bounds.tc_product_ops(B_, S_, F) \
        / bounds.PEAK_TF32_FLOPS * 1e3
    assert row['bound_tc_by'] == 'operations'
    assert abs(row['bound_tc_ms'] - ms) < 1e-4
    assert row['bound_tc_ms'] < row['bound_ms']
    assert bounds.poly_tc_bound(B_, S_, 21)[0] == bounds.dh_tc_bound(
        B_, S_, 21, 7, 7)[0]


@pytest.mark.parametrize('kernel', ['B2 wide', 'B3 wide'])
def test_wide_f64_tc_bounds_of_b2_and_b3(kernel):
    """The wide instances' fp64 tensor-core bound (``bounds.
    wide_f64_tc_bound``) at the 35-link rope's sweep (B = 65536, S = 1536,
    F = 102): the two products over the fp64 tensor cores' 67 TFLOP/s set
    it, 2 B S (2F + 1) operations (~0.616 ms), above the pair work in fp64,
    the FK in fp32 and the bytes; ``bounds.table()`` gives it beside the
    3xTF32 route's ``tc_bound``, which it exceeds."""
    row = bounds.table()[kernel]
    B_, S_, F = row['shape']['B'], row['shape']['S'], row['shape']['F']
    assert (B_, S_, F) == (65536, 1536, 102)
    times = row['bound_f64_tc_times_ms']
    assert row['bound_f64_tc_ms'] == times['tensor'] == \
        2 * B_ * S_ * (2 * F + 1) / bounds.PEAK_FP64_TC_FLOPS * 1e3
    assert times['tensor'] > times['fp64'] > max(times['fp32'],
                                                 times['bytes'])
    assert row['bound_f64_tc_by'] == 'operations'
    assert abs(row['bound_f64_tc_ms'] - 0.616) < 1e-3
    assert row['bound_f64_tc_ms'] > row['bound_tc_ms']
    assert bounds.PEAK_FP64_TC_FLOPS > bounds.PEAK_FP64_FLOPS


def test_roofline_entry_point_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(rf, 'N_SHORT', 1)
    monkeypatch.setattr(rf, 'N_LONG', 2)
    monkeypatch.setattr(rf, 'REPS', 1)
    res = rf.run('cpu', batch=64, supports=16)
    for key in ('bench_step_ms', 'full_kernel_ms', 'fk_only_ms', 'mxu_ms',
                'mxu_rsqrt_ms', 'fwd_ms', 'mv_bf16_full_ms', 'mv_f32_full_ms',
                'tile_sweep_full_ms', 'f_pad', 'evals_per_sec_full',
                'implied_tflops_full', 'ladder', 'raw_ms'):
        assert key in res, key
    assert res['f_pad'] == 24 and res['device'] == 'cpu'
    assert res['device_ms'] is None   # a card's measurement only
    assert set(res['tile_sweep_full_ms']) == {'64', '128', '256', '512'}
    assert list(res['ladder']) == list(rf.LADDER)
    raw = res['raw_ms']['full_kernel']
    assert raw['short_ms'] > 0 and raw['long_ms'] > 0
    rf.main(['--device', 'cpu', '--batch', '32', '--supports', '8',
             '--out', str(tmp_path / 'r.json')])
    assert (tmp_path / 'r.json').exists()
